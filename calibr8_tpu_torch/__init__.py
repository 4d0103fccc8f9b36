"""calibr8_tpu_torch — the PyTorch/CUDA port of calibr8_tpu.

An implicit quasi-static finite-element solver for solid mechanics
(mixed u/p with GLS pressure stabilization, elastoplastic local models)
whose hot loops run as hand-written CUDA kernels on an NVIDIA Hopper
card (`csrc/`, built at first use by `kernels.py`).  Every kernel keeps
a plain PyTorch version of the same function beside it: that version is
the CPU implementation and the oracle the kernel is checked against.

The package imports neither JAX nor the calibr8_tpu package; module
names follow calibr8_tpu's so that each module's counterpart is easy to
find.  Entry points run on the card unless the caller passes
`device="cpu"`.  Precision defaults to float64 (the reference is
double precision throughout); the kernels also run in float32.
"""

__version__ = "0.1.0"

from calibr8_tpu_torch.deck import ProblemSpec, load_deck  # noqa: E402,F401
