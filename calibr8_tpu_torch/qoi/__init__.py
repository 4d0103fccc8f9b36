"""QoI registry (reference create_qoi, qoi.cpp:261-289); registry strings
match the reference deck vocabulary.  The port has `average
displacement`; the other QoIs raise NotImplementedError."""

from __future__ import annotations

from calibr8_tpu_torch.qoi.avg_disp import AvgDisp

_REGISTRY = {"average displacement": AvgDisp}


def create_qoi(name: str, disc, config=None):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"QoI type {name!r} is not ported yet (this slice has {sorted(_REGISTRY)})"
        )
    return _REGISTRY[name](disc, config)
