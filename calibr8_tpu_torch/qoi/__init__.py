"""QoI registry (reference create_qoi, qoi.cpp:261-289); registry strings
match the reference deck vocabulary.  The port has `average
displacement`, `calibration` and `reaction mismatch`; the other QoIs
raise NotImplementedError."""

from __future__ import annotations

from calibr8_tpu_torch.qoi.avg_disp import AvgDisp
from calibr8_tpu_torch.qoi.calibration import Calibration, ReactionMismatch

_REGISTRY = {
    "average displacement": AvgDisp,
    "calibration": Calibration,
    "reaction mismatch": ReactionMismatch,
}

# calibr8_tpu's other QoIs of qoi/calibration.py:242-320 (ROADMAP.md queue 1)
_LATER = {"reaction": "I/O and tools", "surface mismatch": "I/O and tools",
          "point displacement": "I/O and tools"}


def create_qoi(name: str, disc, config=None):
    if name in _LATER:
        raise NotImplementedError(
            f"QoI type {name!r} is not ported yet: ROADMAP.md queue 1, {_LATER[name]!r}")
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"QoI type {name!r} is not ported yet (the port has {sorted(_REGISTRY)})"
        )
    return _REGISTRY[name](disc, config)
