"""Parameter transforms: value / log / bounds scalings.

The port's own copy of calibr8_tpu's opt/transforms.py (numpy only).
Mirrors the reference Python driver layer's three scalings
(reference: source/calibr8/python/calibr8/util/parameter_transforms.py:4-66):

  scale = None        -> value (identity; unbounded in the optimizer)
  scale = float r     -> log:    canonical x = log(p / r), p = r exp(x)
                         (stiffness-like parameters spanning decades)
  scale = (lo, hi)    -> bounds: canonical x in [-1, 1]

`first_deriv` is dp/dx, the chain-rule factor applied to gradients
(parameter_transforms.py first_deriv_transform / grad_transform).
"""

from __future__ import annotations

import numpy as np


def is_log(scale) -> bool:
    return isinstance(scale, (int, float)) and not isinstance(scale, bool)


def to_canonical(p, scale):
    if scale is None:
        return float(p)
    if is_log(scale):
        return float(np.log(p / scale))
    lo, hi = float(scale[0]), float(scale[1])
    span, mean = 0.5 * (hi - lo), 0.5 * (hi + lo)
    return float((np.clip(p, lo, hi) - mean) / span)


def from_canonical(x, scale):
    if scale is None:
        return float(x)
    if is_log(scale):
        return float(scale * np.exp(x))
    lo, hi = float(scale[0]), float(scale[1])
    return float(0.5 * (hi - lo) * x + 0.5 * (hi + lo))


def first_deriv(p, scale):
    """dp/dx at parameter value p (parameter_transforms.py:44-50)."""
    if scale is None:
        return 1.0
    if is_log(scale):
        return float(p)
    return 0.5 * (float(scale[1]) - float(scale[0]))


def transform_parameters(values, scales, from_canonical_flag):
    fn = from_canonical if from_canonical_flag else to_canonical
    return np.asarray([fn(v, s) for v, s in zip(values, scales)])


def grad_transform(grad, values, scales):
    return np.asarray(
        [g * first_deriv(p, s) for g, p, s in zip(grad, values, scales)]
    )
