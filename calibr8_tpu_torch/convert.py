"""Carry calibr8_tpu's parameters and state across to the port.

Both packages order elements by element set the same way
(calibr8_tpu fem/disc.py:35, calibr8_tpu_torch fem/disc.py), order
dofs u block then p block, and order parameters as the model's
param_names, so the numpy arrays of one package are valid state of the
other unchanged; this module only checks their shapes and moves them.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(params_all, x=None, xi=None, *, device, dtype=torch.float64):
    """(params0 (n_sets, n_params), x (n_dofs,) or None, xi (n_elem, nxi)
    or None) as tensors on `device`.  Arrays are copied."""
    p = np.asarray(params_all)
    if p.ndim != 2:
        raise ValueError(f"params_all must be (n_sets, n_params), got shape {p.shape}")
    out = [torch.tensor(p, dtype=dtype, device=device)]
    if x is not None:
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError(f"x must be flat (n_dofs,), got shape {x.shape}")
        out.append(torch.tensor(x, dtype=dtype, device=device))
    else:
        out.append(None)
    if xi is not None:
        xi = np.asarray(xi)
        if xi.ndim != 2:
            raise ValueError(f"xi must be (n_elem, nxi), got shape {xi.shape}")
        out.append(torch.tensor(xi, dtype=dtype, device=device))
    else:
        out.append(None)
    return tuple(out)
