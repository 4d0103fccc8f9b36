"""Carry calibr8_tpu's parameters and state across to the port.

Both packages order elements by element set the same way
(calibr8_tpu fem/disc.py:35, calibr8_tpu_torch fem/disc.py), order
dofs u block then p block, and order parameters as the model's
param_names, so the numpy arrays of one package are valid state of the
other unchanged; this module only checks their shapes and moves them.
trajectory_from_numpy carries a whole primal trajectory across, so the
port's adjoint sweep can run on calibr8_tpu's primal solution.
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


def trajectory_from_numpy(x, xi, path, qoi_values=None, *, device, dtype=torch.float64):
    """A primal Trajectory of the port from per-step arrays (index 0 = the
    initial state), e.g. the fields x, xi, path, qoi_values of
    calibr8_tpu's Trajectory: x[k] (n_dofs,), xi[k] (n_elem, nxi),
    path[k] (n_elem,).  Arrays are copied; path becomes int32."""
    from calibr8_tpu_torch.solve.primal import Trajectory

    if not len(x) == len(xi) == len(path):
        raise ValueError(f"x, xi, path have {len(x)}, {len(xi)}, {len(path)} steps")
    xs, xis, paths = [], [], []
    for k in range(len(x)):
        _, xk, xik = state_from_numpy(np.zeros((1, 1)), x[k], xi[k], device=device, dtype=dtype)
        pk = np.asarray(path[k])
        if pk.ndim != 1 or pk.shape[0] != xik.shape[0]:
            raise ValueError(f"path[{k}] has shape {pk.shape}, want ({xik.shape[0]},)")
        xs.append(xk)
        xis.append(xik)
        paths.append(torch.tensor(pk, dtype=torch.int32, device=device))
    vals = [float(v) for v in qoi_values] if qoi_values is not None else [0.0] * (len(x) - 1)
    return Trajectory(x=xs, xi=xis, path=paths, qoi_values=vals)
