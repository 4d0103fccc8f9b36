"""Trailing-layout (element axis last) constitutive twins, in PyTorch.

The counterparts of calibr8_tpu's hand-batched twins (models/batched.py
there): every array is (..., E) with the element axis last, small tensor
algebra is written out over the leading axes.  They form the body of the
fused assembly's plain version (fem/fused_assembly.py), and the CUDA
kernel's model bodies (csrc/c8_element.cuh) follow them line by line, so
the two agree to rounding.

Each twin takes grad_u (d, d, E) directly (calibr8_tpu passes a
Kinematics whose grad_u_prev these two models never read).  Tangent
rules follow JAX's, which the plain version reproduces under
torch.func.jvp: torch.where takes the tangent of the selected branch,
torch.maximum splits the tangent evenly at a tie, and t_norm adds 1e-30
under the square root.
"""

from __future__ import annotations

import numpy as np
import torch

SQRT_23 = float(np.sqrt(2.0 / 3.0))
SQRT_32 = float(np.sqrt(3.0 / 2.0))


def usum(x, dim: int):
    """Sum over a small axis in index order (the order calibr8_tpu's
    unrolled sums and the CUDA kernel use)."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def t_voigt_to_sym(v, d: int):
    """(nc, E) -> (d, d, E)."""
    if d == 2:
        return torch.stack(
            [torch.stack([v[0], v[2]]), torch.stack([v[2], v[1]])]
        )
    return torch.stack(
        [
            torch.stack([v[0], v[3], v[4]]),
            torch.stack([v[3], v[1], v[5]]),
            torch.stack([v[4], v[5], v[2]]),
        ]
    )


def t_sym_to_voigt(a, d: int):
    if d == 2:
        return torch.stack([a[0, 0], a[1, 1], a[0, 1]])
    return torch.stack([a[0, 0], a[1, 1], a[2, 2], a[0, 1], a[0, 2], a[1, 2]])


def t_trace(a):
    t = a[0, 0]
    for i in range(1, a.shape[0]):
        t = t + a[i, i]
    return t


def t_sub_diag(a, s):
    """a - s*I on (d, d, E)."""
    d = a.shape[0]
    return torch.stack(
        [torch.stack([a[i, j] - s if i == j else a[i, j] for j in range(d)]) for i in range(d)]
    )


def t_dev3(a):
    """Deviator with the 3D trace factor in any dimension (the
    reference's small-strain models divide the trace by 3 in 2D too)."""
    return t_sub_diag(a, t_trace(a) / 3.0)


def t_norm(a, eps=1e-30):
    return torch.sqrt(usum(usum(a * a, 0), 0) + eps)


def t_sym(a):
    return 0.5 * (a + a.transpose(0, 1))


class BatchedSmallJ2:
    """Twin of SmallJ2: xi (nc+1, E) = [pstrain voigt, alpha]; params
    (6, E) = [E, nu, K, Y, cte, delta_T]."""

    name = "small_J2"

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nc = 3 if self.dim == 2 else 6
        self.nxi = model.nxi()
        self.abs_tol = model.abs_tol

    def _mu(self, parT):
        return parT[0] / (2.0 * (1.0 + parT[1]))

    def dev_cauchy(self, xiT, gu, parT):
        mu = self._mu(parT)
        ps = t_voigt_to_sym(xiT[: self.nc], self.dim)
        return 2.0 * mu * (t_dev3(t_sym(gu)) - ps)

    def local_solve(self, xipT, gu, parT):
        """Closed-form radial return (the same root the reference's local
        Newton finds, small_J2.cpp:186-246).  Returns (xiT, path (E,)
        int32, failed (E,) int32)."""
        mu = self._mu(parT)
        K, Y = parT[2], parT[3]
        ps_prev = t_voigt_to_sym(xipT[: self.nc], self.dim)
        alpha_prev = xipT[self.nc]
        s_tr = 2.0 * mu * (t_dev3(t_sym(gu)) - ps_prev)
        s_mag = t_norm(s_tr)
        f_tr = (s_mag - SQRT_23 * (Y + K * alpha_prev)) / mu
        plastic = f_tr >= -self.abs_tol
        zero = torch.zeros_like(f_tr)
        dgam = torch.maximum(f_tr, zero) * mu / (2.0 * mu + (2.0 / 3.0) * K)
        n_tr = s_tr / s_mag
        ps = ps_prev + torch.where(plastic, dgam, zero) * n_tr
        alpha = alpha_prev + torch.where(plastic, SQRT_23 * dgam, zero)
        xiT = torch.cat([t_sym_to_voigt(ps, self.dim), alpha[None, :]], dim=0)
        path = plastic.to(torch.int32)
        return xiT, path, torch.zeros_like(path)

    def cauchy(self, xiT, gu, parT, pT):
        """sigma = dev_cauchy - p I, (d, d, E)."""
        return t_sub_diag(self.dev_cauchy(xiT, gu, parT), pT)

    def hydro_cauchy(self, xiT, gu, parT):
        Em, nu, cte, dT = parT[0], parT[1], parT[4], parT[5]
        kappa = Em / (3.0 * (1.0 - 2.0 * nu))
        thermal = cte * dT * Em / (1.0 - 2.0 * nu)
        return kappa * t_trace(t_sym(gu)) - thermal

    def pressure_scale_factor(self, parT):
        return parT[0] / (3.0 * (1.0 - 2.0 * parT[1]))


class BatchedElastic:
    """Twin of Elastic: the local 'solve' is the dummy xi = 0; params
    (4, E) = [E, nu, cte, delta_T]."""

    name = "elastic"

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nxi = 1
        self.abs_tol = model.abs_tol

    def _mu(self, parT):
        return parT[0] / (2.0 * (1.0 + parT[1]))

    def local_solve(self, xipT, gu, parT):
        path = torch.zeros(xipT.shape[-1], dtype=torch.int32, device=xipT.device)
        return torch.zeros_like(xipT), path, torch.zeros_like(path)

    def dev_cauchy(self, xiT, gu, parT):
        return 2.0 * self._mu(parT) * t_dev3(t_sym(gu))

    def cauchy(self, xiT, gu, parT, pT):
        return t_sub_diag(self.dev_cauchy(xiT, gu, parT), pT)

    def hydro_cauchy(self, xiT, gu, parT):
        Em, nu, cte, dT = parT[0], parT[1], parT[2], parT[3]
        kappa = Em / (3.0 * (1.0 - 2.0 * nu))
        thermal = cte * dT * Em / (1.0 - 2.0 * nu)
        return kappa * t_trace(t_sym(gu)) - thermal

    def pressure_scale_factor(self, parT):
        return parT[0] / (3.0 * (1.0 - 2.0 * parT[1]))


BATCHED_MODELS = {"small_J2": BatchedSmallJ2, "elastic": BatchedElastic}

# the CUDA kernel's model index (csrc/fused_assembly.cu c8_fused_assembly)
KERNEL_MODEL_ID = {"elastic": 0, "small_J2": 1}


def get_batched_model(model):
    return BATCHED_MODELS[model.name](model)
