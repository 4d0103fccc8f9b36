"""The 'mechanics' global residual: its configuration and element form.

Quasi-static balance of linear momentum, mixed u/p with GLS-type
pressure stabilization (reference: source/calibr8/src/mechanics.cpp),
or displacement only: 'mechanics_plane_stress'
(mechanics_plane_stress.cpp) weights the momentum rows by a thickness,
and 'mixed formulation: false' drops the pressure.

The primal's element residual and condensed Jacobian come from the fused
assembly (fem/fused_assembly.py: the CUDA kernels and their plain
version).  make_elem_rows here is the element residual of calibr8_tpu's
mechanics/global_residual.py:109-196 in plain PyTorch, differentiable in
every argument, parameters included (mu, psf and tau are traced): the
plain assembly seeds it over grad_u, and the adjoint blocks
(fem/adjoint_blocks.py) differentiate make_elem_residual, its form over
element dofs, over everything.

Element DOF packing: x_e = [u (npe*d), p (npe)] node-interleaved, i.e.
x_e.reshape(npe, ndpn) with columns [u_0..u_{d-1}, p]; [u] alone when
the residual is displacement only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from calibr8_tpu_torch.fem import basis
from calibr8_tpu_torch.models.batched import t_cof, t_det, t_F, t_mm, t_transpose, usum

PARENT_MEASURE = {2: 0.5, 3: 1.0 / 6.0}


@dataclass(frozen=True)
class MechanicsSpec:
    """Static configuration of the mechanics residual."""

    dim: int
    mixed: bool = True
    stab_multiplier: float = 1.0
    # 'mechanics_plane_stress': displacement only, thickness-weighted
    plane_stress: bool = False
    thickness: float = 1.0

    @property
    def npe(self) -> int:
        return self.dim + 1

    @property
    def ndofs_per_node(self) -> int:
        return self.dim + (1 if self.mixed else 0)

    @property
    def ndofs_elem(self) -> int:
        return self.npe * self.ndofs_per_node

    def unpack(self, x_e):
        """Split element dofs (..., nde) into (u_e (..., npe, d),
        p_e (..., npe) or None)."""
        xm = x_e.reshape(*x_e.shape[:-1], self.npe, self.ndofs_per_node)
        u = xm[..., : self.dim]
        p = xm[..., self.dim] if self.mixed else None
        return u, p


def quadrature_tables(d: int):
    """(N1 (npts, npe), w1 (npts,), mass (npe, npe)) of the order-2
    pressure rule, as Python floats: mass[n][m] = sum_q w1 N1[q][n]
    N1[q][m], summed as calibr8_tpu sums it (pallas_assembly.py:226-232)."""
    pts, w = basis.quadrature(d, 2)
    N1 = basis.shape_values(d, pts)
    npe = d + 1
    N1v = [[float(N1[q, n]) for n in range(npe)] for q in range(N1.shape[0])]
    w1v = [float(x) for x in np.asarray(w).ravel()]
    mass = [
        [sum(w1v[q] * N1v[q][n] * N1v[q][m] for q in range(len(w1v))) for m in range(npe)]
        for n in range(npe)
    ]
    return N1v, w1v, mass


def elem_kinematics(spec: MechanicsSpec, x_eT, gNT):
    """grad_u[i, j] = sum_n u[n, i] dN_n/dx_j, (d, d, E), from element
    dofs x_eT (nde, E) and gN_T (npe, d, E)."""
    d = spec.dim
    u = x_eT.reshape(spec.npe, spec.ndofs_per_node, -1)[:, :d]
    return torch.stack(
        [torch.stack([usum(u[:, i] * gNT[:, j], 0) for j in range(d)]) for i in range(d)]
    )


def stab_tau(spec: MechanicsSpec, parT, h):
    """The GLS stabilization parameter tau = c h^2 / (2 mu), (E,)."""
    mu = parT[0] / (2.0 * (1.0 + parT[1]))
    return spec.stab_multiplier * 0.5 * h * h / mu


def make_elem_rows(bmodel, spec: MechanicsSpec):
    """The element residual rows(xiT, gu, p_e, geom, parT) -> R_T
    (nde, E) at grad_u gu (d, d, E) and nodal pressures p_e (npe, E)
    (None when displacement only), geom = (gN_T (npe, d, E), detJ (E,),
    h (E,)), parT (n_params, E), for the trailing twin `bmodel`
    (calibr8_tpu mechanics/global_residual.py:130-194, element axis
    last).  The one Python form of the residual: the primal's plain
    assembly seeds it over gu, the adjoint blocks over every argument.

    For a twin with finite_deformation the momentum rows hold the first
    Piola-Kirchhoff stress J sigma F^-T = sigma cof(F), times the
    z-stretch xi[z_stretch_idx] when displacement only (plane stress,
    mechanics_plane_stress.cpp:66-84), and the stabilization pulls grad_p
    back: (tau / det F) cof(F)^T cof(F) grad_p (global_residual.py:
    144-185 there)."""
    d, npe = spec.dim, spec.npe
    meas0 = PARENT_MEASURE[d]
    N1, w1, _ = quadrature_tables(d)
    nq = len(w1)

    def rows(xiT, gu, p_e, geom, parT):
        gNT, detJ, h = geom
        wdv0 = detJ * meas0
        p_ip = usum(p_e, 0) * (1.0 / npe) if spec.mixed else torch.zeros_like(detJ)
        sigma = bmodel.cauchy(xiT, gu, parT, p_ip)
        finite = bmodel.finite_deformation
        if finite:
            F = t_F(gu)
            cof = t_cof(F)
            sigma = t_mm(sigma, cof)
            if not spec.mixed:
                sigma = xiT[bmodel.z_stretch_idx] * sigma
        # momentum: R_u[n, i] = sigma[i, j] grad_N[n, j] wdv
        R_u = [[usum(sigma[i] * gNT[n], 0) * wdv0 for i in range(d)] for n in range(npe)]
        if not spec.mixed:
            if spec.plane_stress:
                R_u = [[r * spec.thickness for r in row] for row in R_u]
            return torch.stack([r for row in R_u for r in row])

        psf = bmodel.pressure_scale_factor(parT)
        hydro = bmodel.hydro_cauchy(xiT, gu, parT)
        tau = stab_tau(spec, parT, h)
        grad_p = [usum(p_e * gNT[:, j], 0) for j in range(d)]
        if finite:
            M = t_mm(t_transpose(cof), cof)
            sc = tau / t_det(F)
            stab_gp = [sc * usum(torch.stack([M[j, k] * grad_p[k] for k in range(d)]), 0)
                       for j in range(d)]
        else:
            stab_gp = [tau * grad_p[j] for j in range(d)]
        p_q = [usum(torch.stack([N1[q][n] * p_e[n] for n in range(npe)]), 0) for q in range(nq)]
        out = []
        for n in range(npe):
            out += R_u[n]
            # pressure, ip set 0: constant part + stabilization
            r = -(hydro / psf) * (1.0 / npe) * wdv0
            r = r - usum(torch.stack([gNT[n, j] * stab_gp[j] for j in range(d)]), 0) * wdv0
            # ip set 1 (order 2): -(p / psf) N_n w dv
            r = r - usum(
                torch.stack([((p_q[q] / psf) * (w1[q] * detJ)) * N1[q][n] for q in range(nq)]), 0
            )
            out.append(r)
        return torch.stack(out)

    return rows


def make_elem_residual(bmodel, spec: MechanicsSpec):
    """The element residual f(x_eT, xp_eT, xiT, geom, parT) -> R_T
    (nde, E) of element dofs x_eT (nde, E): make_elem_rows at their
    grad_u and nodal pressures.  The rows read no x_prev: the twins'
    stress measures depend on grad_u and xi alone (x_prev enters through
    the local residual C)."""
    rows = make_elem_rows(bmodel, spec)

    def f(x_eT, xp_eT, xiT, geom, parT):
        p_e = x_eT.reshape(spec.npe, spec.ndofs_per_node, -1)[:, spec.dim] if spec.mixed else None
        return rows(xiT, elem_kinematics(spec, x_eT, geom[0]), p_e, geom, parT)

    return f
