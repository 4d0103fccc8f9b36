"""Fused element assembly: the CUDA kernel, its plain version, and the
assembler that scatters their results.

The counterpart of calibr8_tpu's fem/pallas_assembly.py in its analytic
mode (make_pallas_assemble, pallas_call at :496).  Per element: the
grad_u kinematics, the closed-form local solve of the model twin, the
mixed u/p residual rows with GLS stabilization, and the statically
condensed element Jacobian.  Because the local solve is closed form,
xi*(grad_u) is differentiable and the d*d grad_u tangents of the
residual rows ARE the condensed Jacobian dR/dx - dR/dxi (dC/dxi)^-1
dC/dx (reference evaluations.cpp:112); the pressure columns are added
analytically (fem/pallas_assembly.py:423-476).

  fused_assembly(...)        the wrapper: the kernel (csrc/fused_assembly.cu)
                             on CUDA tensors, the plain version on CPU ones
  fused_assembly_plain(...)  the same function in PyTorch, tangents from
                             torch.func.jvp over the d*d unit seeds (the
                             counterpart of jax.linearize)
  FusedAssembler             R, J, diag, xi, path, nfail for the Newton loop

Outputs keep calibr8_tpu's trailing layout: R_T (nde, E), J_T
(nde, nde, E), xi_T (nxi, E), path and fail (E,) int32, so they compare
directly with make_pallas_assemble's.  Only mixed u/p specs reach this
module (problem.py rejects the others).  The two models of this slice
never read grad_u_prev, so the kernel takes no x_prev.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.fem import basis
from calibr8_tpu_torch.mechanics.global_residual import PARENT_MEASURE
from calibr8_tpu_torch.models.batched import KERNEL_MODEL_ID, get_batched_model, usum


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


def _check_inputs(disc, bmodel, x, xi_prev, params_all):
    dev, dt = disc.device, disc.dtype
    req = kernels.require
    req(disc.spec.mixed, "the fused assembly takes mixed u/p specs only")
    for name, t in (("x", x), ("xi_prev", xi_prev), ("params_all", params_all)):
        req(t.device == dev, f"{name} is on {t.device}, the Disc on {dev}")
        req(t.dtype == dt, f"{name} is {t.dtype}, the Disc {dt}")
        req(t.is_contiguous(), f"{name} is not contiguous")
    req(x.shape == (disc.n_dofs,), f"x has shape {tuple(x.shape)}, want ({disc.n_dofs},)")
    req(
        xi_prev.shape == (disc.n_elem, bmodel.nxi),
        f"xi_prev has shape {tuple(xi_prev.shape)}, want ({disc.n_elem}, {bmodel.nxi})",
    )
    req(
        params_all.ndim == 2 and params_all.shape[1] == len(bmodel.model.param_names),
        f"params_all has shape {tuple(params_all.shape)}",
    )


_ARGTYPES = (
    [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 8
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    + [ctypes.c_void_p] * 6
)


def fused_assembly(disc, bmodel, x, xi_prev, params_all):
    """(R_T, J_T, xi_T, path, fail) for every element of `disc`.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors
    it runs the plain version."""
    if not x.is_cuda:
        return fused_assembly_plain(disc, bmodel, x, xi_prev, params_all)
    _check_inputs(disc, bmodel, x, xi_prev, params_all)
    spec = disc.spec
    d, nde, E = spec.dim, spec.ndofs_elem, disc.n_elem
    opts = dict(dtype=disc.dtype, device=disc.device)
    R_T = torch.empty(nde, E, **opts)
    J_T = torch.empty(nde, nde, E, **opts)
    xi_T = torch.empty(bmodel.nxi, E, **opts)
    path = torch.empty(E, dtype=torch.int32, device=disc.device)
    fail = torch.empty(E, dtype=torch.int32, device=disc.device)
    N1, w1, mass = quadrature_tables(d)
    flat = [v for row in N1 for v in row] + w1 + [v for row in mass for v in row]
    quad = (ctypes.c_double * len(flat))(*flat)
    fn = kernels.function("fused_assembly", "c8_fused_assembly", _ARGTYPES)
    err = fn(
        x.device.index, kernels.dtype_code(disc.dtype), KERNEL_MODEL_ID[bmodel.name], d, E,
        x.data_ptr(), disc.edofs_T.data_ptr(), xi_prev.data_ptr(),
        disc.gN_T.data_ptr(), disc.detJ.data_ptr(), disc.h.data_ptr(),
        params_all.data_ptr(), disc.es_ids32.data_ptr(),
        ctypes.cast(quad, ctypes.c_void_p), len(w1),
        float(spec.stab_multiplier) * 0.5, float(bmodel.abs_tol),
        R_T.data_ptr(), J_T.data_ptr(), xi_T.data_ptr(), path.data_ptr(),
        fail.data_ptr(), kernels.stream_ptr(disc.device),
    )
    kernels.check("fused_assembly", err)
    kernels.launches["fused_assembly"] += 1
    return R_T, J_T, xi_T, path, fail


def fused_assembly_plain(disc, bmodel, x, xi_prev, params_all):
    """The plain PyTorch version of the kernel: the same function, the
    same outputs, on any device."""
    spec = disc.spec
    d, npe, ndpn, nde = spec.dim, spec.npe, spec.ndofs_per_node, spec.ndofs_elem
    E = disc.n_elem
    ngu = d * d
    dtype = x.dtype
    N1v, w1v, mass = quadrature_tables(d)
    meas0 = PARENT_MEASURE[d]

    xm = x[disc.edofs].T.reshape(npe, ndpn, E)
    u_T, p_eT = xm[:, :d], xm[:, d]
    gNT = disc.gN_T
    dJ, hh = disc.detJ, disc.h
    parT = params_all[disc.es_ids].T
    xipT = xi_prev.T

    # grad_u[i, j] = sum_n u[n, i] gN[n, j]
    gu = torch.stack(
        [torch.stack([usum(u_T[:, i] * gNT[:, j], 0) for j in range(d)]) for i in range(d)]
    )

    # state-independent pressure data (frozen under the grad_u seeds)
    mu = parT[0] / (2.0 * (1.0 + parT[1]))
    wdv0 = dJ * meas0
    psf = bmodel.pressure_scale_factor(parT)
    tau = spec.stab_multiplier * 0.5 * hh * hh / mu
    p_ip = usum(p_eT, 0) * (1.0 / npe)
    grad_p = [usum(p_eT * gNT[:, j], 0) for j in range(d)]
    coef = [
        (usum(torch.stack([N1v[q][n] * p_eT[n] for n in range(npe)]), 0) / psf) * (w1v[q] * dJ)
        for q in range(len(w1v))
    ]
    stab_gp = [tau * g for g in grad_p]

    def S_rows(xi_, gu_):
        """Residual rows (nde, E) at frozen nodal pressures."""
        sigma = bmodel.cauchy(xi_, gu_, parT, p_ip)
        rp_const = -(bmodel.hydro_cauchy(xi_, gu_, parT) / psf) * (1.0 / npe) * wdv0
        rows = []
        for n in range(npe):
            for i in range(d):
                rows.append(usum(sigma[i] * gNT[n], 0) * wdv0)
            stab_n = usum(torch.stack(stab_gp) * gNT[n], 0)
            r_p1 = usum(torch.stack([coef[q] * N1v[q][n] for q in range(len(w1v))]), 0)
            rows.append(rp_const - stab_n * wdv0 - r_p1)
        return torch.stack(rows)

    def H(guf):
        gu_ = guf.reshape(d, d, E)
        xi_, _, _ = bmodel.local_solve(xipT, gu_, parT)
        return S_rows(xi_, gu_)

    gu0f = gu.reshape(ngu, E)
    cols = []
    for g in range(ngu):
        seed = torch.zeros_like(gu0f)
        seed[g] = 1.0
        R_T, col = torch.func.jvp(H, (gu0f,), (seed,))
        cols.append(col)
    K = torch.stack(cols, dim=1).reshape(nde, d, d, E)  # K[i, c, j] = dR_i/dgu[c, j]
    xiT, path, fail = bmodel.local_solve(xipT, gu, parT)

    J_T = torch.empty(nde, nde, E, dtype=dtype, device=x.device)
    J5 = J_T.view(npe, ndpn, npe, ndpn, E)
    # u columns: J[i, (m, c)] = sum_j K[i, c, j] gN[m, j]
    J5[:, :, :, :d] = torch.einsum("icjE,mjE->imcE", K, gNT).reshape(npe, ndpn, npe, d, E)
    # p columns of the momentum rows: -(1/npe) gN[n, ci] wdv0, for every m
    J5[:, :d, :, d] = (-(1.0 / npe) * gNT * wdv0)[:, :, None, :]
    # p columns of the pressure rows: -tau wdv0 gg[m, n] - (dJ/psf) mass[n][m]
    gg = torch.einsum("njE,mjE->nmE", gNT, gNT)
    mass_t = torch.tensor(mass, dtype=dtype, device=x.device)
    J5[:, d, :, d] = -tau * wdv0 * gg - (dJ / psf) * mass_t[:, :, None]
    return R_T, J_T, xiT, path, fail


class FusedAssembler:
    """Residual, element Jacobians and local state for one (model, mesh)."""

    def __init__(self, disc, model):
        self.disc = disc
        self.model = model
        self.spec = disc.spec
        self.bmodel = get_batched_model(model)

    def assemble(self, x, xi_prev, params_all):
        """Returns (R (n_dofs,), J_T (nde, nde, E), diag (n_dofs,),
        xi (E, nxi), path (E,), nfail (0-d tensor))."""
        disc = self.disc
        npe, ndpn = self.spec.npe, self.spec.ndofs_per_node
        E = disc.n_elem
        R_T, J_T, xi_T, path, fail = fused_assembly(disc, self.bmodel, x, xi_prev, params_all)
        # one scatter for the residual and the Jacobian diagonal together
        D = torch.diagonal(J_T, 0, 0, 1)  # (E, nde)
        rows = torch.cat(
            [R_T.T.reshape(E * npe, ndpn), D.reshape(E * npe, ndpn)], dim=1
        )
        X = disc.scatter_rows(rows)
        R = disc.nodemat_to_flat(X[:, :ndpn])
        diag = disc.nodemat_to_flat(X[:, ndpn:])
        return R, J_T, diag, xi_T.T.contiguous(), path, fail.sum()
