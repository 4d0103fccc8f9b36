"""Fused element assembly: the CUDA kernels, their plain version, and
the assembler that scatters their results.

The counterpart of calibr8_tpu's fem/pallas_assembly.py
(make_pallas_assemble, pallas_call at :496).  Per element: the grad_u
kinematics, the local solve of the model twin, the residual rows, and
the statically condensed element Jacobian
dR/dx - dR/dxi (dC/dxi)^-1 dC/dx (reference evaluations.cpp:112).  The
twin decides the mode:

  analytic (elastic, small_J2)   closed-form local solve, so the d*d
                                 grad_u tangents of the rows through it
                                 ARE the condensed Jacobian
                                 (pallas_assembly.py:343-362); kernel
                                 csrc/fused_assembly.cu
  implicit (the Hill family)     a local Newton per element, then the
                                 tangents of H(v) = [C; S_rows] over the
                                 nxi + d*d seeds of v = [xi; grad_u] and
                                 dxi/dgu = -(dC/dxi)^-1 dC/dgu
                                 (pallas_assembly.py:363-400); kernel
                                 csrc/implicit_assembly.cu

The spec decides the rows: mixed u/p with GLS stabilization, whose
pressure columns are added analytically (pallas_assembly.py:423-476),
or displacement only, the momentum rows times the thickness
('mechanics_plane_stress', pallas_assembly.py:299-314,402-421).

  fused_assembly(...)        the wrapper: a kernel on CUDA tensors, the
                             plain version on CPU ones
  fused_assembly_plain(...)  the same function in PyTorch, tangents from
                             torch.func.jvp over unit seeds (the
                             counterpart of jax.linearize)
  FusedAssembler             R, J, diag, xi, path, nfail for the Newton loop

Outputs keep calibr8_tpu's trailing layout: R_T (nde, E), J_T
(nde, nde, E), xi_T (nxi, E), path and fail (E,) int32, so they compare
directly with make_pallas_assemble's.  No model ported so far reads
grad_u_prev, so the kernels take no x_prev.
"""

from __future__ import annotations

import ctypes

import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.mechanics.global_residual import (
    PARENT_MEASURE, elem_kinematics, make_elem_rows, quadrature_tables, stab_tau,
)
from calibr8_tpu_torch.models.batched import KERNEL_MODEL_ID, get_batched_model, jvp_columns
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_T


def check_supported(bmodel, spec) -> None:
    """Raise NotImplementedError unless the fused assembly takes this
    (twin, residual) pair; the pairs are calibr8_tpu's supports_pallas
    (pallas_assembly.py:57-65).  The others run calibr8_tpu's generic
    XLA path, which the port does not have."""
    if bmodel.plane_stress:
        ok, want = spec.plane_stress and not spec.mixed, "'mechanics_plane_stress'"
    else:
        ok, want = spec.mixed and not spec.plane_stress, "the mixed u/p 'mechanics' residual"
    if not ok:
        raise NotImplementedError(
            f"{bmodel.name!r} runs in the fused assembly only under {want}; other pairings "
            "take calibr8_tpu's generic (XLA) assembly, which is not ported"
        )


def _check_inputs(disc, bmodel, x, xi_prev, params_all):
    dev, dt = disc.device, disc.dtype
    req = kernels.require
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


def _quad_array(d: int):
    """[N1 (npts, npe) | w1 (npts) | mass (npe, npe)] as a C double array."""
    N1, w1, mass = quadrature_tables(d)
    flat = [v for row in N1 for v in row] + w1 + [v for row in mass for v in row]
    return (ctypes.c_double * len(flat))(*flat), len(w1)


def _outputs(disc, bmodel):
    nde, E = disc.spec.ndofs_elem, disc.n_elem
    opts = dict(dtype=disc.dtype, device=disc.device)
    return (
        torch.empty(nde, E, **opts),
        torch.empty(nde, nde, E, **opts),
        torch.empty(bmodel.nxi, E, **opts),
        torch.empty(E, dtype=torch.int32, device=disc.device),
        torch.empty(E, dtype=torch.int32, device=disc.device),
    )


_ARGTYPES = (
    [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 8
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    + [ctypes.c_void_p] * 6
)


def fused_assembly(disc, bmodel, x, xi_prev, params_all):
    """(R_T, J_T, xi_T, path, fail) for every element of `disc`.

    On CUDA tensors this launches the twin's kernel (or raises): the
    analytic kernel here, the implicit one through implicit_assembly.
    On CPU tensors it runs the plain version."""
    if not x.is_cuda:
        return fused_assembly_plain(disc, bmodel, x, xi_prev, params_all)
    if not bmodel.analytic_solve:
        return implicit_assembly(disc, bmodel, x, xi_prev, params_all)
    _check_inputs(disc, bmodel, x, xi_prev, params_all)
    spec = disc.spec
    kernels.require(spec.mixed, "the analytic kernel takes mixed u/p specs only")
    R_T, J_T, xi_T, path, fail = _outputs(disc, bmodel)
    quad, npts = _quad_array(spec.dim)
    fn = kernels.function("fused_assembly", "c8_fused_assembly", _ARGTYPES)
    err = fn(
        x.device.index, kernels.dtype_code(disc.dtype), KERNEL_MODEL_ID[bmodel.name], spec.dim,
        disc.n_elem, x.data_ptr(), disc.edofs_T.data_ptr(), xi_prev.data_ptr(),
        disc.gN_T.data_ptr(), disc.detJ.data_ptr(), disc.h.data_ptr(),
        params_all.data_ptr(), disc.es_ids32.data_ptr(),
        ctypes.cast(quad, ctypes.c_void_p), npts,
        float(spec.stab_multiplier) * 0.5, float(bmodel.abs_tol),
        R_T.data_ptr(), J_T.data_ptr(), xi_T.data_ptr(), path.data_ptr(),
        fail.data_ptr(), kernels.stream_ptr(disc.device),
    )
    kernels.check("fused_assembly", err)
    kernels.launches["fused_assembly"] += 1
    return R_T, J_T, xi_T, path, fail


_IMPLICIT_ARGTYPES = (
    [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 8
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_double] * 4
    + [ctypes.c_void_p] * 7
)


def implicit_assembly(disc, bmodel, x, xi_prev, params_all, newton_iters=None):
    """The implicit-mode kernel (csrc/implicit_assembly.cu) for an
    implicit twin on CUDA tensors: (R_T, J_T, xi_T, path, fail).  With
    `newton_iters` an int32 (E,) CUDA tensor, the kernel also writes each
    element's local Newton iteration count there.  On CPU tensors it
    runs the plain version."""
    if not x.is_cuda:
        return fused_assembly_plain(disc, bmodel, x, xi_prev, params_all)
    _check_inputs(disc, bmodel, x, xi_prev, params_all)
    spec = disc.spec
    req = kernels.require
    req(not bmodel.analytic_solve, f"{bmodel.name!r} is an analytic twin")
    check_supported(bmodel, spec)
    E = disc.n_elem
    if newton_iters is not None:
        req(newton_iters.shape == (E,) and newton_iters.dtype == torch.int32
            and newton_iters.device == disc.device and newton_iters.is_contiguous(),
            "newton_iters must be a contiguous (E,) int32 tensor on the Disc's device")
    R_T, J_T, xi_T, path, fail = _outputs(disc, bmodel)
    quad, npts = _quad_array(spec.dim)
    fn = kernels.function("implicit_assembly", "c8_implicit_assembly", _IMPLICIT_ARGTYPES)
    err = fn(
        x.device.index, kernels.dtype_code(disc.dtype), KERNEL_MODEL_ID[bmodel.name], E,
        x.data_ptr(), disc.edofs_T.data_ptr(), xi_prev.data_ptr(),
        disc.gN_T.data_ptr(), disc.detJ.data_ptr(), disc.h.data_ptr(),
        params_all.data_ptr(), disc.es_ids32.data_ptr(),
        ctypes.cast(quad, ctypes.c_void_p), npts,
        float(spec.stab_multiplier) * 0.5, float(spec.thickness), float(bmodel.abs_tol),
        max(bmodel.abs_tol * 10.0, 1e-30),
        R_T.data_ptr(), J_T.data_ptr(), xi_T.data_ptr(), path.data_ptr(), fail.data_ptr(),
        None if newton_iters is None else newton_iters.data_ptr(),
        kernels.stream_ptr(disc.device),
    )
    kernels.check("implicit_assembly", err)
    kernels.launches["implicit_assembly"] += 1
    return R_T, J_T, xi_T, path, fail


def fused_assembly_plain(disc, bmodel, x, xi_prev, params_all):
    """The plain PyTorch version of both kernels: the same function, the
    same outputs, on any device."""
    spec = disc.spec
    d, npe, ndpn, nde = spec.dim, spec.npe, spec.ndofs_per_node, spec.ndofs_elem
    E = disc.n_elem
    ngu = d * d
    mixed = spec.mixed
    dtype = x.dtype
    _, _, mass = quadrature_tables(d)

    x_eT = x[disc.edofs].T
    gNT = disc.gN_T
    dJ, hh = disc.detJ, disc.h
    geom = (gNT, dJ, hh)
    parT = params_all[disc.es_ids].T
    xipT = xi_prev.T
    wdv0 = dJ * PARENT_MEASURE[d]
    gu = elem_kinematics(spec, x_eT, gNT)
    # the nodal pressures are constants of the grad_u (and xi) seeds
    p_eT = x_eT.reshape(npe, ndpn, E)[:, d] if mixed else None
    elem_rows = make_elem_rows(bmodel, spec)

    def S_rows(xi_, gu_):
        return elem_rows(xi_, gu_, p_eT, geom, parT)

    gu0f = gu.reshape(ngu, E)
    if bmodel.analytic_solve:
        # the grad_u tangents through the closed-form solve are the
        # condensed Jacobian
        def H(guf):
            gu_ = guf.reshape(d, d, E)
            xi_, _, _ = bmodel.local_solve(xipT, gu_, parT)
            return S_rows(xi_, gu_)

        R_T, cols = jvp_columns(H, gu0f)  # cols[g, i] = dR_i/dgu_g
        K = cols.permute(1, 0, 2)
        xiT, path, fail = bmodel.local_solve(xipT, gu, parT)
    else:
        # implicit condensation about the Newton solution: seeds over
        # v = [xi; gu], dxi/dgu = -(dC/dxi)^-1 dC/dgu
        nxi = bmodel.nxi
        xiT, path, fail = bmodel.local_solve(xipT, gu, parT)

        def H(v):
            xi_ = v[:nxi]
            gu_ = v[nxi:].reshape(d, d, E)
            C = bmodel.residual(xi_, xipT, gu_, parT, path)
            return torch.cat([C, S_rows(xi_, gu_)])

        Hf0, cols = jvp_columns(H, torch.cat([xiT, gu0f]))  # cols[k, i] = dH_i/dv_k
        dC_dxi = cols[:nxi, :nxi].permute(1, 0, 2)
        dC_dgu = cols[nxi:, :nxi].permute(1, 0, 2)
        dxi_dgu = -gauss_solve_T(dC_dxi, dC_dgu)  # (nxi, ngu, E)
        # K[i, g] = dS_i/dgu_g, then + dS_i/dxi_k dxi_k/dgu_g in k order
        K = cols[nxi:, nxi:].permute(1, 0, 2)
        for k in range(nxi):
            K = K + cols[k, nxi:][:, None, :] * dxi_dgu[k][None]
        R_T = Hf0[nxi:]
    K = K.reshape(nde, d, d, E)  # K[i, c, j] = dR_i/dgu[c, j]

    J_T = torch.empty(nde, nde, E, dtype=dtype, device=x.device)
    J5 = J_T.view(npe, ndpn, npe, ndpn, E)
    # u columns: J[i, (m, c)] = sum_j K[i, c, j] gN[m, j]
    J5[:, :, :, :d] = torch.einsum("icjE,mjE->imcE", K, gNT).reshape(npe, ndpn, npe, d, E)
    if mixed:
        # p columns of the momentum rows: -(1/npe) gN[n, ci] wdv0, for every m
        J5[:, :d, :, d] = (-(1.0 / npe) * gNT * wdv0)[:, :, None, :]
        # p columns of the pressure rows: -tau wdv0 gg[m, n] - (dJ/psf) mass[n][m]
        gg = torch.einsum("njE,mjE->nmE", gNT, gNT)
        mass_t = torch.tensor(mass, dtype=dtype, device=x.device)
        J5[:, d, :, d] = (-stab_tau(spec, parT, hh) * wdv0 * gg
                          - (dJ / bmodel.pressure_scale_factor(parT)) * mass_t[:, :, None])
    return R_T, J_T, xiT, path, fail


class FusedAssembler:
    """Residual, element Jacobians and local state for one (model, mesh)."""

    def __init__(self, disc, model):
        self.disc = disc
        self.model = model
        self.spec = disc.spec
        self.bmodel = get_batched_model(model)
        check_supported(self.bmodel, self.spec)

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
