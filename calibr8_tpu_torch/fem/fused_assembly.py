"""Fused element assembly: the CUDA kernels, their plain version, and
the assembler that scatters their results.

The counterpart of calibr8_tpu's fem/pallas_assembly.py
(make_pallas_assemble, pallas_call at :496).  Per element: the grad_u
kinematics, the local solve of the model twin, the residual rows, and
the statically condensed element Jacobian
dR/dx - dR/dxi (dC/dxi)^-1 dC/dx (reference evaluations.cpp:112).  The
twin decides the mode:

  analytic (elastic, small_J2,   closed-form local solve, so the d*d
  isotropic_elastic)             grad_u tangents of the rows through it
                                 ARE the condensed Jacobian
                                 (pallas_assembly.py:343-362); kernel
                                 csrc/fused_assembly.cu
  implicit (the Hill, hyper_J2,  a local Newton per element, then the
  hypo_hill and eigensolver      tangents of H(v) = [C; S_rows] over the
  families, the hybrid)          nxi + d*d seeds of v = [xi; grad_u] and
                                 dxi/dgu = -(dC/dxi)^-1 dC/dgu at the
                                 Newton's path (the frozen one for the
                                 eigensolver twins;
                                 pallas_assembly.py:363-400); kernel
                                 csrc/implicit_assembly.cu, or
                                 csrc/implicit_eig.cu for small_hosford
                                 and hypo_hosford, implicit_barlat.cu
                                 for hypo_barlat, implicit_hybrid.cu for
                                 the hybrid with its embedded network

The spec decides the rows: mixed u/p with GLS stabilization, whose
pressure columns are added analytically (pallas_assembly.py:423-476),
or displacement only (isotropic_elastic, and the plane-stress twins
under 'mechanics_plane_stress'), the momentum rows alone
(pallas_assembly.py:299-314,402-421), times the thickness under plane
stress only: calibr8_tpu's Pallas kernel multiplies every non-mixed row
by it (:313), its generic path and the reference's mechanics under plane
stress alone (mechanics/global_residual.py:145-163), and the port follows
the generic path.  A twin
with finite_deformation has PK1 momentum rows sigma cof(F) (times the
z-stretch when displacement only), the stabilization (tau / det F)
cof^T cof grad_p, and pressure columns through cof(F) and cof^T cof /
det F at the element's F (pallas_assembly.py:235,299-315,423-451).

  fused_assembly(...)        the wrapper: a kernel on CUDA tensors, the
                             plain version on CPU ones
  fused_assembly_plain(...)  the same function in PyTorch, tangents from
                             torch.func.jvp over unit seeds (the
                             counterpart of jax.linearize)
  assembly_elems(...)        the element-level entry (kernel 1c, which the
                             domain-decomposed solver calls on its parts'
                             gathered elements): the same kernels reading
                             pre-gathered element columns, counted as
                             `assembly_elems`
  assembly_elems_plain(...)  its plain version, which fused_assembly_plain
                             calls on the gathered elements of a Disc
  FusedAssembler             R, J, diag, xi, path, nfail for the Newton loop

Outputs keep calibr8_tpu's trailing layout: R_T (nde, E), J_T
(nde, nde, E), xi_T (nxi, E), path and fail (E,) int32, so they compare
directly with make_pallas_assemble's.  x_prev, the previous step's
solution, is read by the finite-deformation twins only (their trial
state pushes xi_prev forward by F F_prev^-1); for the others it may be
None.
"""

from __future__ import annotations

import ctypes

import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.mechanics.global_residual import (
    PARENT_MEASURE, elem_kinematics, make_elem_rows, quadrature_tables, stab_tau,
)
from calibr8_tpu_torch.models.batched import (
    KERNEL_MODEL_ID, get_batched_model, jvp_columns, t_cof, t_det, t_F, t_mm, t_transpose,
)
from calibr8_tpu_torch.models.nn import ACTIVATION_CODE
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_T


def check_supported(bmodel, spec) -> None:
    """Raise NotImplementedError unless the fused assembly takes this
    (twin, residual) pair; the pairs are calibr8_tpu's supports_pallas
    (pallas_assembly.py:57-65).  The others run calibr8_tpu's generic
    XLA path, which the port does not have."""
    if bmodel.plane_stress:
        ok, want = spec.plane_stress and not spec.mixed, "'mechanics_plane_stress'"
    elif getattr(bmodel, "displacement_only", False):
        ok, want = not spec.mixed, ("a displacement-only residual ('mixed formulation: false' "
                                    "or 'mechanics_plane_stress')")
    else:
        ok, want = spec.mixed and not spec.plane_stress, "the mixed u/p 'mechanics' residual"
    if not ok:
        raise NotImplementedError(
            f"{bmodel.name!r} runs in the fused assembly only under {want}; other pairings "
            "take calibr8_tpu's generic (XLA) assembly, which is not ported"
        )


def _check_inputs(disc, bmodel, x, xi_prev, params_all, x_prev=None):
    dev, dt = disc.device, disc.dtype
    req = kernels.require
    named = [("x", x), ("xi_prev", xi_prev), ("params_all", params_all)]
    if x_prev is not None:
        req(x_prev.shape == x.shape, f"x_prev has shape {tuple(x_prev.shape)}, x {tuple(x.shape)}")
        named.append(("x_prev", x_prev))
    for name, t in named:
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


def _outputs(spec, bmodel, E, dtype, device):
    nde = spec.ndofs_elem
    opts = dict(dtype=dtype, device=device)
    return (
        torch.empty(nde, E, **opts),
        torch.empty(nde, nde, E, **opts),
        torch.empty(bmodel.nxi, E, **opts),
        torch.empty(E, dtype=torch.int32, device=device),
        torch.empty(E, dtype=torch.int32, device=device),
    )


_ARGTYPES = (
    [ctypes.c_int] * 5
    + [ctypes.c_void_p] * 8
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_double] * 3
    + [ctypes.c_void_p] * 6
)


def row_thickness(spec) -> float:
    """The factor of the displacement-only rows: the thickness under plane
    stress, 1 otherwise (calibr8_tpu's generic path)."""
    return float(spec.thickness) if spec.plane_stress else 1.0


def fused_assembly(disc, bmodel, x, xi_prev, params_all, x_prev=None):
    """(R_T, J_T, xi_T, path, fail) for every element of `disc`.

    On CUDA tensors this launches the twin's kernel (or raises): the
    analytic kernel here (mixed u/p rows for elastic and small_J2, the
    displacement-only rows for isotropic_elastic), the implicit ones
    through implicit_assembly.  On CPU tensors it runs the plain version."""
    if not x.is_cuda:
        return fused_assembly_plain(disc, bmodel, x, xi_prev, params_all, x_prev=x_prev)
    if not bmodel.analytic_solve:
        return implicit_assembly(disc, bmodel, x, xi_prev, params_all, x_prev=x_prev)
    _check_inputs(disc, bmodel, x, xi_prev, params_all)
    check_supported(bmodel, disc.spec)
    return _launch(disc.spec, bmodel, disc.n_elem, x, None, disc.edofs_T, xi_prev, disc.gN_T,
                   disc.detJ, disc.h, params_all, disc.es_ids32)


_IMPLICIT_ARGTYPES = (
    [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 9
    + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_double] * 4
    + [ctypes.c_void_p] * 7
)


# the eigensolver twins' and the hybrid's kernels: libraries of their own
# (csrc/implicit_eig.cu, csrc/implicit_barlat.cu, csrc/implicit_hybrid.cu),
# each with its launch count; the other implicit twins' is implicit_assembly
IMPLICIT_LIB = {"small_hosford": ("implicit_eig", "c8_implicit_eig_assembly"),
                "hypo_hosford": ("implicit_eig", "c8_implicit_eig_assembly"),
                "hypo_barlat": ("implicit_barlat", "c8_implicit_barlat_assembly"),
                "hybrid_hyper_J2_plane_stress": ("implicit_hybrid",
                                                 "c8_implicit_hybrid_assembly")}

# the network the hybrid's kernel takes (csrc/c8_hybrid.cuh NN_MAX_WIDTH,
# NN_MAX_HIDDEN): scalar in, at most 4 hidden layers of at most 16 units
NN_MAX_WIDTH = 16
NN_MAX_HIDDEN = 4
# the network's description after the common arguments: activation code,
# number of weight layers, the widths (the topology), in and out scales,
# the parameter row's stride
_HYBRID_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_double,
                    ctypes.c_double, ctypes.c_int]


# per card: the hybrid network description the wrapper passed last, which
# the library then holds in constant memory (implicit_hybrid.cu put_net)
_hybrid_net_last: dict[int, tuple] = {}


def hybrid_net_args(bmodel, params_all):
    """The hybrid kernel's network arguments; NotImplementedError above the
    kernel's cap (the plain version has none)."""
    topo = bmodel.nn.topology
    hidden = topo[1:-1]
    if topo[0] != 1 or len(hidden) > NN_MAX_HIDDEN or max(hidden) > NN_MAX_WIDTH:
        raise NotImplementedError(
            f"the hybrid's kernel takes a scalar-input network of at most {NN_MAX_HIDDEN} "
            f"hidden layers of at most {NN_MAX_WIDTH} units; topology {topo} is above that cap "
            "(the plain version, on the CPU, takes any)"
        )
    return (ACTIVATION_CODE[bmodel.nn.activation], len(topo) - 1,
            (ctypes.c_int * len(topo))(*topo), float(bmodel.in_scale),
            float(bmodel.out_scale), params_all.shape[1])


def implicit_assembly(disc, bmodel, x, xi_prev, params_all, newton_iters=None, x_prev=None):
    """The implicit-mode kernel for an implicit twin on CUDA tensors:
    (R_T, J_T, xi_T, path, fail), from csrc/implicit_assembly.cu, or, for
    the eigensolver twins, csrc/implicit_eig.cu and implicit_barlat.cu, for
    the hybrid implicit_hybrid.cu (its network above the kernel's cap
    raises NotImplementedError); the finite-deformation twins read x_prev.
    With `newton_iters` an int32 (E,) CUDA tensor, the kernel also writes
    each element's local Newton iteration count there.  On CPU tensors it
    runs the plain version."""
    if not x.is_cuda:
        return fused_assembly_plain(disc, bmodel, x, xi_prev, params_all, x_prev=x_prev,
                                    newton_iters=newton_iters)
    _check_inputs(disc, bmodel, x, xi_prev, params_all, x_prev)
    spec = disc.spec
    req = kernels.require
    req(not bmodel.analytic_solve, f"{bmodel.name!r} is an analytic twin")
    req(x_prev is not None or not bmodel.finite_deformation,
        f"{bmodel.name!r} reads x_prev: pass it")
    check_supported(bmodel, spec)
    E = disc.n_elem
    if newton_iters is not None:
        req(newton_iters.shape == (E,) and newton_iters.dtype == torch.int32
            and newton_iters.device == disc.device and newton_iters.is_contiguous(),
            "newton_iters must be a contiguous (E,) int32 tensor on the Disc's device")
    return _launch(spec, bmodel, E, x, x_prev, disc.edofs_T, xi_prev, disc.gN_T, disc.detJ,
                   disc.h, params_all, disc.es_ids32, newton_iters=newton_iters)


def implicit_args(spec, bmodel, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params_all,
                  es_ids32, outs, newton_iters=None):
    """The arguments of an implicit library's C entry (the hybrid's network
    arguments follow them) for checked CUDA tensors and the outputs `outs`
    = (R_T, J_T, xi_T, path, fail); edofs_T None for the element-level
    entry."""
    quad, npts = _quad_array(spec.dim)
    return (x.device.index, kernels.dtype_code(x.dtype), KERNEL_MODEL_ID[bmodel.name], E,
            x.data_ptr(), (x if x_prev is None else x_prev).data_ptr(),
            None if edofs_T is None else edofs_T.data_ptr(), xi_prev.data_ptr(),
            gN_T.data_ptr(), detJ.data_ptr(), h.data_ptr(), params_all.data_ptr(),
            es_ids32.data_ptr(), ctypes.cast(quad, ctypes.c_void_p), npts,
            float(spec.stab_multiplier) * 0.5, float(spec.thickness), float(bmodel.abs_tol),
            max(bmodel.abs_tol * 10.0, 1e-30), *(t.data_ptr() for t in outs),
            None if newton_iters is None else newton_iters.data_ptr(),
            kernels.stream_ptr(x.device))


def _launch(spec, bmodel, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params_all, es_ids32,
            newton_iters=None, counter=None):
    """Launch the twin's library on checked CUDA arguments into fresh
    outputs (R_T, J_T, xi_T, path, fail): the analytic kernel
    (csrc/fused_assembly.cu) or the twin's implicit one (IMPLICIT_LIB).
    edofs_T None: x (and x_prev) hold the (nde, E) element columns (the
    element-level entry).  The launch counts under `counter`, by default
    the library's name, and by model in kernels.model_launches."""
    R_T, J_T, xi_T, path, fail = _outputs(spec, bmodel, E, x.dtype, x.device)
    quad, npts = _quad_array(spec.dim)
    ed = None if edofs_T is None else edofs_T.data_ptr()
    if bmodel.analytic_solve:
        lib = "fused_assembly"
        fn = kernels.function(lib, "c8_fused_assembly", _ARGTYPES)
        err = fn(
            x.device.index, kernels.dtype_code(x.dtype), KERNEL_MODEL_ID[bmodel.name], spec.dim,
            E, x.data_ptr(), ed, xi_prev.data_ptr(), gN_T.data_ptr(), detJ.data_ptr(),
            h.data_ptr(), params_all.data_ptr(), es_ids32.data_ptr(),
            ctypes.cast(quad, ctypes.c_void_p), npts,
            float(spec.stab_multiplier) * 0.5, float(bmodel.abs_tol), row_thickness(spec),
            R_T.data_ptr(), J_T.data_ptr(), xi_T.data_ptr(), path.data_ptr(),
            fail.data_ptr(), kernels.stream_ptr(x.device),
        )
    else:
        lib, symbol = IMPLICIT_LIB.get(bmodel.name, ("implicit_assembly", "c8_implicit_assembly"))
        net, argtypes = (), _IMPLICIT_ARGTYPES
        if lib == "implicit_hybrid":
            net = hybrid_net_args(bmodel, params_all)
            _hybrid_net_last[x.device.index] = (*net[:2], tuple(net[2]), *net[3:])
            argtypes = _IMPLICIT_ARGTYPES + _HYBRID_ARGTYPES
        fn = kernels.function(lib, symbol, argtypes)
        err = fn(*implicit_args(spec, bmodel, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h,
                                params_all, es_ids32, (R_T, J_T, xi_T, path, fail),
                                newton_iters), *net)
    kernels.check(lib, err)
    kernels.launches[counter or lib] += 1
    key = (counter or lib, bmodel.name)
    kernels.model_launches[key] = kernels.model_launches.get(key, 0) + 1
    return R_T, J_T, xi_T, path, fail


def assembly_elems(spec, bmodel, x_eT, xp_eT, xi_prev_T, gN_T, detJ, h, params_all, es_ids,
                   newton_iters=None):
    """The element-level entry (kernel 1c of calibr8_tpu's
    make_pallas_assemble, fem/pallas_assembly.py:529-543, built and called
    per part by parallel/dist.py:199-215,308): (R_T, J_T, xi_T, path,
    fail) for E pre-gathered elements in trailing layout,

      x_eT, xp_eT (nde, E)   element dofs and the previous step's (xp_eT
                             is read by the finite-deformation twins)
      xi_prev_T   (nxi, E)   a transposed view of a contiguous (E, nxi)
      gN_T (npe, d, E), detJ (E,), h (E,)
      params_all (n_sets, n_params) and es_ids (E,): each element reads
                             its set's row, as the single-device entry does

    On CUDA tensors this launches the twin's library with a null edofs_T
    (the kernels then read x_eT's columns; c8_element.cuh elem_dof), the
    same arithmetic as fused_assembly on the same elements, counted as
    `assembly_elems`; on CPU tensors it runs the plain version.
    `newton_iters` as for implicit_assembly (implicit twins)."""
    if not x_eT.is_cuda:
        return assembly_elems_plain(spec, bmodel, x_eT, xp_eT, xi_prev_T, gN_T, detJ, h,
                                    params_all, es_ids, newton_iters=newton_iters)
    check_supported(bmodel, spec)
    req = kernels.require
    nde, E = x_eT.shape
    d, npe = spec.dim, spec.npe
    req(nde == spec.ndofs_elem, "x_eT's rows are not the spec's element dofs")
    req(xp_eT is not None or not bmodel.finite_deformation,
        "the finite-deformation twins read x_prev: pass xp_eT")
    xi_prev = xi_prev_T.T
    named = [("x_eT", x_eT, (nde, E)), ("xi_prev_T", xi_prev, (E, bmodel.nxi)),
             ("gN_T", gN_T, (npe, d, E)), ("detJ", detJ, (E,)), ("h", h, (E,)),
             ("params_all", params_all, (params_all.shape[0], len(bmodel.model.param_names)))]
    if xp_eT is not None:
        named.append(("xp_eT", xp_eT, (nde, E)))
    # the messages are formatted only on failure: formatted eagerly they
    # cost tens of microseconds of host time a call, as much as the kernel
    # itself on the memory-bound twins
    for name, t, shape in named:
        if (tuple(t.shape) != shape or t.device != x_eT.device or t.dtype != x_eT.dtype
                or not t.is_contiguous()):
            req(False, f"{name}: shape {tuple(t.shape)}, {t.dtype} on {t.device}, contiguous "
                       f"{t.is_contiguous()}; want {shape}, {x_eT.dtype} on {x_eT.device}, "
                       "contiguous (xi_prev_T: its transpose)")
    req(es_ids.shape == (E,) and es_ids.dtype == torch.int32 and es_ids.device == x_eT.device
        and es_ids.is_contiguous(),
        "es_ids must be a contiguous (E,) int32 tensor on x_eT's device")
    if newton_iters is not None:
        req(not bmodel.analytic_solve and newton_iters.shape == (E,)
            and newton_iters.dtype == torch.int32 and newton_iters.device == x_eT.device
            and newton_iters.is_contiguous(),
            "newton_iters must be a contiguous (E,) int32 tensor on x_eT's device (implicit twins)")
    return _launch(spec, bmodel, E, x_eT, xp_eT, None, xi_prev, gN_T, detJ, h, params_all,
                   es_ids, newton_iters=newton_iters, counter="assembly_elems")


def fused_assembly_plain(disc, bmodel, x, xi_prev, params_all, x_prev=None,
                         newton_iters=None):
    """The plain PyTorch version of the kernels: the same function, the
    same outputs, on any device; `newton_iters` as for implicit_assembly."""
    return assembly_elems_plain(
        disc.spec, bmodel, x[disc.edofs].T, None if x_prev is None else x_prev[disc.edofs].T,
        xi_prev.T, disc.gN_T, disc.detJ, disc.h, params_all, disc.es_ids,
        newton_iters=newton_iters,
    )


def assembly_elems_plain(spec, bmodel, x_eT, xp_eT, xi_prev_T, gN_T, detJ, h, params_all,
                         es_ids, newton_iters=None):
    """The plain PyTorch version of assembly_elems (and, on gathered
    elements, of every assembly kernel): the same function, the same
    outputs, on any device; `newton_iters` as for implicit_assembly."""
    d, npe, ndpn, nde = spec.dim, spec.npe, spec.ndofs_per_node, spec.ndofs_elem
    E = x_eT.shape[1]
    ngu = d * d
    mixed = spec.mixed
    dtype = x_eT.dtype
    _, _, mass = quadrature_tables(d)

    gNT = gN_T
    dJ, hh = detJ, h
    geom = (gNT, dJ, hh)
    parT = params_all[es_ids.long()].T
    xipT = xi_prev_T
    wdv0 = dJ * PARENT_MEASURE[d]
    gu = elem_kinematics(spec, x_eT, gNT)
    # frozen under the seeds, as calibr8_tpu's kernel holds it
    gu_prev = None if xp_eT is None else elem_kinematics(spec, xp_eT, gNT)
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
            xi_, _, _ = bmodel.local_solve(xipT, gu_, parT, gu_prev)
            return S_rows(xi_, gu_)

        R_T, cols = jvp_columns(H, gu0f)  # cols[g, i] = dR_i/dgu_g
        K = cols.permute(1, 0, 2)
        xiT, path, fail = bmodel.local_solve(xipT, gu, parT, gu_prev)
    else:
        # implicit condensation about the Newton solution: seeds over
        # v = [xi; gu], dxi/dgu = -(dC/dxi)^-1 dC/dgu
        nxi = bmodel.nxi
        xiT, path, fail = bmodel.local_solve(xipT, gu, parT, gu_prev, newton_iters)

        def H(v):
            xi_ = v[:nxi]
            gu_ = v[nxi:].reshape(d, d, E)
            C = bmodel.residual(xi_, xipT, gu_, parT, path, gu_prev)
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

    J_T = torch.empty(nde, nde, E, dtype=dtype, device=x_eT.device)
    J5 = J_T.view(npe, ndpn, npe, ndpn, E)
    # u columns: J[i, (m, c)] = sum_j K[i, c, j] gN[m, j]
    J5[:, :, :, :d] = torch.einsum("icjE,mjE->imcE", K, gNT).reshape(npe, ndpn, npe, d, E)
    if mixed:
        if bmodel.finite_deformation:
            # through F: momentum -(1/npe) wdv0 (cof(F) gN_n)_ci, and the
            # pull-back M = cof^T cof / det F in gg
            F0 = t_F(gu)
            cof0 = t_cof(F0)
            M0 = t_mm(t_transpose(cof0), cof0) / t_det(F0)
            pcol = torch.einsum("cjE,njE->ncE", cof0, gNT)
            gg = torch.einsum("njE,jkE,mkE->nmE", gNT, M0, gNT)
        else:
            pcol, gg = gNT, torch.einsum("njE,mjE->nmE", gNT, gNT)
        # p columns of the momentum rows: -(1/npe) wdv0 pcol[n, ci], for every m
        J5[:, :d, :, d] = (-(1.0 / npe) * pcol * wdv0)[:, :, None, :]
        # p columns of the pressure rows: -tau wdv0 gg[m, n] - (dJ/psf) mass[n][m]
        mass_t = torch.tensor(mass, dtype=dtype, device=x_eT.device)
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

    def const_state(self):
        """What this assembly's kernel keeps on the card between launches,
        outside its arguments: for the hybrid, the network description its
        wrapper passed last (the library holds it in constant memory, and
        a CUDA graph that replays the kernel reads it there); None for
        every other library, and before the first launch."""
        if IMPLICIT_LIB.get(self.bmodel.name, ("",))[0] != "implicit_hybrid":
            return None
        return _hybrid_net_last.get(self.disc.device.index)

    def assemble(self, x, xi_prev, params_all, x_prev=None):
        """Returns (R (n_dofs,), J_T (nde, nde, E), diag (n_dofs,),
        xi (E, nxi), path (E,), nfail (0-d tensor)); x_prev, the previous
        step's solution, is read by the finite-deformation twins."""
        disc = self.disc
        npe, ndpn = self.spec.npe, self.spec.ndofs_per_node
        E = disc.n_elem
        R_T, J_T, xi_T, path, fail = fused_assembly(disc, self.bmodel, x, xi_prev, params_all,
                                                    x_prev=x_prev)
        # one scatter for the residual and the Jacobian diagonal together
        D = torch.diagonal(J_T, 0, 0, 1)  # (E, nde)
        rows = torch.cat(
            [R_T.T.reshape(E * npe, ndpn), D.reshape(E * npe, ndpn)], dim=1
        )
        X = disc.scatter_rows(rows)
        R = disc.nodemat_to_flat(X[:, :ndpn])
        diag = disc.nodemat_to_flat(X[:, ndpn:])
        return R, J_T, diag, xi_T.T.contiguous(), path, fail.sum()
