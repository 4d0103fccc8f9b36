"""The aggregation AMG under the domain-decomposed solver.

The counterpart of calibr8_tpu's parallel/dist_mg.py (the MueLu AMG
under MPI of the reference, linear_solve.cpp:36-123): the hierarchy of
solve/amg.py's AMGPrecondFactory, with

* the fine level per part: Chebyshev smoothing on the assembled per-part
  operator the Krylov loop applies (kernel 3c per part on the card) with
  the per-part node-block diagonal inverted, and the fine <-> level-1
  transfers on the (P, N_own, ndpn) vectors;
* the level-1 Galerkin blocks assembled from every part's Dirichlet-
  masked element Jacobians into the global aggregate ELL slots, one
  index_add_ for all parts: calibr8_tpu's per-part segment_sum and psum;
* levels >= 1 (the aggregate space and coarser, replicated in
  calibr8_tpu) through the factory's _u_chain / _p_chain_from_A1, the
  same hierarchy, smoothers and coarse solves as the single-device path.

M(r) maps (P, N_own, ndpn) to (P, N_own, ndpn), the signature of
DistContext.make_precond.
"""

from __future__ import annotations

import numpy as np
import torch

from calibr8_tpu_torch.solve.amg import (
    CHEB_DEGREE, CHEB_RATIO, LMAX_ITERS, OVERCORR, AMGPrecondFactory, chebyshev, element_galerkin,
    power_lmax,
)
from calibr8_tpu_torch.solve.ellpack import assemble_ell_T_blocks
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_pivot


class DistAMG:
    """Host setup once per (mesh, partition); make() once per Jacobian."""

    def __init__(self, ctx, factory: AMGPrecondFactory | None = None):
        self.ctx = ctx
        disc = ctx.disc
        self.factory = f = factory or AMGPrecondFactory(disc)
        part = ctx.part
        dev, dtype = disc.device, disc.dtype
        lv1 = f.levels[0]
        n1, K1 = lv1.n, lv1.K
        agg, B = lv1.agg_prev, lv1.P  # (n_nodes,), (n_nodes, d, m)

        def put(a, dt=dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

        # owned nodes (pads -> the dummy aggregate n1, zero modes)
        own = part.own_nodes
        valid = own >= 0
        self.agg_own = put(np.where(valid, agg[np.where(valid, own, 0)], n1), torch.int64)
        self.B_own = put(np.where(valid[:, :, None, None], B[np.where(valid, own, 0)], 0.0))

        # rigid modes of every part's element nodes, (npe, d, m, P * E_loc)
        loc = part.local_nodes
        lvalid = loc >= 0
        B_loc = np.where(lvalid[:, :, None, None], B[np.where(lvalid, loc, 0)], 0.0)
        Bc = np.stack([B_loc[p][part.conn_local[p]] for p in range(part.n_parts)])
        self.BcT = put(Bc.reshape(-1, *Bc.shape[2:]).transpose(1, 2, 3, 0))

        # element entry -> global level-1 slot, (a, b, p, e) order; the
        # pad elements -> the dummy slot K1 * n1
        npe = disc.spec.npe
        emap = lv1.emap.reshape(disc.n_elem, npe, npe)
        evalid = part.elems >= 0
        emap_part = np.where(evalid[:, :, None, None], emap[np.where(evalid, part.elems, 0)],
                             K1 * n1)
        self.ids = put(emap_part.transpose(2, 3, 0, 1).reshape(-1), torch.int64)

    def make(self, J_T, diag, bc_mask, op_full, transpose=False):
        """M(r) for one assembled state: J_T (nde, nde, P * E_loc) the
        element Jacobians of every part (already swapped for a transposed
        system, whose hierarchy then belongs to the transposed operator),
        diag / bc_mask (P, N_own, ndpn), op_full the per-part operator
        with Dirichlet rows that the Krylov loop applies.  transpose=True
        mirrors the u/p sweep (p first)."""
        ctx, f = self.ctx, self.factory
        disc = ctx.disc
        d, m = disc.spec.dim, f.m
        lv1 = f.levels[0]
        n1, K1 = lv1.n, lv1.K
        mixed = disc.spec.mixed
        dtype, dev = J_T.dtype, J_T.device

        mask_all = torch.where(bc_mask, 0.0, 1.0).to(dtype) * ctx.own_mask.to(dtype)[..., None]
        mask_u = mask_all[..., :d]
        m_eT = ctx._gather_eT(mask_all)  # (nde, P * E_loc) element-dof masks

        # level-1 Galerkin blocks of every part's masked u-block Jacobians
        us = torch.as_tensor(f.uslots, device=dev)
        m_euT = m_eT[us]
        J_uu = J_T[us][:, us] * m_euT[:, None] * m_euT[None, :]
        G = element_galerkin(J_uu, self.BcT, d)
        cycle = f._u_chain(assemble_ell_T_blocks(G, self.ids, K1, n1, m))

        # fine level, per part: the node-block diagonal's u blocks
        Bu = ctx.dirichlet_blocks(ctx.node_blocks(J_T), diag, bc_mask)[..., :d, :d]
        Bu_inv = gauss_solve_pivot(Bu, torch.eye(d, dtype=dtype, device=dev).expand(Bu.shape))
        shape_u = mask_u.shape

        def embed_u(v_u):
            return torch.cat([v_u, v_u.new_zeros(v_u.shape[:-1] + (1,))], dim=-1) if mixed else v_u

        def op_u(v):  # flat (P * N_own * d,)
            return op_full(embed_u(v.view(shape_u)))[..., :d].reshape(-1)

        def fine_dinv(r):
            return torch.einsum("pnij,pnj->pni", Bu_inv, r.view(shape_u)).reshape(-1)

        lmax = power_lmax(op_u, fine_dinv, mask_u.numel(), dtype, dev, LMAX_ITERS)
        fine_smooth = chebyshev(op_u, fine_dinv, lmax, CHEB_DEGREE, CHEB_RATIO)
        mask_uf = mask_u.reshape(-1)
        agg_own = self.agg_own.reshape(-1)

        def restrict1(r):  # (P * N_own * d,) -> level 1 (n1 * m,)
            R = torch.einsum("pnqm,pnq->pnm", self.B_own, r.view(shape_u)).reshape(-1, m)
            return R.new_zeros(n1 + 1, m).index_add_(0, agg_own, R)[:n1].reshape(-1)

        def prolong1(ec):
            Ep = torch.cat([ec.reshape(n1, m), ec.new_zeros(1, m)])[self.agg_own]
            return torch.einsum("pnqm,pnm->pnq", self.B_own, Ep).reshape(-1)

        def vcycle(r_u):  # (P, N_own, d)
            r = r_u.reshape(-1)
            z = fine_smooth(r)
            ec = cycle(0, restrict1((r - op_u(z)) * mask_uf))
            z = z + OVERCORR * prolong1(ec) * mask_uf
            return (z + fine_smooth(r - op_u(z))).view(shape_u)

        if not mixed:
            return vcycle

        # -- the pressure chain: per-part fine level, level 1 summed
        ps = torch.as_tensor(f.pslots, device=dev)
        m_epT = m_eT[ps]
        J_pp = J_T[ps][:, ps] * m_epT[:, None] * m_epT[None, :]
        p_cycle = f._p_chain_from_A1(assemble_ell_T_blocks(J_pp, self.ids, K1, n1, 1))
        mask_p = mask_all[..., d].reshape(-1)
        diag_p = diag[..., d]
        app = torch.where(diag_p.abs() > 1e-300, diag_p, torch.ones_like(diag_p)).reshape(-1)
        shape_p = diag_p.shape

        def embed_p(v_p):  # (P, N_own) -> (P, N_own, ndpn)
            return torch.cat([v_p.new_zeros(v_p.shape + (d,)), v_p[..., None]], dim=-1)

        def op_p(v):
            return op_full(embed_p(v.view(shape_p)))[..., d].reshape(-1)

        def p_dinv(r):
            return r / app

        lmax_p = power_lmax(op_p, p_dinv, mask_p.numel(), dtype, dev, LMAX_ITERS)
        p_smooth = chebyshev(op_p, p_dinv, lmax_p, CHEB_DEGREE, CHEB_RATIO)

        def p_vcycle(r_p):  # (P, N_own)
            r = r_p.reshape(-1)
            z = p_smooth(r)
            rr = (r - op_p(z)) * mask_p
            ec = p_cycle(0, rr.new_zeros(n1 + 1).index_add_(0, agg_own, rr)[:n1])
            z = z + OVERCORR * torch.cat([ec, ec.new_zeros(1)])[agg_own] * mask_p
            return (z + p_smooth(r - op_p(z))).view(shape_p)

        if transpose:

            def M(r):
                z_p = p_vcycle(r[..., d])
                z_u = vcycle((r - op_full(embed_p(z_p)))[..., :d])
                return torch.cat([z_u, z_p[..., None]], dim=-1)

        else:

            def M(r):
                z_u = vcycle(r[..., :d])
                z_p = p_vcycle((r - op_full(embed_u(z_u)))[..., d])
                return torch.cat([z_u, z_p[..., None]], dim=-1)

        return M
