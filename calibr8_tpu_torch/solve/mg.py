"""Geometric multigrid preconditioner on the nested refinement hierarchy.

The counterpart of calibr8_tpu's solve/mg.py (the analog of the
reference's MueLu AMG inside the Teko block preconditioner,
linear_solve.cpp:36-123).  When the solve mesh was made by uniform
refinement (mesh/refine.py, `refinements:` in the deck), the refinement
chain is the hierarchy.  The cycle is a fixed linear operator, so plain
right-preconditioned GMRES can use it.

* 1-2 refinements: the composite two-level cycle.  All levels fold into
  one P1 interpolation to the base mesh; the coarse operator is the
  Galerkin product (MP)^T A_uu (MP) of the Dirichlet-masked fine element
  blocks, assembled per base element; damped node-block Jacobi pre- and
  post-smoothing; a dense LU coarse solve.
* 3 or more: the recursive V-cycle, level by level.  The Galerkin product
  of element blocks through P1 interpolation stays element-blockwise on
  the parent mesh, so each level's operator is assembled from element
  blocks into a node-block ELL matrix (LevelEllOperator, kernel 3c on the
  card); Chebyshev smoothing (degree 6, ratio 12) with node-block Jacobi
  inside; dense LU on the base mesh.  A mixed u/p system gets a scalar
  pressure chain through the same transfers, its fine block applied
  through LevelEllOperator at m = 1 too.

Both act on the displacement block inside the u/p block Gauss-Seidel
sweep (mixed_wrap; the recursive form sweeps with the full operator),
mirrored for the transposed (adjoint) systems, whose element blocks
arrive already swapped (solve/linear.py).

Not carried over: the jit-argument hoisting (hoist_args / bind), the
code-size knobs (CALIBR8_MG_ABLATE, CALIBR8_MG_CHEB_DEGREE,
CALIBR8_MG_LEVEL_ELL: the port always uses the ELL level form), the
Newton-Schulz coarse inverse (a TPU workaround; calibr8_tpu itself uses
LU off the TPU, mg.py:46-82) and the loop-unrolling guards.  None of them
changes a result.
"""

from __future__ import annotations

import numpy as np
import torch

from calibr8_tpu_torch.solve.amg import chebyshev, power_lmax
from calibr8_tpu_torch.solve.ellpack import LevelEllOperator, build_ell_maps, ell_device_maps
from calibr8_tpu_torch.solve.precond import node_block_diagonal
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_pivot


# the damping of the composite cycle's Jacobi smoother, and the degree and
# eigenvalue ratio of the recursive cycle's Chebyshev smoothers
# (calibr8_tpu mg.py:372, :676-677)
OMEGA = 0.7
CHEB_DEGREE = 6
CHEB_RATIO = 12.0


def _lu_apply(st):
    """The coarse solve from torch.linalg.lu_factor's (LU, pivots)."""
    LU, piv = st
    return lambda b: torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]


def _inverse_blocks(B):
    """(n, m, m) -> the inverse of each block (pivoted Gauss-Jordan)."""
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device).expand(B.shape)
    return gauss_solve_pivot(B, eye.contiguous())


def _block_apply(Binv, r, m):
    """Node-block products Binv[n] @ r[n] on a node-interleaved vector."""
    return torch.einsum("nij,nj->ni", Binv, r.reshape(-1, m)).reshape(-1)


def _dense_from_blocks(JT, conn, n_nodes, m):
    """Element blocks (npe*m, npe*m, E) on conn -> the dense assembled
    matrix (n_nodes*m)^2, with unit diagonal entries where the diagonal
    is below 1e-12 (rows the Dirichlet masks emptied)."""
    nm = n_nodes * m
    edofs = (conn[:, :, None] * m + torch.arange(m, device=conn.device)).reshape(conn.shape[0], -1)
    flat = (edofs[:, :, None] * nm + edofs[:, None, :]).reshape(-1)
    A = torch.zeros(nm * nm, dtype=JT.dtype, device=JT.device)
    A.index_add_(0, flat, JT.permute(2, 0, 1).reshape(-1))
    A = A.reshape(nm, nm)
    dg = torch.diagonal(A)
    return A + torch.diag((dg.abs() < 1e-12).to(A.dtype))


def composite_parents(refine_chain):
    """Compose the per-level (node -> 2 parents, weight 1/2) maps of a
    refinement chain into base-level interpolation rows: (idx (n_fine, K),
    w (n_fine, K)), K = 2^levels; duplicate columns add."""
    n_base = int(refine_chain[0].node_parents.max()) + 1
    idx = np.arange(n_base, dtype=np.int64)[:, None]
    w = np.ones((n_base, 1))
    for r in refine_chain:
        pa, pb = r.node_parents[:, 0], r.node_parents[:, 1]
        idx = np.concatenate([idx[pa], idx[pb]], axis=1)
        w = np.concatenate([0.5 * w[pa], 0.5 * w[pb]], axis=1)
    return idx, w


def fine_u_setup(disc, J_T, diag, bc_dofs, op, uslots):
    """Fine-level displacement-block pieces (calibr8_tpu mg.py:118-291):
    the masked u-block element Jacobians, the u-block apply op_u (the
    full operator `op` on [v; 0], truncated), the node-block Jacobi
    inverses with the Dirichlet rows replaced as in BlockJacobiGS, the
    damped Jacobi smoother, the Dirichlet u-mask and the u/p coupling
    blocks of the block Gauss-Seidel sweep."""
    d = disc.spec.dim
    n_u = disc.n_dofs_u
    mixed = disc.spec.mixed
    dtype, dev = J_T.dtype, J_T.device
    us = torch.as_tensor(uslots, device=dev)
    J_uuT = J_T[us][:, us]  # (nde_u, nde_u, E)

    blocks = node_block_diagonal(disc, J_T)  # (n_nodes, ndpn, ndpn)
    D = disc.nodemat(diag)
    bc_mask = torch.zeros(disc.n_dofs, dtype=torch.bool, device=dev)
    bc_mask[bc_dofs] = True
    rowsel = disc.nodemat(bc_mask.to(dtype))[:, :, None]
    eye = torch.eye(disc.ndpn, dtype=dtype, device=dev)
    blocks = blocks * (1.0 - rowsel) + rowsel * eye[None] * D[:, :, None]
    Bu_inv = _inverse_blocks(blocks[:, :d, :d].contiguous())
    if mixed:
        Apu, Aup, app = blocks[:, d, :d], blocks[:, :d, d], blocks[:, d, d]
        app = torch.where(app.abs() > 1e-300, app, torch.ones_like(app))
    else:
        Apu = Aup = app = None

    n_p = disc.n_dofs - n_u

    def op_u(v):
        # the p columns see zeros, the p rows are dropped
        return op(torch.cat([v, v.new_zeros(n_p)]))[:n_u]

    bc_u = bc_mask[:n_u]
    mask_u = torch.where(bc_u, 0.0, 1.0).to(dtype)
    m_eT = mask_u.reshape(disc.n_nodes, d)[disc.conn].reshape(disc.n_elem, -1).T  # (nde_u, E)

    def smooth(r):
        return OMEGA * _block_apply(Bu_inv, r, d)

    return dict(J_uuT=J_uuT, J_mask=J_uuT * m_eT[:, None] * m_eT[None, :], op_u=op_u,
                smooth=smooth, Bu_inv=Bu_inv, Apu=Apu, Aup=Aup, app=app, mask_u=mask_u,
                m_eT=m_eT, bc_mask=bc_mask)


def mixed_wrap(disc, vcycle, fu, transpose=False):
    """The u-block cycle inside the u/p block Gauss-Seidel sweep:
    z_u = cycle(r_u); z_p = app^-1 (r_p - A_pu z_u).  transpose=True
    mirrors the sweep (p first, u corrected through the up-coupling), the
    analog of the transposed block GS the adjoint systems need; the
    element blocks in `fu` already belong to the transposed operator."""
    d, n_u = disc.spec.dim, disc.n_dofs_u
    if not disc.spec.mixed:
        return vcycle
    Apu, Aup, app = fu["Apu"], fu["Aup"], fu["app"]
    if transpose:

        def M(r):
            z_p = r[n_u:] / app
            Ru = r[:n_u].reshape(disc.n_nodes, d) - Aup * z_p[:, None]
            return torch.cat([vcycle(Ru.reshape(-1)), z_p])

        return M

    def M(r):
        z_u = vcycle(r[:n_u])
        r_p = r[n_u:] - (Apu * z_u.reshape(disc.n_nodes, d)).sum(dim=1)
        return torch.cat([z_u, r_p / app])

    return M


def _pair_p_loc(child_conn, parent_conn, node_parents, elem_parent):
    """Per-child-element node interpolation (n_e, npe, npe):
    P[e, l, m] = weight of parent local node m in child local node l."""
    n_e, npe = child_conn.shape
    P = np.zeros((n_e, npe, npe))
    pc = parent_conn[elem_parent]  # (n_e, npe)
    for l in range(npe):
        for k in range(2):
            cn = node_parents[child_conn[:, l], k]
            hit = pc == cn[:, None]  # (n_e, npe)
            if not hit.any(axis=1).all():
                raise AssertionError("parent node escaped parent element")
            np.add.at(P, (np.arange(n_e), l, hit.argmax(axis=1)), 0.5)
    return P


def _row_perm(conn, fine_conn):
    """perm with fine_conn[perm[k]] == conn[k]: the Disc's element order
    (sorted by element set) back to the chain's."""
    a = np.lexsort(np.asarray(conn).T[::-1])
    b = np.lexsort(np.asarray(fine_conn).T[::-1])
    perm = np.empty(len(a), dtype=np.int64)
    perm[a] = b
    if not np.array_equal(np.asarray(fine_conn)[perm], np.asarray(conn)):
        raise ValueError("the Disc's elements are not the refinement chain's")
    return perm


class MGPrecondFactory:
    """Per-problem multigrid setup (on the host, once); make() builds the
    preconditioner for one assembled Jacobian, make_state() the heavy
    per-Jacobian arrays of the recursive cycle for `precond reuse: step`.

    refine_chain: the Refinements from the base mesh to the Disc's mesh;
    base_mesh: the unrefined mesh."""

    def __init__(self, disc, refine_chain, base_mesh):
        self.disc = disc
        spec = disc.spec
        d, npe, ndpn = spec.dim, spec.npe, spec.ndofs_per_node
        self.d = d
        dev = disc.device
        # u-block slots within the node-interleaved element dof vector
        self.uslots = np.array([l * ndpn + q for l in range(npe) for q in range(d)])
        conn = np.asarray(disc.mesh.conn)
        self.recursive = len(refine_chain) >= 3
        perm = _row_perm(conn, refine_chain[-1].fine.conn)
        if self.recursive:
            self._build_pair_levels(refine_chain, base_mesh, perm)
            return

        idx, w = composite_parents(refine_chain)
        if idx.shape[0] != disc.n_nodes:
            raise ValueError(f"hierarchy fine nodes {idx.shape[0]} != disc nodes {disc.n_nodes}")
        self.K = idx.shape[1]
        self.n_c = int(idx.max()) + 1
        self.n_cu = self.n_c * d
        self.parents_idx = torch.as_tensor(idx, device=dev)  # (n_f, K)
        self.parents_w = torch.as_tensor(w, dtype=disc.dtype, device=dev)

        # every fine element's Galerkin contribution lands in its BASE
        # parent element's block: the local interpolation P_loc from the
        # fine element's u slots to the base parent's
        ep = refine_chain[-1].elem_parent
        for r in reversed(refine_chain[:-1]):
            ep = r.elem_parent[ep]
        base_parent = ep[perm]
        base_conn = np.asarray(base_mesh.conn)
        E, nde_u = disc.n_elem, npe * d
        P_loc = np.zeros((E, nde_u, nde_u))
        bpc = base_conn[base_parent]  # (E, npe)
        for l in range(npe):
            for k in range(self.K):
                cnode = idx[conn[:, l], k]
                wk = w[conn[:, l], k]
                hit = bpc == cnode[:, None]
                ok = hit.any(axis=1)
                if not np.all(ok | (wk == 0.0)):
                    raise AssertionError("composite parent escaped the base element")
                pos = hit.argmax(axis=1)
                for q in range(d):
                    np.add.at(P_loc, (np.arange(E), l * d + q, pos * d + q), np.where(ok, wk, 0.0))
        self.P_locT = torch.as_tensor(np.moveaxis(P_loc, 0, -1), dtype=disc.dtype, device=dev)
        self.base_parent = torch.as_tensor(base_parent, device=dev)
        self.n_ce = base_conn.shape[0]
        self.cdofs = torch.as_tensor(
            (base_conn[:, :, None] * d + np.arange(d)).reshape(self.n_ce, nde_u), device=dev)

    def _build_pair_levels(self, refine_chain, base_mesh, perm):
        """Host maps of the recursive hierarchy, one entry per adjacent
        level pair (child -> parent), finest first (calibr8_tpu
        mg.py:540-600); each with the parent mesh's ELL maps."""
        disc = self.disc
        dev = disc.device
        L = len(refine_chain)
        pairs = []
        for l in range(L):
            r = refine_chain[L - 1 - l]
            if l == 0:
                child_conn = np.asarray(disc.mesh.conn)
                elem_parent = np.asarray(r.elem_parent)[perm]
            else:
                child_conn = np.asarray(r.fine.conn)
                elem_parent = np.asarray(r.elem_parent)
            parent_mesh = refine_chain[L - 2 - l].fine if L - 2 - l >= 0 else base_mesh
            parent_conn = np.asarray(parent_mesh.conn)
            node_parents = np.asarray(r.node_parents)
            P_n = _pair_p_loc(child_conn, parent_conn, node_parents, elem_parent)
            n_pe = parent_conn.shape[0]
            k = len(elem_parent) // max(n_pe, 1)
            # uniform refinement emits children grouped by parent: the
            # child reduce is then a reshape-sum
            grouped = len(elem_parent) == n_pe * k and np.array_equal(
                elem_parent, np.repeat(np.arange(n_pe), k))
            pairs.append(dict(
                P_nT=torch.as_tensor(np.moveaxis(P_n, 0, -1), dtype=disc.dtype, device=dev),
                group_k=k if grouped else None,
                elem_parent=torch.as_tensor(elem_parent, device=dev),
                pa=torch.as_tensor(node_parents[:, 0], device=dev),
                pb=torch.as_tensor(node_parents[:, 1], device=dev),
                parent_conn=torch.as_tensor(parent_conn, device=dev),
                n_parent_nodes=parent_mesh.n_nodes,
                n_parent_elems=n_pe,
                maps=ell_device_maps(parent_conn, parent_mesh.n_nodes, dev),
            ))
        self._pairs = pairs

    # -- the recursive cycle ---------------------------------------------
    def _reduce_child(self, pr, G):
        """(..., E_child) -> (..., E_parent), summed over each parent's
        children."""
        k = pr["group_k"]
        if k is not None:
            return G.reshape(*G.shape[:-1], -1, k).sum(-1)
        out = G.new_zeros(*G.shape[:-1], pr["n_parent_elems"])
        return out.index_add_(G.dim() - 1, pr["elem_parent"], G)

    def _galerkin(self, JT, pr, m):
        """Galerkin blocks of one pair: element blocks JT (npe*m, npe*m,
        E_child) through the child's node interpolation P (npe, npe,
        E_child), summed onto the parents: G[c m + q, dd m + r] =
        sum_{l, k} P[l, c] J[l m + q, k m + r] P[k, dd]."""
        npe = self.disc.spec.npe
        P = pr["P_nT"]
        J5 = JT.reshape(npe, m, npe, m, -1)
        H = torch.einsum("lqkre,kde->lqdre", J5, P)
        G = torch.einsum("lce,lqdre->cqdre", P, H)
        return self._reduce_child(pr, G.reshape(npe * m, npe * m, -1))

    def _node_diag(self, JT, pr, m):
        """Assembled node-diagonal blocks (n, m, m) of level blocks JT."""
        npe = self.disc.spec.npe
        conn = pr["parent_conn"]
        J5 = JT.reshape(npe, m, npe, m, -1)
        rows = torch.stack([J5[l, :, l] for l in range(npe)])  # (npe, m, m, E)
        out = JT.new_zeros(pr["n_parent_nodes"], m, m)
        return out.index_add_(0, conn.T.reshape(-1), rows.permute(0, 3, 1, 2).reshape(-1, m, m))

    def _level(self, pr, m, JT=None, st=None):
        """One coarse level's operator and Chebyshev smoother (m = dim: the
        u chain, node-block Jacobi inside; m = 1: the p chain, point
        Jacobi).  With JT the per-Jacobian arrays (assembled ELL values,
        the Jacobi inverse, lmax) are computed and returned; with st they
        are taken from there."""
        if st is None:
            st = dict(A_T=LevelEllOperator(JT, pr["maps"], pr["n_parent_nodes"], m).A_T)
            dg = self._node_diag(JT, pr, m)
            if m == 1:
                dgv = dg[:, 0, 0]
                st["dinv"] = torch.where(dgv.abs() > 1e-30, dgv, torch.ones_like(dgv))
            else:
                fix = (torch.diagonal(dg, dim1=1, dim2=2).abs() < 1e-30).to(dg.dtype)
                st["dinv"] = _inverse_blocks(
                    dg + fix[:, :, None] * torch.eye(m, dtype=dg.dtype, device=dg.device))
        op_l = LevelEllOperator.from_assembled(st["A_T"], pr["maps"], m)
        if m == 1:
            dgv = st["dinv"]

            def dinv(r):
                return r / dgv

        else:
            Binv = st["dinv"]

            def dinv(r):
                return _block_apply(Binv, r, m)

        if "lmax" not in st:
            st["lmax"] = power_lmax(op_l, dinv, pr["n_parent_nodes"] * m, st["A_T"].dtype,
                                    st["A_T"].device)
        return op_l, chebyshev(op_l, dinv, st["lmax"], CHEB_DEGREE, CHEB_RATIO), st

    def _chain(self, J0, m, state):
        """Level operators, smoothers and base LU of one chain (u: m = dim,
        p: m = 1) from the masked fine element blocks J0, or from `state`
        (its per-level dicts and base LU).  Returns (levels, coarse LU,
        new state)."""
        pairs = self._pairs
        L = len(pairs)
        if state is not None:
            levels = [self._level(pairs[l], m, st=state["levels"][l])[:2] for l in range(L - 1)]
            return levels, state["base"], state
        levels, states, J_l = [], [], J0
        for l in range(L):
            J_l = self._galerkin(J_l, pairs[l], m)
            if l < L - 1:
                op_l, smooth_l, st_l = self._level(pairs[l], m, JT=J_l)
                levels.append((op_l, smooth_l))
                states.append(st_l)
        pr = pairs[-1]
        base = torch.linalg.lu_factor(
            _dense_from_blocks(J_l, pr["parent_conn"], pr["n_parent_nodes"], m))
        return levels, base, dict(levels=states, base=base)

    def _vcycle(self, m, levels, coarse, op_f, smooth_f, mask):
        """The V-cycle of one chain: fine smoothing on op_f (residual
        masked by the Dirichlet rows before restriction, correction masked
        after prolongation), then level by level down to the dense base."""
        pairs = self._pairs
        L = len(pairs)

        def restrict(pr, r):
            R = 0.5 * r.reshape(-1, m)
            out = R.new_zeros(pr["n_parent_nodes"], m)
            return out.index_add_(0, pr["pa"], R).index_add_(0, pr["pb"], R).reshape(-1)

        def prolong(pr, e):
            E = e.reshape(-1, m)
            return (0.5 * (E[pr["pa"]] + E[pr["pb"]])).reshape(-1)

        def cycle(l, r):
            if l == L:
                return coarse(r)
            op_l, smooth_l = levels[l - 1]
            z = smooth_l(r)
            ec = cycle(l + 1, restrict(pairs[l], r - op_l(z)))
            z = z + prolong(pairs[l], ec)
            return z + smooth_l(r - op_l(z))

        def vcycle(r):
            z = smooth_f(r)
            ec = cycle(1, restrict(pairs[0], (r - op_f(z)) * mask))
            z = z + prolong(pairs[0], ec) * mask
            return z + smooth_f(r - op_f(z))

        return vcycle

    def _make_recursive(self, J_T, diag, bc_dofs, op, transpose, state):
        """The recursive V-cycle (calibr8_tpu mg.py:602-1260); returns
        (M, state) where state holds the per-Jacobian arrays: the level
        ELL values, Jacobi inverses and lmax of both chains, the base LUs,
        the fine lmax bounds and the fine pressure block's ELL values."""
        disc = self.disc
        d, npe, n_u = self.d, disc.spec.npe, disc.n_dofs_u
        fu = fine_u_setup(disc, J_T, diag, bc_dofs, op, self.uslots)
        dtype, dev = J_T.dtype, J_T.device
        new = {}
        levels, base, new["u"] = self._chain(fu["J_mask"], d, None if state is None else state["u"])
        Bu_inv = fu["Bu_inv"]

        def fine_dinv(r):
            return _block_apply(Bu_inv, r, d)

        new["lmax_f"] = (state["lmax_f"] if state is not None
                         else power_lmax(fu["op_u"], fine_dinv, n_u, dtype, dev))
        fine_smooth = chebyshev(fu["op_u"], fine_dinv, new["lmax_f"], CHEB_DEGREE, CHEB_RATIO)
        vcycle = self._vcycle(d, levels, _lu_apply(base), fu["op_u"], fine_smooth, fu["mask_u"])
        if not disc.spec.mixed:
            return mixed_wrap(disc, vcycle, fu, transpose), new

        # -- the scalar pressure chain through the same transfers --------
        ps = torch.as_tensor([l * disc.ndpn + d for l in range(npe)], device=dev)
        J_pp = J_T[ps][:, ps]  # (npe, npe, E)
        bc_p = fu["bc_mask"][n_u:]
        diag_p = diag[n_u:]
        mask_p = torch.where(bc_p, 0.0, 1.0).to(dtype)
        m_peT = mask_p[disc.conn].T
        p_levels, p_base, new["p"] = self._chain(J_pp * m_peT[:, None] * m_peT[None, :], 1,
                                                 None if state is None else state["p"])
        # the fine pressure block through the Disc's ELL maps at m = 1
        maps_f = build_ell_maps(disc)
        if state is not None:
            p_ell = LevelEllOperator.from_assembled(state["p_ell_A_T"], maps_f, 1)
        else:
            p_ell = LevelEllOperator(J_pp, maps_f, disc.n_nodes, 1)
        new["p_ell_A_T"] = p_ell.A_T

        def op_p(v):
            return torch.where(bc_p, diag_p * v, p_ell(v))

        app = torch.where(diag_p.abs() > 1e-300, diag_p, torch.ones_like(diag_p))

        def p_dinv(r):
            return r / app

        new["lmax_p"] = (state["lmax_p"] if state is not None
                         else power_lmax(op_p, p_dinv, disc.n_dofs - n_u, dtype, dev))
        p_smooth = chebyshev(op_p, p_dinv, new["lmax_p"], CHEB_DEGREE, CHEB_RATIO)
        p_vcycle = self._vcycle(1, p_levels, _lu_apply(p_base), op_p, p_smooth, mask_p)

        # block Gauss-Seidel over (u, p) with the exact coupling of the
        # full operator; mirrored for the transposed systems
        if transpose:

            def M(r):
                z_p = p_vcycle(r[n_u:])
                r_u = (r - op(torch.cat([z_p.new_zeros(n_u), z_p])))[:n_u]
                return torch.cat([vcycle(r_u), z_p])

        else:

            def M(r):
                z_u = vcycle(r[:n_u])
                r_p = (r - op(torch.cat([z_u, z_u.new_zeros(disc.n_dofs - n_u)])))[n_u:]
                return torch.cat([z_u, p_vcycle(r_p)])

        return M, new

    # -- the composite two-level cycle -------------------------------------
    def prolong_u(self, xc, mask_u):
        """Coarse u vector (n_cu,) -> fine u vector (n_dofs_u,)."""
        Xc = xc.reshape(self.n_c, self.d)
        Xf = torch.einsum("fk,fkc->fc", self.parents_w, Xc[self.parents_idx])
        return Xf.reshape(-1) * mask_u

    def restrict_u(self, rf, mask_u):
        Rf = (rf * mask_u).reshape(self.disc.n_nodes, self.d)
        Rc = Rf.new_zeros(self.n_c, self.d)
        for k in range(self.K):
            Rc.index_add_(0, self.parents_idx[:, k], self.parents_w[:, k, None] * Rf)
        return Rc.reshape(-1)

    def _make_composite(self, J_T, diag, bc_dofs, op, transpose):
        fu = fine_u_setup(self.disc, J_T, diag, bc_dofs, op, self.uslots)
        op_u, smooth, mask_u = fu["op_u"], fu["smooth"], fu["mask_u"]
        nde_u, n_cu = len(self.uslots), self.n_cu
        # Galerkin coarse operator of the Dirichlet-masked u block, per
        # base element: P_e^T (M J_e M) P_e, then assembled
        WmT = self.P_locT * fu["m_eT"][:, None, :]  # (i, c, E)
        T1 = torch.einsum("ice,ije->cje", WmT, fu["J_uuT"])
        A_eT = torch.einsum("cje,jde->cde", T1, WmT)
        A_blocks = A_eT.new_zeros(self.n_ce, nde_u * nde_u).index_add_(
            0, self.base_parent, A_eT.reshape(nde_u * nde_u, -1).T)
        flat = (self.cdofs[:, :, None] * n_cu + self.cdofs[:, None, :]).reshape(-1)
        A_c = A_blocks.new_zeros(n_cu * n_cu).index_add_(0, flat, A_blocks.reshape(-1))
        A_c = A_c.reshape(n_cu, n_cu)
        # regularize empty rows (coarse dofs fully under Dirichlet masks)
        A_c = A_c + torch.diag((torch.diagonal(A_c).abs() < 1e-12).to(A_c.dtype))
        coarse_solve = _lu_apply(torch.linalg.lu_factor(A_c))

        def vcycle(r):
            z = smooth(r)
            ec = coarse_solve(self.restrict_u(r - op_u(z), mask_u))
            z = z + self.prolong_u(ec, mask_u)
            return z + smooth(r - op_u(z))

        return mixed_wrap(self.disc, vcycle, fu, transpose)

    # -- per-Jacobian construction -------------------------------------------
    def make_state(self, J_T, diag, bc_dofs, op, transpose=False):
        """The recursive cycle's per-Jacobian arrays, to be passed back to
        make(state=...) while they lag behind the Jacobian (`precond
        reuse: step`); None for the composite cycle, whose make() is one
        Galerkin pass."""
        if not self.recursive:
            return None
        return self._make_recursive(J_T, diag, bc_dofs, op, transpose, None)[1]

    def make(self, J_T, diag, bc_dofs, op, transpose=False, state=None):
        """The preconditioner z = M r for one assembled Jacobian: J_T
        (nde, nde, E) element Jacobians (already swapped for a transposed
        system), `op` the full operator (Dirichlet rows included), which
        gives the fine u-block apply and the u/p coupling; `state` from
        make_state short-circuits the coarse arrays (recursive only)."""
        if self.recursive:
            return self._make_recursive(J_T, diag, bc_dofs, op, transpose, state)[0]
        return self._make_composite(J_T, diag, bc_dofs, op, transpose)
