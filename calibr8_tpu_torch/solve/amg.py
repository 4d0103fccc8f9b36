"""Aggregation-based algebraic multigrid for unstructured meshes.

The counterpart of calibr8_tpu's solve/amg.py (the analog of the
reference's MueLu AMG with a node-coordinates nullspace inside the Teko
block preconditioner, linear_solve.cpp:36-123).  The geometric multigrid
(solve/mg.py) needs a `refinements:` chain; this hierarchy is built from
the element connectivity and the node coordinates alone, so it serves
any mesh.  `preconditioner: amg`, and `preconditioner: multigrid` on a
mesh without a refinement chain, route here (problem.py).

* Setup, on the host, once per mesh, with the same numpy operations as
  calibr8_tpu, so that the aggregates, the coarse graphs and the transfer
  blocks are the same bit for bit: Vanek's plain aggregation (pass 1 in
  BFS order, pass 2 to the smallest neighbouring aggregate under a size
  cap) of the node graph, then of each coarse level's graph, until the
  coarsest u space has at most `coarse_cutoff` dofs.
* Transfers: rigid-body modes.  An aggregate carries m = d(d+1)/2 dofs
  (translations and rotations scaled by its RMS radius); level 1
  interpolates with the rigid-body basis B at each node's offset from its
  aggregate's centroid, coarser levels with the rigid transport T between
  centroids.  The pressure chain uses the same aggregates with the
  constant nullspace (m = 1).
* Level operators: Galerkin products, B^T J B of the Dirichlet-masked
  u-block element Jacobians into level 1, T^T A T into each coarser
  level, each one index_add_ (calibr8_tpu's segment_sum) into the node-
  block ELL layout of the port, slot-major A_T (K, m, m, n) with nbr_T
  (K, n) int32, pad id n.  Their apply is kernel 3c, the ell_spmv
  kernel's (m, m) instance (solve/ellpack.py level_ell_spmv, counted as
  `ell_spmv_level`): (6, 6) and (3, 3) for the 3D and 2D rigid modes,
  (1, 1) for the pressure chain.
* Smoothing: Chebyshev (degree 6, ratio 12) on D^-1 A with the
  node-block diagonal inverted, pre and post, on an lmax estimate of
  LMAX_ITERS power iterations (calibr8_tpu: 10, which stalls GMRES at
  full width); the coarsest level is a dense LU solve; W-cycle (gamma 2).  The cycle is a fixed linear
  operator, valid for plain right-preconditioned GMRES.
* The u/p mixed case: block Gauss-Seidel over (u, p) through the full
  operator, with a u cycle and a p cycle, mirrored (p first) for the
  transposed (adjoint) systems, whose element blocks arrive swapped.

parallel/dist_mg.py runs the same hierarchy under the domain-decomposed
solver: its fine level per part, levels >= 1 through this factory's
_u_chain / _p_chain_from_A1.

Not carried over: the loop-bound guards (_dyn_bound), the jit-argument
hoisting (hoist_args / bind) and the TPU tile-padding layouts, which
serve XLA on the TPU; and the damped-Jacobi smoother option and the
knobs (omega, overcorr, smoother, cheb_degree, cheb_ratio, gamma) that
no caller sets, which are module constants here.  None of them changes
a result.  calibr8_tpu's Chebyshev loop also updates the residual after
its last step, which nothing reads; that product is not made here.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from calibr8_tpu_torch.solve.ellpack import (
    LevelEllOperator, assemble_ell_T_blocks, assemble_slots, build_ell_maps, level_ell_spmv,
)

# the Chebyshev smoother's degree and eigenvalue ratio, the cycle's
# recursion count (2: W-cycle) and the coarse correction's weight
# (calibr8_tpu amg.py:345-356, which no caller changes)
CHEB_DEGREE = 6
CHEB_RATIO = 12.0
GAMMA = 2
OVERCORR = 1.0
# power iterations of the lmax(D^-1 A) estimate behind each Chebyshev
# smoother.  calibr8_tpu takes 10 (amg.py:251), which underestimates lmax
# more the larger the mesh: on the bench deck (cube n=32) 10 iterations
# give 1.58 and 1.42 for the fine u and p blocks, whose lmax is ~2.00 and
# ~1.93 (300 iterations), so the smoothers' interval [lmax / 12, 1.1 lmax]
# leaves the top of the spectrum out, the Chebyshev polynomial amplifies
# it there, and GMRES stalls (relres 0.79 after 200 iterations, in both
# packages).  50 iterations put 1.1 lmax above it on the full-width decks
# (ROADMAP queue 3; PERF.md section 6).
LMAX_ITERS = 50


def power_lmax(matvec, dinv_apply, n: int, dtype, device, iters: int = 10) -> float:
    """Largest eigenvalue estimate of D^-1 A by `iters` power iterations
    from calibr8_tpu's deterministic start sin(12.9898 i + 0.5)
    (amg.py:251 _power_lmax), then one more product."""
    v = torch.sin(torch.arange(n, dtype=dtype, device=device) * 12.9898 + 0.5)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = dinv_apply(matvec(v))
        v = w / torch.linalg.vector_norm(w).clamp(min=1e-30)
    w = dinv_apply(matvec(v))
    return max(float(torch.linalg.vector_norm(w)), 1e-12)


def chebyshev(matvec, dinv_apply, lmax: float, degree: int = 6, ratio: float = 12.0):
    """Chebyshev smoother of the given degree on [lmax / ratio, 1.1 lmax]
    of D^-1 A (amg.py:269 _chebyshev): degree products with A per call."""
    beta = 1.1 * lmax
    alpha = lmax / ratio
    theta = 0.5 * (beta + alpha)
    delta = 0.5 * (beta - alpha)
    sigma = theta / delta

    def smooth(b):
        x = dinv_apply(b) / theta
        r = b - matvec(x)
        d, rho = x, 1.0 / sigma
        for k in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * dinv_apply(r)
            x = x + d
            if k < degree - 2:
                r = r - matvec(d)
            rho = rho_new
        return x

    return smooth


# ---------------------------------------------------------------------
# host setup (numpy; calibr8_tpu amg.py:65-231, the same operations)
# ---------------------------------------------------------------------


def node_graph(conn, n_nodes):
    """Undirected node adjacency (no self loops) as CSR (cols, ptr)."""
    npe = conn.shape[1]
    pairs = []
    for a in range(npe):
        for b in range(npe):
            if a != b:
                pairs.append(conn[:, a].astype(np.int64) * n_nodes + conn[:, b])
    key = np.unique(np.concatenate(pairs))
    rows = key // n_nodes
    cols = (key % n_nodes).astype(np.int32)
    ptr = np.searchsorted(rows, np.arange(n_nodes + 1))
    return cols, ptr


def aggregate(cols, ptr, n):
    """Greedy plain aggregation (Vanek pass 1 + pass 2) with BFS seed
    ordering and a size cap.  Pass 1 forms root aggregates {i} + nbrs(i)
    over the nodes whose whole neighbourhood is unaggregated, in BFS
    order; pass 2 attaches each leftover to its smallest neighbouring
    aggregate under the cap 1.5 (mean degree + 1) (the smallest of them
    when all are at the cap).  Returns (agg (n,), n_agg)."""
    agg = np.full(n, -1, dtype=np.int64)
    deg = np.diff(ptr)
    max_size = max(int(1.5 * (deg.mean() + 1.0)), 4)

    # BFS order over all components
    order = np.empty(n, dtype=np.int64)
    seen = np.zeros(n, dtype=bool)
    pos = 0
    for s in range(n):
        if seen[s]:
            continue
        seen[s] = True
        q = deque([s])
        while q:
            i = q.popleft()
            order[pos] = i
            pos += 1
            for j in cols[ptr[i]: ptr[i + 1]]:
                if not seen[j]:
                    seen[j] = True
                    q.append(j)

    sizes = []
    n_agg = 0
    for i in order:
        if agg[i] != -1:
            continue
        nb = cols[ptr[i]: ptr[i + 1]]
        if np.all(agg[nb] == -1):
            agg[i] = n_agg
            agg[nb] = n_agg
            sizes.append(1 + len(nb))
            n_agg += 1
    for i in order:
        if agg[i] != -1:
            continue
        cand = np.unique(agg[cols[ptr[i]: ptr[i + 1]]])
        cand = cand[cand >= 0]
        if cand.size:
            csz = np.array([sizes[c] for c in cand])
            under = cand[csz < max_size]
            pick = under[np.argmin(csz[csz < max_size])] if under.size else cand[np.argmin(csz)]
            agg[i] = pick
            sizes[pick] += 1
        else:  # isolated node
            agg[i] = n_agg
            sizes.append(1)
            n_agg += 1
    return agg, n_agg


def _ell_structure(keys, n_rows):
    """Sorted unique (row * n_rows + col) keys -> the padded ELL pattern:
    (nbr (n_rows, K) int32 with pad n_rows, the slot-major position
    slot * n_rows + row of each key, K).  calibr8_tpu's returns the
    row-major position row * K + slot."""
    rows = keys // n_rows
    row_start = np.searchsorted(rows, np.arange(n_rows))
    slot = np.arange(len(keys)) - row_start[rows]
    K = int(slot.max()) + 1 if len(keys) else 1
    nbr = np.full((n_rows, K), n_rows, dtype=np.int32)
    nbr[rows, slot] = (keys % n_rows).astype(np.int32)
    return nbr, (slot * n_rows + rows).astype(np.int64), K


def _centroids_scales(agg, n_agg, pos):
    """Aggregate centroids and RMS radii (the rotation-mode scaling)."""
    cnt = np.bincount(agg, minlength=n_agg).astype(np.float64)
    cent = np.zeros((n_agg, pos.shape[1]))
    for q in range(pos.shape[1]):
        cent[:, q] = np.bincount(agg, weights=pos[:, q], minlength=n_agg)
    cent /= cnt[:, None]
    r2 = np.bincount(agg, weights=np.sum((pos - cent[agg]) ** 2, axis=1), minlength=n_agg) / cnt
    scale = np.sqrt(np.maximum(r2, 0.0))
    scale = np.where(scale > 1e-12, scale, 1.0)
    return cent, scale


def _rigid_modes(rel, scale, d):
    """Rigid-body basis B (n, d, m) at offsets `rel` (n, d) from the
    aggregate centroid, rotations scaled by 1/scale (n,)."""
    n = rel.shape[0]
    m = d * (d + 1) // 2
    B = np.zeros((n, d, m))
    for q in range(d):
        B[:, q, q] = 1.0
    if d == 2:
        B[:, 0, 2] = -rel[:, 1] / scale
        B[:, 1, 2] = rel[:, 0] / scale
    else:
        # rotations about x, y, z: theta x r
        x, y, z = rel[:, 0], rel[:, 1], rel[:, 2]
        B[:, 1, 3] = -z / scale
        B[:, 2, 3] = y / scale
        B[:, 0, 4] = z / scale
        B[:, 2, 4] = -x / scale
        B[:, 0, 5] = -y / scale
        B[:, 1, 5] = x / scale
    return B


def _rigid_transforms(rel, s_child, S_parent, d):
    """Rigid-motion transport T (n, m, m): parent aggregate dofs
    (translations, rotations scaled by S_parent) -> child dofs at
    centroid offset `rel`, rotations scaled by s_child."""
    n = rel.shape[0]
    m = d * (d + 1) // 2
    T = np.zeros((n, m, m))
    for q in range(m):
        T[:, q, q] = 1.0
    if d == 2:
        T[:, 0, 2] = -rel[:, 1] / S_parent
        T[:, 1, 2] = rel[:, 0] / S_parent
        T[:, 2, 2] = s_child / S_parent
    else:
        x, y, z = rel[:, 0], rel[:, 1], rel[:, 2]
        T[:, 1, 3] = -z / S_parent
        T[:, 2, 3] = y / S_parent
        T[:, 0, 4] = z / S_parent
        T[:, 2, 4] = -x / S_parent
        T[:, 0, 5] = -y / S_parent
        T[:, 1, 5] = x / S_parent
        for q in range(3):
            T[:, 3 + q, 3 + q] = s_child / S_parent
    return T


class _Level:
    """One coarse level: its host maps and their device copies.

    n, K        aggregates (block rows) and ELL width
    n_prev      nodes (or aggregates) of the finer level
    agg_prev    (n_prev,) aggregate of each finer node
    nbr         (n, K) int32 column per slot, pad n (host); nbr_T on the device
    emap        Galerkin targets, slot-major s * n + row, dummy K * n:
                level 1 one per element entry in (e, a, b) order, coarser
                levels one per finer-level slot-major entry s * n_prev + i
    diag_slot   (n,) slot of each row's diagonal block
    P           (n_prev, bs_prev, m) transfer blocks (host; P_t on the device)

    emap_t is emap on the device, level 1's in (a, b, e) order, the order
    of assemble_ell_T_blocks.
    """

    __slots__ = ("n", "K", "n_prev", "agg_prev", "nbr", "emap", "diag_slot", "P",
                 "agg_t", "nbr_T", "emap_t", "diag_t", "P_t")

    def __init__(self, n, K, agg_prev, nbr, emap, diag_slot, n_prev, P, dtype, device, ids_t):
        self.n, self.K, self.n_prev = n, K, n_prev
        self.agg_prev, self.nbr, self.emap, self.diag_slot = agg_prev, nbr, emap, diag_slot
        self.P = np.asarray(P)
        self.agg_t = torch.as_tensor(agg_prev, dtype=torch.int64, device=device)
        self.nbr_T = torch.as_tensor(np.ascontiguousarray(nbr.T), dtype=torch.int32,
                                     device=device)
        self.emap_t = torch.as_tensor(ids_t, dtype=torch.int64, device=device)
        self.diag_t = torch.as_tensor(diag_slot, dtype=torch.int64, device=device)
        self.P_t = torch.as_tensor(self.P, dtype=dtype, device=device)


def element_galerkin(J_mask, BcT, d: int):
    """B_a^T J_ab B_b per element and node pair (a, b): J_mask (npe*d,
    npe*d, E) the masked u-block element Jacobians, node-interleaved,
    BcT (npe, d, m, E) the rigid-mode blocks of each element's nodes ->
    (npe*m, npe*m, E), node-interleaved, ready for assemble_ell_T_blocks."""
    npe, _, m, E = BcT.shape
    J5 = J_mask.reshape(npe, d, npe, d, E)
    H = torch.einsum("aqme,aqbfe->ambfe", BcT, J5)
    G = torch.einsum("ambfe,bfne->ambne", H, BcT)
    return G.reshape(npe * m, npe * m, E)


class AMGPrecondFactory:
    """Multilevel aggregation AMG with the make() interface of the
    geometric MGPrecondFactory (calibr8_tpu amg.py:339-1031).  It has no
    preconditioner-state split (recursive is False: `precond reuse: step`
    builds nothing ahead)."""

    recursive = False

    def __init__(self, disc, coarse_cutoff: int = 6000, max_levels: int = 6):
        self.disc = disc
        spec = disc.spec
        d = spec.dim
        self.d = d
        self.m = m = d * (d + 1) // 2
        npe, ndpn = spec.npe, spec.ndofs_per_node
        dev, dtype = disc.device, disc.dtype
        self.uslots = np.array([l * ndpn + q for l in range(npe) for q in range(d)],
                               dtype=np.int64)
        self.pslots = (np.array([l * ndpn + d for l in range(npe)], dtype=np.int64)
                       if spec.mixed else None)

        conn = np.asarray(disc.mesh.conn)
        n_nodes = disc.n_nodes
        coords = np.asarray(disc.mesh.coords, dtype=np.float64)
        cols, ptr = node_graph(conn, n_nodes)

        # -- level 1: aggregate the node graph; element entry -> ELL slot
        agg1, n1 = aggregate(cols, ptr, n_nodes)
        cent, scale = _centroids_scales(agg1, n1, coords)
        B = _rigid_modes(coords - cent[agg1], scale[agg1], d)
        cN = agg1[conn]  # (n_e, npe) aggregate of each element node
        key = (cN[:, :, None] * n1 + cN[:, None, :]).reshape(-1)
        uniq, inv = np.unique(key, return_inverse=True)
        nbr1, slot_of, K1 = _ell_structure(uniq, n1)
        emap1 = slot_of[inv.reshape(-1)]  # (n_e * npe * npe,), (e, a, b) order
        diag1 = slot_of[np.searchsorted(uniq, np.arange(n1) * n1 + np.arange(n1))] // n1
        ids1 = emap1.reshape(conn.shape[0], npe, npe).transpose(1, 2, 0).reshape(-1)
        levels = [_Level(n1, K1, agg1, nbr1, emap1, diag1, n_nodes, B, dtype, dev, ids1)]

        # -- levels 2..L: re-aggregate the previous level's ELL graph
        nbr_prev, n_prev = nbr1, n1
        cent_prev, scale_prev = cent, scale
        while n_prev * m > coarse_cutoff and len(levels) < max_levels:
            # CSR of the previous level graph (pads and self dropped)
            Kp = nbr_prev.shape[1]
            i_prev = np.repeat(np.arange(n_prev), Kp)
            j_prev = nbr_prev.reshape(-1).astype(np.int64)
            valid = (j_prev < n_prev) & (j_prev != i_prev)
            gi, gj = i_prev[valid], j_prev[valid]
            gptr = np.searchsorted(gi, np.arange(n_prev + 1))
            agg, n_c = aggregate(gj.astype(np.int32), gptr, n_prev)
            if n_c >= n_prev:  # no coarsening possible
                break
            cent_c, scale_c = _centroids_scales(agg, n_c, cent_prev)
            T = _rigid_transforms(cent_prev - cent_c[agg], scale_prev, scale_c[agg], d)
            # Galerkin map: previous ELL entry (i, slot) -> coarse slot
            ok = j_prev < n_prev
            keys = np.where(ok, agg[np.where(ok, j_prev, 0)] + agg[i_prev] * n_c, -1)
            uniq = np.unique(keys[ok])
            nbr_c, slot_of, Kc = _ell_structure(uniq, n_c)
            emap_rows = np.full(n_prev * Kp, n_c * Kc, dtype=np.int64)  # dummy
            emap_rows[ok] = slot_of[np.searchsorted(uniq, keys[ok])]
            # the previous level's entries in slot-major order s * n_prev + i
            emap = np.ascontiguousarray(emap_rows.reshape(n_prev, Kp).T).reshape(-1)
            diag_c = slot_of[np.searchsorted(uniq, np.arange(n_c) * n_c + np.arange(n_c))] // n_c
            levels.append(_Level(n_c, Kc, agg, nbr_c, emap, diag_c, n_prev, T, dtype, dev, emap))
            nbr_prev, n_prev = nbr_c, n_c
            cent_prev, scale_prev = cent_c, scale_c

        self.levels = levels
        self.level_sizes = [n_nodes] + [lv.n for lv in levels]
        self._dense_ids = {}

    # -- the chain of levels >= 1 ----------------------------------------
    def _dense_ids_for(self, m: int):
        """Flat targets (i m + q) n_L m + j m + r of the coarsest level's
        A_T entries (s, q, r, i), dummy (n_L m)^2 for the pads (host-built
        once per block size)."""
        if m not in self._dense_ids:
            lv = self.levels[-1]
            nLu = lv.n * m
            j = lv.nbr.T.astype(np.int64)  # (K, n)
            i = np.arange(lv.n)[None, :]
            q = np.arange(m)
            rr = i[:, None, None, :] * m + q[None, :, None, None]
            cc = j[:, None, None, :] * m + q[None, None, :, None]
            flat = np.where((j < lv.n)[:, None, None, :], rr * nLu + cc, nLu * nLu)
            self._dense_ids[m] = torch.as_tensor(flat.reshape(-1), device=self.disc.device)
        return self._dense_ids[m]

    def _coarse_galerkin(self, A_T, li: int, m: int):
        """Level li's operator from level li - 1's A_T (Kp, m, m, n_prev):
        T_i^T A_s,i T_j per entry (one product per entry, the pads' T_j
        zero), summed into level li's slots; the pressure chain (m = 1,
        constant nullspace) sums the entries as they are."""
        lv = self.levels[li]
        if m == 1:
            V = A_T.reshape(1, -1)
        else:
            T = lv.P_t  # (n_prev, m, m)
            Tp = torch.cat([T, T.new_zeros(1, m, m)])[self.levels[li - 1].nbr_T.long()]
            H = torch.einsum("iqa,sqri->sari", T, A_T)
            V = torch.einsum("sari,sirb->absi", H, Tp).reshape(m * m, -1)
        return assemble_slots(V, lv.emap_t, lv.K, lv.n, m)

    def _chain(self, A1_T, m: int):
        """Levels >= 1 of one chain (u: m = d(d+1)/2 rigid modes; p: m = 1)
        from the level-1 Galerkin blocks A1_T (K1, m, m, n1): the coarser
        Galerkin products, the Chebyshev smoothers on D^-1 A (node-block
        diagonal inverted, dead modes given unit rows) and the dense LU
        of the coarsest level.  Returns cycle(0, r1), the W-cycle entered
        at level 1."""
        # solve/mg.py imports this module's smoothers, hence the late import
        from calibr8_tpu_torch.solve.mg import _block_apply, _inverse_blocks, _lu_apply

        levels = self.levels
        L = len(levels)
        A_T, ops = A1_T, []
        for li, lv in enumerate(levels):
            if li > 0:
                A_T = self._coarse_galerkin(A_T, li, m)
            if li == L - 1:
                break
            op_l = (lambda v, A=A_T, nbr=lv.nbr_T: level_ell_spmv(A, nbr, v, m))
            D = A_T.permute(3, 0, 1, 2)[torch.arange(lv.n, device=A_T.device), lv.diag_t]
            if m == 1:
                dp = D[:, 0, 0]
                dp = torch.where(dp.abs() > 1e-30, dp, torch.ones_like(dp))

                def dinv(r, dp=dp):
                    return r / dp

            else:
                fix = (torch.diagonal(D, dim1=1, dim2=2).abs() < 1e-30).to(D.dtype)
                Dinv = _inverse_blocks(D + fix[:, :, None] * torch.eye(
                    m, dtype=D.dtype, device=D.device))

                def dinv(r, Dinv=Dinv):
                    return _block_apply(Dinv, r, m)

            lmax = power_lmax(op_l, dinv, lv.n * m, A_T.dtype, A_T.device, LMAX_ITERS)
            ops.append((op_l, chebyshev(op_l, dinv, lmax, CHEB_DEGREE, CHEB_RATIO)))

        # the coarsest level: dense, unit diagonal where it is empty
        nLu = levels[-1].n * m
        A_dense = A_T.new_zeros(nLu * nLu + 1)
        A_dense.index_add_(0, self._dense_ids_for(m), A_T.reshape(-1))
        A_dense = A_dense[:-1].reshape(nLu, nLu)
        A_dense = A_dense + torch.diag((torch.diagonal(A_dense).abs() < 1e-12).to(A_dense.dtype))
        coarse = _lu_apply(torch.linalg.lu_factor(A_dense))
        modes = m > 1

        def cycle(li, r):
            """The W-cycle below the fine level: li indexes self.levels."""
            if li == L - 1:
                return coarse(r)
            op_l, smooth_l = ops[li]
            z = smooth_l(r)
            for _ in range(GAMMA):
                ec = cycle(li + 1, restrict(levels[li + 1], r - op_l(z), modes))
                z = z + OVERCORR * prolong(levels[li + 1], ec, modes)
            return z + smooth_l(r - op_l(z))

        return cycle

    def _u_chain(self, A1_T):
        """The displacement chain from replicated level-1 blocks (shared
        with parallel/dist_mg.py, where they are summed over the parts)."""
        return self._chain(A1_T, self.m)

    def _p_chain_from_A1(self, A_p1):
        """The scalar pressure chain from level-1 blocks (K1, 1, 1, n1)."""
        return self._chain(A_p1, 1)

    def level1_u(self, J_mask):
        """Level-1 Galerkin blocks B^T J B of the masked u-block element
        Jacobians J_mask (nde_u, nde_u, E): A1_T (K1, m, m, n1)."""
        lv1 = self.levels[0]
        BcT = lv1.P_t[self.disc.conn].permute(1, 2, 3, 0)  # (npe, d, m, E)
        G = element_galerkin(J_mask, BcT, self.d)
        return assemble_ell_T_blocks(G, lv1.emap_t, lv1.K, lv1.n, self.m)

    # -- per-Jacobian construction ----------------------------------------
    def make(self, J_T, diag, bc_dofs, op, transpose=False, state=None):
        """The preconditioner z = M r for one assembled Jacobian: J_T
        (nde, nde, E) element Jacobians (already swapped for a transposed
        system), `op` the full operator with its Dirichlet rows, which
        gives the fine u-block apply and the u/p coupling.  There is no
        preconditioner state: a state raises."""
        if state is not None:
            raise NotImplementedError(
                "AMGPrecondFactory has no preconditioner-state split; build without one")
        from calibr8_tpu_torch.solve.mg import _block_apply, fine_u_setup, mixed_wrap

        disc = self.disc
        d, m = self.d, self.m
        fu = fine_u_setup(disc, J_T, diag, bc_dofs, op, self.uslots)
        cycle = self._u_chain(self.level1_u(fu["J_mask"]))
        Bu_inv = fu["Bu_inv"]

        def fine_dinv(r):
            return _block_apply(Bu_inv, r, d)

        lmax = power_lmax(fu["op_u"], fine_dinv, disc.n_dofs_u, J_T.dtype, J_T.device,
                          LMAX_ITERS)
        fine_smooth = chebyshev(fu["op_u"], fine_dinv, lmax, CHEB_DEGREE, CHEB_RATIO)
        vcycle = fine_vcycle(fu["op_u"], fine_smooth, fu["mask_u"], cycle, self.levels[0], True)
        if not disc.spec.mixed:
            return mixed_wrap(disc, vcycle, fu, transpose)

        # -- the pressure chain on the same aggregates (constant nullspace)
        n_u = disc.n_dofs_u
        ps = torch.as_tensor(self.pslots, device=J_T.device)
        J_pp = J_T[ps][:, ps]  # (npe, npe, E)
        bc_p = fu["bc_mask"][n_u:]
        diag_p = diag[n_u:]
        mask_p = torch.where(bc_p, 0.0, 1.0).to(J_T.dtype)
        m_peT = mask_p[disc.conn].T  # (npe, E)
        lv1 = self.levels[0]
        A_p1 = assemble_ell_T_blocks(J_pp * m_peT[:, None] * m_peT[None, :], lv1.emap_t, lv1.K,
                                     lv1.n, 1)
        p_cycle = self._p_chain_from_A1(A_p1)
        # the fine pressure block through the Disc's ELL maps at m = 1
        p_ell = LevelEllOperator(J_pp, build_ell_maps(disc), disc.n_nodes, 1)

        def op_p(v):
            return torch.where(bc_p, diag_p * v, p_ell(v))

        app = torch.where(diag_p.abs() > 1e-300, diag_p, torch.ones_like(diag_p))

        def p_dinv(r):
            return r / app

        lmax_p = power_lmax(op_p, p_dinv, disc.n_dofs - n_u, J_T.dtype, J_T.device, LMAX_ITERS)
        p_smooth = chebyshev(op_p, p_dinv, lmax_p, CHEB_DEGREE, CHEB_RATIO)
        p_vcycle = fine_vcycle(op_p, p_smooth, mask_p, p_cycle, lv1, False)
        n_p = disc.n_dofs - n_u

        # block Gauss-Seidel over (u, p) with the exact coupling of the
        # full operator; mirrored (p first) for the transposed systems
        if transpose:

            def M(r):
                z_p = p_vcycle(r[n_u:])
                r_u = (r - op(torch.cat([z_p.new_zeros(n_u), z_p])))[:n_u]
                return torch.cat([vcycle(r_u), z_p])

        else:

            def M(r):
                z_u = vcycle(r[:n_u])
                r_p = (r - op(torch.cat([z_u, z_u.new_zeros(n_p)])))[n_u:]
                return torch.cat([z_u, p_vcycle(r_p)])

        return M


def restrict(lv, r, modes: bool):
    """Finer-level residual -> level lv: the transfer blocks' transpose
    per finer node (modes), then summed by aggregate."""
    R = r.reshape(lv.n_prev, -1)
    if modes:
        R = torch.einsum("nqm,nq->nm", lv.P_t, R)
    return R.new_zeros(lv.n, R.shape[1]).index_add_(0, lv.agg_t, R).reshape(-1)


def prolong(lv, e, modes: bool):
    """Level lv's correction -> the finer level: each finer node takes its
    aggregate's values through its transfer block (modes)."""
    E = e.reshape(lv.n, -1)[lv.agg_t]
    if modes:
        E = torch.einsum("nqm,nm->nq", lv.P_t, E)
    return E.reshape(-1)


def fine_vcycle(op_f, smooth_f, mask, cycle, lv1, modes: bool):
    """The cycle of one chain from the fine level: smoothing on op_f, the
    residual masked by the Dirichlet rows before restriction, the
    correction masked after prolongation, the W-cycle below."""

    def vcycle(r):
        z = smooth_f(r)
        ec = cycle(0, restrict(lv1, (r - op_f(z)) * mask, modes))
        z = z + OVERCORR * prolong(lv1, ec, modes) * mask
        return z + smooth_f(r - op_f(z))

    return vcycle
