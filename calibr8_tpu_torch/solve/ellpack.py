"""Assembled node-block ELLPACK operator for the Krylov loop.

The counterpart of calibr8_tpu's solve/ellpack.py.  A Newton iteration
runs up to a few hundred Krylov iterations against ONE Jacobian, so the
element Jacobians are assembled once into a regular sparse form and
every apply is scatter-free:

  A_T     (K, ndpn, ndpn, n_nodes)   node-block rows, fixed width K,
                                     trailing layout (node index last)
  nbr_T   (K, n_nodes) int32         column node of each slot; the pad
                                     slots hold n_nodes
  tr_T    (K, n_nodes) int32         slot of node c in row nbr_T[t, c]
                                     (the transposed slot map; 0 in the
                                     pad slots)

  y[n] = sum_s A[s, :, :, n] @ x[nbr[n, s]]

The apply is the ell_spmv kernel (csrc/ell_spmv.cu) on the card and its
plain version on the CPU; the transposed apply y = A^T x of the adjoint
solves is the ell_spmv_T kernel (csrc/ell_spmv_T.cu) on the same A_T, a
gather over each output node's own row through tr_T.  Slots are packed
densely per row (sorted column order); calibr8_tpu's stencil canonicalization
(solve/ellpack.py:70-111 there) served the TPU's static-slice gather and
is not carried over.  Assembly A_T <- J_T is one index_add_ over the
host-built flat slot ids (the scatter-offsets analog), once per Newton
iteration.

LevelEllOperator is the same matrix form for one multigrid level
(calibr8_tpu's kernel 3c): node blocks of width m (dim for the
displacement chain, 1 for the pressure chain) on node-interleaved
vectors x[n * m + j], assembled from element blocks (npe*m, npe*m, E),
with no Dirichlet rows.  Its apply launches the ell_spmv kernel's (m, m)
instance on the card and counts as `ell_spmv_level`.

part_ell_spmv is the same kernel per part for the domain-decomposed
solver (parallel/dist.py): every part's local matrix at once, one launch,
counted as `ell_spmv_part`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.fem.bcs import apply_dbcs_matvec


def transposed_slots(nbr) -> np.ndarray:
    """The transposed slot map of a node-block ELL pattern nbr (n, K)
    int32, pad id n: tr (n, K) int32 with tr[c, t] the slot of c in row
    m = nbr[c, t], so that nbr[m, tr[c, t]] == c on every filled slot.
    The pad slots hold 0.  y = A^T x then gathers over node c's own row:
    y[c] = sum_t A[m, tr[c, t]]^T x[m] (kernel 3b).  Raises ValueError
    where the pattern is not structurally symmetric (c in row m but m not
    in row c)."""
    nbr = np.asarray(nbr)
    n, K = nbr.shape
    flat = nbr.reshape(-1).astype(np.int64)
    filled = np.flatnonzero(flat < n)
    rows, cols, slots = filled // K, flat[filled], filled % K
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    skey = key[order]
    # where the pair (m, c) of each filled (c, m) sits
    mirror = cols * n + rows
    pos = np.searchsorted(skey, mirror)
    found = pos < len(skey)
    found[found] = skey[pos[found]] == mirror[found]
    if not found.all():
        i = int(np.flatnonzero(~found)[0])
        raise ValueError(f"the ELL pattern is not symmetric: node {int(cols[i])} is in row "
                         f"{int(rows[i])}, but row {int(cols[i])} does not hold {int(rows[i])}")
    tr = np.zeros(n * K, dtype=np.int32)
    tr[filled] = slots[order][pos]
    return tr.reshape(n, K)


def ell_maps_from_conn(conn, n_nodes: int) -> dict:
    """Host-side maps from a connectivity (n_e, npe):

      nbr        (n_nodes, K) int32  column node per slot, pad = n_nodes
      tr         (n_nodes, K) int32  slot of node c in row nbr[c, t]
                                     (transposed_slots), 0 in the pads
      ell_ids_T  (npe*npe*n_e,)      slot-major position s*n_nodes + n of
                                     element entry (e, a, b), in (a, b, e)
                                     order (assemble_ell_T)
      K          slots per row
    """
    conn = np.asarray(conn)
    n_e, npe = conn.shape
    # unique (row node, col node) pairs over all element blocks
    i = np.repeat(conn, npe, axis=1).reshape(-1)
    j = np.tile(conn, (1, npe)).reshape(-1)
    key = i.astype(np.int64) * n_nodes + j
    uniq, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    u_i = uniq // n_nodes
    u_j = uniq % n_nodes
    # slot of each unique pair within its row (uniq is sorted by (i, j))
    row_start = np.searchsorted(u_i, np.arange(n_nodes))
    slot = np.arange(len(uniq)) - row_start[u_i]
    K = int(slot.max()) + 1

    nbr = np.full((n_nodes, K), n_nodes, dtype=np.int32)
    nbr[u_i, slot] = u_j.astype(np.int32)
    ell_idx_T = (slot * n_nodes + u_i)[inv].reshape(n_e, npe, npe)
    ell_ids_T = np.ascontiguousarray(ell_idx_T.transpose(1, 2, 0).reshape(-1))
    return dict(nbr=nbr, tr=transposed_slots(nbr), ell_ids_T=ell_ids_T, K=K)


def ell_device_maps(conn, n_nodes: int, device) -> dict:
    """ell_maps_from_conn with the device tensors the operators use:
    nbr_T and tr_T (K, n) int32, ids_T int64."""
    maps = ell_maps_from_conn(conn, n_nodes)
    for key in ("nbr", "tr"):
        maps[f"{key}_T"] = torch.as_tensor(
            np.ascontiguousarray(maps[key].T), dtype=torch.int32, device=device
        )
    maps["ids_T"] = torch.as_tensor(maps["ell_ids_T"], dtype=torch.int64, device=device)
    return maps


def build_ell_maps(disc) -> dict:
    """ELL maps of a Disc (ell_device_maps), built once on the host and
    cached on it."""
    cached = getattr(disc, "_ell_maps", None)
    if cached is None:
        disc._ell_maps = cached = ell_device_maps(disc.mesh.conn, disc.n_nodes, disc.device)
    return cached


def assemble_slots(V, ids, K: int, n: int, m: int):
    """Columns V (m*m, C) added at their slot-major targets ids (C,), s *
    n + row, the dummy K * n taking pad entries -> A_T (K, m, m, n): one
    index_add_ along the node-slot axis (PyTorch's segment_sum)."""
    A2 = V.new_zeros(m * m, K * n + 1)
    A2.index_add_(1, ids, V)
    return A2[:, : K * n].reshape(m, m, K, n).permute(2, 0, 1, 3).contiguous()


def assemble_ell_T_blocks(JT, ids_T, K: int, n_nodes: int, m: int):
    """Element blocks JT (npe*m, npe*m, E), node-interleaved, -> A_T
    (K, m, m, n_nodes), with (a, b, e)-ordered slot ids such as
    ell_maps_from_conn's (the dummy K * n_nodes takes pad entries).
    calibr8_tpu's assemble_ell_T_blocks (solve/ellpack.py:284)."""
    npe = JT.shape[0] // m
    # (a, i, b, j, e) -> (i, j, a, b, e): column order (a, b, e) of ids_T
    V = JT.reshape(npe, m, npe, m, -1).permute(1, 3, 0, 2, 4).reshape(m * m, -1)
    return assemble_slots(V, ids_T, K, n_nodes, m)


def assemble_ell_T(J_T, disc):
    """Element Jacobians J_T (nde, nde, E) -> A_T (K, ndpn, ndpn, n_nodes)."""
    maps = build_ell_maps(disc)
    return assemble_ell_T_blocks(J_T, maps["ids_T"], maps["K"], disc.n_nodes, disc.ndpn)


# the C entries' argument types by the number of maps (nbr_T; nbr_T, tr_T)
_ARGTYPES = {k: [ctypes.c_int] * 6 + [ctypes.c_void_p] * (4 + k) for k in (1, 2)}


def _check_ell(A_T, nbr_T, x, dim: int, tr_T=None):
    """Check the inputs of an ELL kernel on tensors of any device: A_T
    (K, ndpn, ndpn, n) with ndpn = dim or dim + 1, nbr_T (K, n) int32,
    tr_T (when given) the same, x (n * ndpn,) of A_T's dtype, all
    contiguous on x's device.
    Raises ValueError naming the argument; returns (K, ndpn, n).  The
    messages are formatted only on failure: formatted eagerly they cost
    more host time a call than the kernel takes on the card."""
    req = kernels.require
    if A_T.dim() != 4 or A_T.shape[1] != A_T.shape[2]:
        req(False, f"A_T has shape {tuple(A_T.shape)}, want (K, ndpn, ndpn, n)")
    K, ndpn, _, n = A_T.shape
    if ndpn != dim and ndpn != dim + 1:
        req(False, f"A_T's ndpn {ndpn} does not fit dim {dim}")
    maps = (("nbr_T", nbr_T),) if tr_T is None else (("nbr_T", nbr_T), ("tr_T", tr_T))
    for arg, t in maps:
        if t.shape != (K, n) or t.dtype != torch.int32:
            req(False, f"{arg} is {tuple(t.shape)} {t.dtype}, want ({K}, {n}) torch.int32")
    if x.shape != (n * ndpn,):
        req(False, f"x has shape {tuple(x.shape)}, want ({n * ndpn},)")
    if A_T.dtype != x.dtype:
        req(False, f"A_T is {A_T.dtype}, x is {x.dtype}")
    dev = x.get_device()
    for arg, t in (("A_T", A_T), *maps, ("x", x)):
        if t.get_device() != dev:
            req(False, f"{arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            req(False, f"{arg} is not contiguous")
    return K, ndpn, n


def _launch(name, symbol, A_T, nbr_T, x, dim, y, counter=None, tr_T=None):
    """Check the inputs of an ELL kernel of library `name` and launch it
    into y; the launch counts under `counter` (default: `name`).  tr_T,
    when given, goes to the kernel after nbr_T."""
    K, ndpn, n = _check_ell(A_T, nbr_T, x, dim, tr_T)
    dev = x.device
    maps = (nbr_T.data_ptr(),) if tr_T is None else (nbr_T.data_ptr(), tr_T.data_ptr())
    fn = kernels.function(name, symbol, _ARGTYPES[len(maps)])
    err = fn(
        dev.index, kernels.dtype_code(x.dtype), dim, ndpn, n, K, A_T.data_ptr(), *maps,
        x.data_ptr(), y.data_ptr(), kernels.stream_ptr(dev),
    )
    kernels.check(name, err)
    kernels.launches[counter or name] += 1
    return y


def ell_spmv(A_T, nbr_T, x, dim: int):
    """y = A x for the node-block ELL matrix (A_T, nbr_T) and the flat
    dof vector x (u block of n*dim, then the p block when
    ndpn = dim + 1).  On CUDA tensors this launches the kernel (or
    raises); on CPU tensors it runs the plain version."""
    if not x.is_cuda:
        return ell_spmv_plain(A_T, nbr_T, x, dim)
    return _launch("ell_spmv", "c8_ell_spmv", A_T, nbr_T, x, dim, torch.empty_like(x))


def ell_spmv_T(A_T, nbr_T, tr_T, x, dim: int):
    """y = A^T x for the same matrix and layout as ell_spmv (kernel 3b),
    with tr_T the pattern's transposed slot map (ell_device_maps).  On
    CUDA tensors this launches the kernel, which writes every entry of y
    (or raises, also where tr_T is None); on CPU tensors it runs the plain
    version, which does not read tr_T."""
    if not x.is_cuda:
        return ell_spmv_T_plain(A_T, nbr_T, x, dim)
    if tr_T is None:
        kernels.require(False, "ell_spmv_T needs tr_T, the transposed slot map (ell_device_maps)")
    return _launch("ell_spmv_T", "c8_ell_spmv_T", A_T, nbr_T, x, dim, torch.empty_like(x),
                   tr_T=tr_T)


def level_ell_spmv(A_T, nbr_T, x, m: int):
    """y = A x on one multigrid level (kernel 3c): A_T (K, m, m, n), x and
    y node-interleaved (n * m,).  On CUDA tensors this launches the
    ell_spmv kernel's (m, m) instance, counted as `ell_spmv_level` (or
    raises); on CPU tensors it runs the plain version."""
    if not x.is_cuda:
        return level_ell_spmv_plain(A_T, nbr_T, x, m)
    return _launch("ell_spmv", "c8_ell_spmv", A_T, nbr_T, x, m, torch.empty_like(x),
                   counter="ell_spmv_level")


def level_ell_spmv_plain(A_T, nbr_T, x, m: int):
    """The plain PyTorch version of level_ell_spmv: calibr8_tpu's CPU
    branch of LevelEllOperator (solve/ellpack.py:408), the neighbour
    values gathered slot-major (a zero row for the pad slots), then
    y[i, n] = sum_{s, j} A[s, i, j, n] G[s, j, n]."""
    n = A_T.shape[-1]
    X = torch.cat([x.reshape(n, m), torch.zeros(1, m, dtype=x.dtype, device=x.device)])
    G_T = X[nbr_T.long()].permute(0, 2, 1)  # (K, m, n)
    return torch.einsum("sijn,sjn->in", A_T, G_T).T.reshape(-1)


def part_ell_spmv(A_T, nbr_T, x, m: int):
    """y_p = A_p x_p for every part p of the domain-decomposed solver at
    once (kernel 3c per part: calibr8_tpu's parallel/dist.py:416-471, the
    einsum on the CPU and the Pallas kernel per part on the TPU).  x (P,
    N_loc, m) holds each part's local [owned | ghost] values,
    node-interleaved; the parts' local matrices are laid end to end into
    one node space of P * N_loc nodes, A_T (K, m, m, P * N_loc) and nbr_T
    (K, P * N_loc) int32 with part p's neighbour ids offset by p * N_loc
    and the pad slots at P * N_loc.  Returns y (P, N_loc, m), the local
    rows, ghost rows holding partial sums.  On CUDA tensors this is one
    launch of the ell_spmv kernel's (m, m) instance for all parts, counted
    as `ell_spmv_part` (or raises); on CPU tensors it runs the plain
    version."""
    if not x.is_cuda:
        return part_ell_spmv_plain(A_T, nbr_T, x, m)
    if x.dim() != 3 or x.shape[2] != m or not x.is_contiguous():
        kernels.require(False, f"x must be a contiguous (P, N_loc, {m}) tensor, "
                               f"got {tuple(x.shape)}")
    y = torch.empty_like(x)
    _launch("ell_spmv", "c8_ell_spmv", A_T, nbr_T, x.reshape(-1), m, y, counter="ell_spmv_part")
    return y


def part_ell_spmv_plain(A_T, nbr_T, x, m: int):
    """The plain PyTorch version of part_ell_spmv: level_ell_spmv_plain on
    the parts' joint node space."""
    return level_ell_spmv_plain(A_T, nbr_T, x.reshape(-1), m).reshape(x.shape)


def _node_matrix(x, n, dim, ndpn):
    """Flat dofs -> (n, ndpn) node matrix [u | p]."""
    X = x[: n * dim].reshape(n, dim)
    if ndpn > dim:
        X = torch.cat([X, x[n * dim :].reshape(n, 1)], dim=1)
    return X


def _flat(Y, dim, ndpn):
    """(n, ndpn) node matrix -> flat dofs (u block, then p block)."""
    parts = [Y[:, :dim].reshape(-1)]
    if ndpn > dim:
        parts.append(Y[:, dim])
    return torch.cat(parts)


def ell_spmv_plain(A_T, nbr_T, x, dim: int):
    """The plain PyTorch version: gather the neighbour rows of the node
    matrix (a zero row stands for the pad slots), contract."""
    K, ndpn, _, n = A_T.shape
    X = _node_matrix(x, n, dim, ndpn)
    Xp = torch.cat([X, torch.zeros(1, ndpn, dtype=x.dtype, device=x.device)])
    G = Xp[nbr_T.long()]  # (K, n, ndpn)
    return _flat(torch.einsum("sijn,snj->ni", A_T, G), dim, ndpn)


def ell_spmv_T_plain(A_T, nbr_T, x, dim: int):
    """The plain PyTorch version of ell_spmv_T: the per-slot products
    Gt[s, j, n] = sum_i A[s, i, j, n] x[n, i], then the transpose of the
    neighbour gather, an index_add_ over nbr_T into a node matrix with
    one extra row that takes the pad slots' products.  It does not use
    tr_T, so it is an oracle of the kernel and of the map alike."""
    K, ndpn, _, n = A_T.shape
    X = _node_matrix(x, n, dim, ndpn)
    Gt = torch.einsum("sijn,ni->snj", A_T, X)  # (K, n, ndpn)
    Y = torch.zeros(n + 1, ndpn, dtype=x.dtype, device=x.device)
    Y.index_add_(0, nbr_T.reshape(-1).long(), Gt.reshape(K * n, ndpn))
    return _flat(Y[:n], dim, ndpn)


class EllOperator:
    """y = A x (or, with transpose, y = A^T x) with the Dirichlet rows
    replaced by diag * x, assembled once per Jacobian from the forward
    element Jacobians J_T.  The transposed operator is the adjoint
    system's (calibr8_tpu solve/linear.py:130-133): transpose first, then
    eliminate rows; its apply is the ell_spmv_T kernel on the same A_T."""

    def __init__(self, disc, J_T, diag, bc_dofs, transpose: bool = False):
        self.disc = disc
        self.diag = diag
        self.bc_dofs = bc_dofs
        self.transpose = transpose
        self.A_T = assemble_ell_T(J_T, disc)
        maps = build_ell_maps(disc)
        self.nbr_T, self.tr_T = maps["nbr_T"], maps["tr_T"]

    def __call__(self, v):
        d = self.disc.spec.dim
        if self.transpose:
            y = ell_spmv_T(self.A_T, self.nbr_T, self.tr_T, v, d)
        else:
            y = ell_spmv(self.A_T, self.nbr_T, v, d)
        return apply_dbcs_matvec(y, self.diag, v, self.bc_dofs)


class LevelEllOperator:
    """y = A_l x for one multigrid level, assembled once per hierarchy
    build from element blocks JT (npe*m, npe*m, E) with the level's ELL
    maps (ell_device_maps of its mesh): calibr8_tpu's LevelEllOperator
    (solve/ellpack.py:322-409).  No Dirichlet rows: level operators are
    Galerkin products of already masked fine blocks.  from_assembled
    rebuilds the operator from a stored A_T (the preconditioner state of
    `precond reuse: step`)."""

    def __init__(self, JT, maps, n_nodes: int, m: int):
        self.A_T = assemble_ell_T_blocks(JT, maps["ids_T"], maps["K"], n_nodes, m)
        self.nbr_T = maps["nbr_T"]
        self.m = m

    @classmethod
    def from_assembled(cls, A_T, maps, m: int):
        self = cls.__new__(cls)
        self.A_T, self.nbr_T, self.m = A_T, maps["nbr_T"], m
        return self

    def __call__(self, v):
        return level_ell_spmv(self.A_T, self.nbr_T, v, self.m)
