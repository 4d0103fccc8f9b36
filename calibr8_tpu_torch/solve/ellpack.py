"""Assembled node-block ELLPACK operator for the Krylov loop.

The counterpart of calibr8_tpu's solve/ellpack.py.  A Newton iteration
runs up to a few hundred Krylov iterations against ONE Jacobian, so the
element Jacobians are assembled once into a regular sparse form and
every apply is scatter-free:

  A_T     (K, ndpn, ndpn, n_nodes)   node-block rows, fixed width K,
                                     trailing layout (node index last)
  nbr_T   (K, n_nodes) int32         column node of each slot; the pad
                                     slots hold n_nodes

  y[n] = sum_s A[s, :, :, n] @ x[nbr[n, s]]

The apply is the ell_spmv kernel (csrc/ell_spmv.cu) on the card and its
plain version on the CPU; the transposed apply y = A^T x of the adjoint
solves is the ell_spmv_T kernel (csrc/ell_spmv_T.cu) on the same A_T.  Slots are packed densely per row (sorted
column order); calibr8_tpu's stencil canonicalization
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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.fem.bcs import apply_dbcs_matvec


def ell_maps_from_conn(conn, n_nodes: int) -> dict:
    """Host-side maps from a connectivity (n_e, npe):

      nbr        (n_nodes, K) int32  column node per slot, pad = n_nodes
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
    return dict(nbr=nbr, ell_ids_T=ell_ids_T, K=K)


def ell_device_maps(conn, n_nodes: int, device) -> dict:
    """ell_maps_from_conn with the device tensors the operators use:
    nbr_T (K, n) int32 and ids_T int64."""
    maps = ell_maps_from_conn(conn, n_nodes)
    maps["nbr_T"] = torch.as_tensor(
        np.ascontiguousarray(maps["nbr"].T), dtype=torch.int32, device=device
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


def assemble_ell_T_blocks(JT, ids_T, K: int, n_nodes: int, m: int):
    """Element blocks JT (npe*m, npe*m, E), node-interleaved, -> A_T
    (K, m, m, n_nodes), with the (a, b, e)-ordered slot ids of
    ell_maps_from_conn: one index_add_ along the node-slot axis
    (PyTorch's segment_sum).  calibr8_tpu's assemble_ell_T_blocks
    (solve/ellpack.py:284)."""
    E = JT.shape[-1]
    npe = JT.shape[0] // m
    # (a, i, b, j, e) -> (i, j, a, b, e): column order (a, b, e) of ids_T
    V = JT.reshape(npe, m, npe, m, E).permute(1, 3, 0, 2, 4).reshape(m * m, -1)
    A2 = torch.zeros(m * m, K * n_nodes, dtype=JT.dtype, device=JT.device)
    A2.index_add_(1, ids_T, V)
    return A2.reshape(m, m, K, n_nodes).permute(2, 0, 1, 3).contiguous()


def assemble_ell_T(J_T, disc):
    """Element Jacobians J_T (nde, nde, E) -> A_T (K, ndpn, ndpn, n_nodes)."""
    maps = build_ell_maps(disc)
    return assemble_ell_T_blocks(J_T, maps["ids_T"], maps["K"], disc.n_nodes, disc.ndpn)


_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5


def _launch(name, symbol, A_T, nbr_T, x, dim, y, counter=None):
    """Check the inputs of an ELL kernel of library `name` and launch it
    into y; the launch counts under `counter` (default: `name`)."""
    req = kernels.require
    K, ndpn, _, n = A_T.shape
    req(A_T.shape == (K, ndpn, ndpn, n), f"A_T has shape {tuple(A_T.shape)}")
    req(ndpn in (dim, dim + 1), f"ndpn {ndpn} does not fit dim {dim}")
    req(nbr_T.shape == (K, n) and nbr_T.dtype == torch.int32, "nbr_T must be (K, n) int32")
    req(x.shape == (n * ndpn,), f"x has shape {tuple(x.shape)}, want ({n * ndpn},)")
    req(A_T.dtype == x.dtype, f"A_T is {A_T.dtype}, x is {x.dtype}")
    for arg, t in (("A_T", A_T), ("nbr_T", nbr_T), ("x", x)):
        req(t.device == x.device, f"{arg} is on {t.device}, x on {x.device}")
        req(t.is_contiguous(), f"{arg} is not contiguous")
    fn = kernels.function(name, symbol, _ARGTYPES)
    err = fn(
        x.device.index, kernels.dtype_code(x.dtype), dim, ndpn, n, K, A_T.data_ptr(), nbr_T.data_ptr(),
        x.data_ptr(), y.data_ptr(), kernels.stream_ptr(x.device),
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


def ell_spmv_T(A_T, nbr_T, x, dim: int):
    """y = A^T x for the same matrix and layout as ell_spmv (kernel 3b).
    On CUDA tensors this launches the kernel (or raises); on CPU tensors
    it runs the plain version."""
    if not x.is_cuda:
        return ell_spmv_T_plain(A_T, nbr_T, x, dim)
    # zeros, not empty: the kernel adds into y
    return _launch("ell_spmv_T", "c8_ell_spmv_T", A_T, nbr_T, x, dim, torch.zeros_like(x))


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
    one extra row that takes the pad slots' (zero) products."""
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
        self.nbr_T = build_ell_maps(disc)["nbr_T"]

    def __call__(self, v):
        apply = ell_spmv_T if self.transpose else ell_spmv
        y = apply(self.A_T, self.nbr_T, v, self.disc.spec.dim)
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
