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
plain version on the CPU.  Slots are packed densely per row (sorted
column order); calibr8_tpu's stencil canonicalization
(solve/ellpack.py:70-111 there) served the TPU's static-slice gather and
is not carried over.  Assembly A_T <- J_T is one index_add_ over the
host-built flat slot ids (the scatter-offsets analog), once per Newton
iteration.
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


def build_ell_maps(disc) -> dict:
    """ELL maps of a Disc, built once on the host and cached on it, with
    the device tensors the operator uses: nbr_T (K, n) int32 and
    ell_ids_T int64."""
    cached = getattr(disc, "_ell_maps", None)
    if cached is None:
        maps = ell_maps_from_conn(disc.mesh.conn, disc.n_nodes)
        maps["nbr_T"] = torch.as_tensor(
            np.ascontiguousarray(maps["nbr"].T), dtype=torch.int32, device=disc.device
        )
        maps["ids_T"] = torch.as_tensor(maps["ell_ids_T"], dtype=torch.int64, device=disc.device)
        disc._ell_maps = cached = maps
    return cached


def assemble_ell_T(J_T, disc):
    """Element Jacobians J_T (nde, nde, E) -> A_T (K, ndpn, ndpn, n_nodes).
    One index_add_ along the node-slot axis (PyTorch's segment_sum)."""
    maps = build_ell_maps(disc)
    npe, ndpn, K, n, E = disc.spec.npe, disc.ndpn, maps["K"], disc.n_nodes, disc.n_elem
    # (a, i, b, j, e) -> (i, j, a, b, e): column order (a, b, e) of ids_T
    V = J_T.reshape(npe, ndpn, npe, ndpn, E).permute(1, 3, 0, 2, 4).reshape(ndpn * ndpn, -1)
    A2 = torch.zeros(ndpn * ndpn, K * n, dtype=J_T.dtype, device=J_T.device)
    A2.index_add_(1, maps["ids_T"], V)
    return A2.reshape(ndpn, ndpn, K, n).permute(2, 0, 1, 3).contiguous()


_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5


def ell_spmv(A_T, nbr_T, x, dim: int):
    """y = A x for the node-block ELL matrix (A_T, nbr_T) and the flat
    dof vector x (u block of n*dim, then the p block when
    ndpn = dim + 1).  On CUDA tensors this launches the kernel (or
    raises); on CPU tensors it runs the plain version."""
    if not x.is_cuda:
        return ell_spmv_plain(A_T, nbr_T, x, dim)
    req = kernels.require
    K, ndpn, _, n = A_T.shape
    req(A_T.shape == (K, ndpn, ndpn, n), f"A_T has shape {tuple(A_T.shape)}")
    req(ndpn in (dim, dim + 1), f"ndpn {ndpn} does not fit dim {dim}")
    req(nbr_T.shape == (K, n) and nbr_T.dtype == torch.int32, "nbr_T must be (K, n) int32")
    req(x.shape == (n * ndpn,), f"x has shape {tuple(x.shape)}, want ({n * ndpn},)")
    req(A_T.dtype == x.dtype, f"A_T is {A_T.dtype}, x is {x.dtype}")
    for name, t in (("A_T", A_T), ("nbr_T", nbr_T), ("x", x)):
        req(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        req(t.is_contiguous(), f"{name} is not contiguous")
    y = torch.empty_like(x)
    fn = kernels.function("ell_spmv", "c8_ell_spmv", _ARGTYPES)
    err = fn(
        x.device.index, kernels.dtype_code(x.dtype), dim, ndpn, n, K, A_T.data_ptr(), nbr_T.data_ptr(),
        x.data_ptr(), y.data_ptr(), kernels.stream_ptr(x.device),
    )
    kernels.check("ell_spmv", err)
    kernels.launches["ell_spmv"] += 1
    return y


def ell_spmv_plain(A_T, nbr_T, x, dim: int):
    """The plain PyTorch version: gather the neighbour rows of the node
    matrix (a zero row stands for the pad slots), contract."""
    K, ndpn, _, n = A_T.shape
    X = x[: n * dim].reshape(n, dim)
    if ndpn > dim:
        X = torch.cat([X, x[n * dim :].reshape(n, 1)], dim=1)
    Xp = torch.cat([X, torch.zeros(1, ndpn, dtype=x.dtype, device=x.device)])
    G = Xp[nbr_T.long()]  # (K, n, ndpn)
    Y = torch.einsum("sijn,snj->ni", A_T, G)
    parts = [Y[:, :dim].reshape(-1)]
    if ndpn > dim:
        parts.append(Y[:, dim])
    return torch.cat(parts)


class EllOperator:
    """y = A x with Dirichlet rows diag * x, assembled once per Jacobian."""

    def __init__(self, disc, J_T, diag, bc_dofs):
        self.disc = disc
        self.diag = diag
        self.bc_dofs = bc_dofs
        self.A_T = assemble_ell_T(J_T, disc)
        self.nbr_T = build_ell_maps(disc)["nbr_T"]

    def __call__(self, v):
        y = ell_spmv(self.A_T, self.nbr_T, v, self.disc.spec.dim)
        return apply_dbcs_matvec(y, self.diag, v, self.bc_dofs)
