"""Batched dense solves for tiny (n <= ~16) systems, trailing layout.

The counterpart of calibr8_tpu's gauss_solve_T: unrolled Gauss-Jordan
without pivoting over (n, n, E) systems, the element (or node) axis
last.  The port uses it to invert the preconditioner's node blocks once
per Jacobian (solve/precond.py).
"""

from __future__ import annotations

import torch


def gauss_solve_T(A, B):
    """A (n, n, E), B (n, m, E) -> X (n, m, E) with A X = B per column
    of the trailing axis.  No pivoting: the callers' blocks are
    diagonally dominant."""
    n = A.shape[0]
    Ab = torch.cat([A, B], dim=1)  # (n, n+m, E)
    for k in range(n):
        rowk = Ab[k] * (1.0 / Ab[k, k])  # (n+m, E)
        Ab = torch.stack([rowk if i == k else Ab[i] - Ab[i, k] * rowk for i in range(n)])
    return Ab[:, n:]


def gauss_solve_pivot(A, B):
    """A (..., n, n), B (..., n, m) -> X (..., n, m) with A X = B, by
    Gauss-Jordan with partial (max-column) pivoting: calibr8_tpu's
    gauss_solve(..., pivot=True).  The multigrid inverts its node blocks
    with it, where Dirichlet rows and coarse Galerkin blocks need not be
    diagonally dominant."""
    n = A.shape[-1]
    Ab = torch.cat([A, B], dim=-1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        col = Ab[..., :, k].abs().masked_fill(rows < k, -1.0)
        piv = col.argmax(dim=-1)  # (...,)
        gidx = piv[..., None, None].expand(*piv.shape, 1, Ab.shape[-1])
        piv_row = torch.gather(Ab, -2, gidx)  # (..., 1, n+m)
        row_k = Ab[..., k : k + 1, :]
        Ab = Ab.scatter(-2, gidx, row_k)
        Ab[..., k : k + 1, :] = piv_row
        rowk = Ab[..., k, :] / Ab[..., k, k : k + 1]
        Ab = Ab - Ab[..., :, k : k + 1] * rowk[..., None, :]
        Ab[..., k, :] = rowk
    return Ab[..., :, n:]
