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
