"""Block u/p Gauss-Seidel preconditioner with node-block Jacobi blocks.

The counterpart of calibr8_tpu's solve/precond.py (the reference's Teko
block-2x2 Gauss-Seidel, linear_solve.cpp:36-123):

  z_u = M_u^{-1} r_u
  z_p = M_p^{-1} (r_p - A_pu z_u)        (lower block Gauss-Seidel)

with M_u the node-block Jacobi (d x d blocks assembled from the element
Jacobians, inverted once per Jacobian) and M_p point Jacobi on the
pressure block.  Plain tensor operations on the solve's device.
"""

from __future__ import annotations

import torch

from calibr8_tpu_torch.utils.smallsolve import gauss_solve_T


def node_block_diagonal(disc, J_T):
    """(n_nodes, ndpn, ndpn) node-diagonal blocks of the assembled
    matrix, from trailing element Jacobians J_T (nde, nde, E): the
    element entries whose row node equals their column node."""
    npe, ndpn, E = disc.spec.npe, disc.ndpn, disc.n_elem
    J5 = J_T.reshape(npe, ndpn, npe, ndpn, E)
    self_blocks = torch.stack([J5[n, :, n] for n in range(npe)])  # (npe, ndpn, ndpn, E)
    rows = self_blocks.permute(3, 0, 1, 2).reshape(E * npe, ndpn * ndpn)
    return disc.scatter_rows(rows).reshape(disc.n_nodes, ndpn, ndpn)


class BlockJacobiGS:
    """Block u/p Gauss-Seidel with node-block-Jacobi inner solves.

    transpose=True applies the TRANSPOSE of the forward preconditioner,
    built from the forward Jacobians: for M = [[U, 0], [-s a U, s]]
    (U = Au^-1, a = A_pu, s = 1/app), z_p = s r_p; z_u = U^T (r_u - a^T z_p)."""

    def __init__(self, disc, J_T, diag, bc_dofs, transpose=False):
        self.disc = disc
        self.transpose = transpose
        d = disc.spec.dim
        dtype = J_T.dtype
        blocks = node_block_diagonal(disc, J_T)  # (n_nodes, ndpn, ndpn)
        # Dirichlet rows: the unit row scaled with the assembled diagonal
        # (consistent with the operator's DBC row treatment)
        D = disc.nodemat(diag)
        bc_mask = torch.zeros(disc.n_dofs, dtype=dtype, device=J_T.device)
        # index_fill_ passes the value to the kernel (a CUDA graph can hold it)
        bc_mask.index_fill_(0, bc_dofs, 1.0)
        rowsel = disc.nodemat(bc_mask)[:, :, None]
        eye = torch.eye(disc.ndpn, dtype=dtype, device=J_T.device)
        blocks = blocks * (1.0 - rowsel) + rowsel * eye[None] * D[:, :, None]
        # invert the d x d displacement blocks once, in trailing layout
        AuT = blocks[:, :d, :d].permute(1, 2, 0)
        eyeT = torch.eye(d, dtype=dtype, device=J_T.device)[:, :, None].expand(d, d, disc.n_nodes)
        self.Au_invT = gauss_solve_T(AuT, eyeT)  # (d, d, n_nodes)
        self.mixed = disc.spec.mixed
        if self.mixed:
            self.ApuT = blocks[:, d, :d].T  # (d, n_nodes)
            app = blocks[:, d, d]
            self.safe_app = torch.where(app.abs() > 1e-300, app, torch.ones_like(app))
        self.d = d

    def __call__(self, r):
        disc, d, Ainv = self.disc, self.d, self.Au_invT
        RT = disc.nodemat(r).T  # (ndpn, n_nodes)
        if self.transpose:
            if self.mixed:
                zp = RT[d] / self.safe_app
                ru = [RT[j] - self.ApuT[j] * zp for j in range(d)]
            else:
                ru = [RT[j] for j in range(d)]
            zu = torch.stack([sum(Ainv[j, i] * ru[j] for j in range(d)) for i in range(d)])
        else:
            zu = torch.stack([sum(Ainv[i, j] * RT[j] for j in range(d)) for i in range(d)])
            if self.mixed:
                rp = RT[d]
                for j in range(d):
                    rp = rp - self.ApuT[j] * zu[j]
                zp = rp / self.safe_app
        Z = torch.cat([zu, zp[None]]) if self.mixed else zu
        return disc.nodemat_to_flat(Z.T)
