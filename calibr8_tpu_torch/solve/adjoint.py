"""Two-level (global/local) adjoint over pseudo-time steps.

The counterpart of calibr8_tpu's solve/adjoint.py (reference
adjoint.cpp, evaluations.cpp eval_adjoint_jacobian :349-520,
solve_adjoint_local :528-655, eval_qoi_gradient :758-930): marching
BACKWARD over the load steps with per-element history vectors f
(element-dof sized) and g (local-state sized), the recursion at step n is

  LHS       = (dR/dx + dR/dxi dxi_dx)^T          (condensed, transposed)
  RHS_e     = -dJ/dx + f + dxi_dx^T (g - dJ/dxi)
  solve        LHS z = RHS  with adjoint DBC rows (z = 0 on constrained)
  phi       = (dC/dxi)^{-T} (g' - (dR/dxi)^T z_e),  g' = g - dJ/dxi
  f_next    = -(dC/dx_prev)^T phi
  g_next    = -(dC/dxi_prev)^T phi
  dJ/dp    += sum_e [ (dC/dp)^T phi + dJ/dp|direct + (dR/dp)^T z ]

with the element blocks from fem/adjoint_blocks.py (the local branch
forced to the primal's recorded path) and the QoI partials from
QoI.partials.  The transposed solve is solve/linear.py's with
transpose=True: for the assembled ELL operator every Krylov iteration
applies A^T with the ell_spmv_T kernel (csrc/ell_spmv_T.cu) on the card.
With a multigrid factory the solve is preconditioned by its mirrored
cycle on the swapped element blocks (solve/mg.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from calibr8_tpu_torch.fem.adjoint_blocks import adjoint_blocks
from calibr8_tpu_torch.fem.bcs import zero_dbc_rows
from calibr8_tpu_torch.mechanics.global_residual import make_elem_residual
from calibr8_tpu_torch.solve import linear as linear_mod
from calibr8_tpu_torch.utils import timers
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_T


class AdjointStepResult(NamedTuple):
    z: torch.Tensor  # (n_dofs,) global adjoint
    phi: torch.Tensor  # (n_elem, nxi) local adjoint
    f: torch.Tensor  # (n_elem, nde) history for the previous step
    g: torch.Tensor  # (n_elem, nxi) history for the previous step
    grad: torch.Tensor  # (n_sets, n_params) parameter-gradient contribution
    relres: float  # true residual of the transposed solve
    krylov_iters: int


class AdjointSolveError(RuntimeError):
    """A diverged adjoint linear solve (it would silently corrupt dJ/dp)."""


def _scatter(disc, v_eT):
    """Element values (nde, E) -> flat dofs (n_dofs,), summed."""
    out = torch.zeros(disc.n_dofs, dtype=v_eT.dtype, device=v_eT.device)
    return out.index_add_(0, disc.edofs.reshape(-1), v_eT.T.reshape(-1))


class Adjoint:
    """Backward sweep driver:

        adj = Adjoint(problem.assembler, problem.qoi, problem.dbcs, LinearCfg(),
                      mg_factory=problem.mg_factory)
        grad, zs = adj.sweep(traj, params_all, problem.time_grid)

    After a sweep, `step_info` holds each step's relative residual and
    Krylov iteration count (backward order)."""

    def __init__(self, assembler, qoi, dbcs, linear_cfg=None, mg_factory=None):
        self.assembler = assembler
        self.qoi = qoi
        self.dbcs = dbcs
        # multigrid for the transposed solves (the mirrored-sweep cycle,
        # solve/mg.py); pass the problem's mg_factory, as the CLI does
        self.mg_factory = mg_factory
        cfg = linear_cfg or linear_mod.LinearCfg()
        # the reference tightens the Belos tolerance for the adjoint and
        # runs an iterative-refinement loop (adjoint.cpp:41-49,113-180)
        self.linear_cfg = dataclasses.replace(
            cfg, tol=min(cfg.tol, 1e-8), refine_iters=max(cfg.refine_iters, 2)
        )
        self.elem_res = make_elem_residual(assembler.bmodel, assembler.disc.spec)
        self.step_info: list[dict] = []

    def blocks(self, x, x_prev, xi, xi_prev, path, params_all):
        a = self.assembler
        return adjoint_blocks(a.disc, a.bmodel, self.elem_res, x, x_prev, xi, xi_prev, path,
                              params_all)

    def qoi_partials(self, x, x_prev, xi, params_all, aux):
        """dJ/dx (n_dofs,), dJ/dxi (n_elem, nxi), dJ/dp (n_sets, n_params)."""
        if self.qoi is None:
            return torch.zeros_like(x), torch.zeros_like(xi), torch.zeros_like(params_all)
        return self.qoi.partials(x, x_prev, xi, params_all, aux)

    def step(self, x, x_prev, xi, xi_prev, path, params_all, f, g, bc_dofs, aux=()):
        """One backward step (calibr8_tpu's Adjoint._step_impl)."""
        disc = self.assembler.disc
        dev = disc.device
        with timers.phase("adjoint/blocks", dev):
            B = self.blocks(x, x_prev, xi, xi_prev, path, params_all)
            dJ_dx, dJ_dxi, dJ_dp = self.qoi_partials(x, x_prev, xi, params_all, aux)
            # RHS = -dJ/dx + scatter[ f + dxi_dx^T (g - dJ/dxi) ]
            g_modT = (g - dJ_dxi).T  # (nxi, n_elem)
            rhs_eT = f.T + torch.einsum("ije,ie->je", B["dxi_dx_T"], g_modT)
            rhs = zero_dbc_rows(-dJ_dx + _scatter(disc, rhs_eT), bc_dofs)
            # diag of the (untransposed) operator for the DBC row scaling
            J_total_T = B["J_total_T"]
            diag = _scatter(disc, torch.diagonal(J_total_T, 0, 0, 1).T)
        with timers.phase("adjoint/krylov", dev):
            mg, mg_state = self.mg_factory, None
            if self.linear_cfg.precond_reuse == "step" and mg is not None and mg.recursive:
                # the transposed hierarchy state is built apart from the
                # solve (calibr8_tpu solve/adjoint.py:219-235); one solve
                # per step, so it is used once
                mg_state = linear_mod.mg_make_state(self.linear_cfg, J_total_T, disc, diag,
                                                    bc_dofs, mg, transpose=True)
            z, relres, ki = linear_mod.solve_info(
                self.linear_cfg, J_total_T, disc, diag, rhs, bc_dofs, transpose=True,
                return_iters=True, mg=mg, mg_state=mg_state,
            )
        with timers.phase("adjoint/post", dev):
            z_eT = z[disc.edofs].T  # (nde, n_elem)
            rhs_phiT = g_modT - torch.einsum("jie,je->ie", B["dR_dxi_T"], z_eT)
            phiT = gauss_solve_T(B["dC_dxi_T"].transpose(0, 1), rhs_phiT[:, None, :])[:, 0, :]
            f_nextT = -torch.einsum("ije,ie->je", B["dC_dxprev_T"], phiT)
            g_nextT = -torch.einsum("ije,ie->je", B["dC_dxiprev_T"], phiT)
            # parameter gradient: (dC/dp)^T phi + (dR/dp)^T z, summed per
            # element set, + dJ/dp
            grad_e = (torch.einsum("ipe,ie->ep", B["dC_dp_T"], phiT)
                      + torch.einsum("jpe,je->ep", B["dR_dp_T"], z_eT))
            grad = torch.zeros_like(params_all).index_add_(0, disc.es_ids, grad_e) + dJ_dp
        return AdjointStepResult(z=z, phi=phiT.T, f=f_nextT.T, g=g_nextT.T, grad=grad,
                                 relres=relres, krylov_iters=ki)

    def _check_linear(self, relres, step):
        """Belos-status-check analog for the transposed solve: a solve
        that diverged must not feed garbage into dJ/dp."""
        if not np.isfinite(relres) or relres > 0.5:
            raise AdjointSolveError(
                f"adjoint linear solve diverged at step {step} (relative residual {relres:.3e})"
            )

    def sweep(self, traj, params_all, time_grid, bc_dofs=None):
        """Backward over all steps; returns (grad (n_sets, n_params),
        {step: (z, phi)})."""
        a = self.assembler
        disc = a.disc
        nde = disc.spec.ndofs_elem
        opts = dict(dtype=disc.dtype, device=disc.device)
        f = torch.zeros(disc.n_elem, nde, **opts)
        g = torch.zeros(disc.n_elem, a.bmodel.nxi, **opts)
        grad = torch.zeros_like(params_all)
        zs = {}
        self.step_info = []
        for step in range(time_grid.num_steps, 0, -1):
            t = time_grid.time(step)
            bcd = self.dbcs.arrays(t, step)[0] if bc_dofs is None else bc_dofs
            aux = (self.qoi.setup_step(step, t, time_grid.dt(step), time_grid.total_time)
                   if self.qoi is not None else ())
            with timers.phase("adjoint/step", disc.device):
                res = self.step(traj.x[step], traj.x[step - 1], traj.xi[step],
                                traj.xi[step - 1], traj.path[step], params_all, f, g, bcd, aux)
            self._check_linear(res.relres, step)
            self.step_info.append(dict(step=step, relres=res.relres, krylov_iters=res.krylov_iters))
            f, g = res.f, res.g
            grad = grad + res.grad
            zs[step] = (res.z, res.phi)
        return grad, zs
