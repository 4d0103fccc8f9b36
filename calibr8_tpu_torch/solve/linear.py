"""Linear solves for the element-Jacobian system.

The counterpart of calibr8_tpu's solve/linear.py (the reference's Belos
Block GMRES with a Teko block Gauss-Seidel preconditioner,
linear_solve.cpp:36-123): a dense direct path for small systems, and
right-preconditioned GMRES(m) with manual restarts from the true
residual (or PCG).  The Krylov operator is the assembled node-block ELL
matrix (solve/ellpack.py) unless LinearCfg.operator == "ebe", which
applies the element Jacobians directly (fem/ebe_matvec.py); on the card
each is a CUDA kernel, on the CPU its plain version.  The transposed
solves of the adjoint apply A^T of the same assembled matrix (the
ell_spmv_T kernel), or the EBE kernel on transposed element blocks.
Given a multigrid factory (solve/mg.py), GMRES is preconditioned with
its cycle instead of block Gauss-Seidel, built from the (transposed)
element blocks per solve, or from a state built once per Newton step
(LinearCfg.precond_reuse "step", mg_make_state).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from calibr8_tpu_torch.fem.assembly import dense_matrix, ebe_matvec_T
from calibr8_tpu_torch.fem.bcs import apply_dbcs_dense, apply_dbcs_matvec
from calibr8_tpu_torch.solve.ellpack import EllOperator
from calibr8_tpu_torch.solve.gmres import gmres_cycle, pcg
from calibr8_tpu_torch.solve.precond import BlockJacobiGS
from calibr8_tpu_torch.utils import timers


@dataclass(frozen=True)
class LinearCfg:
    method: str = "auto"  # auto | dense | gmres | cg
    tol: float = 1e-6
    max_iters: int = 200
    restart: int = 200
    dense_cutoff: int = 6000
    # 'block_gs' (u/p block Gauss-Seidel, node-block Jacobi) or 'jacobi'
    preconditioner: str = "block_gs"
    # 'auto' = assembled node-block ELL; 'ebe' = element-by-element apply
    operator: str = "auto"
    # restart cycles (GMRES) or correction solves (CG) beyond the
    # max_iters budget: the adjoint solve's refinement loop
    # (adjoint.cpp:113-180); Adjoint asks for at least 2
    refine_iters: int = 0
    # multigrid hierarchy reuse (the MueLu reuse discipline): 'none'
    # rebuilds the cycle's coarse arrays in every solve; 'step' builds
    # them once per Newton step from its first Jacobian (mg_make_state)
    # and lags them across the step's iterations, while the fine
    # operator stays current and convergence is checked on the true
    # residual.  Deck: linear algebra: {preconditioner reuse: step}
    precond_reuse: str = "none"


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(v))


def mg_make_state(cfg: LinearCfg, J_T, disc, diag, bc_dofs, mg, transpose: bool = False):
    """The multigrid state for solve_info(mg_state=...), built with the
    operator and element blocks solve_info would use (calibr8_tpu
    solve/linear.py:74-100): the transposed system's blocks are swapped
    before the hierarchy sees them."""
    op_T = J_T.transpose(0, 1) if transpose else J_T
    op = _operator(cfg, J_T, disc, diag, bc_dofs, transpose)
    with timers.phase("mg/state", disc.device):
        return mg.make_state(op_T, diag, bc_dofs, op, transpose=transpose)


def solve_info(cfg: LinearCfg, J_T, disc, diag, b, bc_dofs, transpose: bool = False,
               return_iters: bool = False, mg=None, mg_state=None):
    """Solve J x = b with Dirichlet rows replaced by diag * x_row = b_row;
    J_T (nde, nde, E) element Jacobians.  transpose=True solves J^T x = b
    (the adjoint system: transpose first, then eliminate rows).  `mg`, a
    multigrid factory, preconditions the Krylov solve with its cycle
    (from `mg_state` when given); the dense path ignores it.

    Returns (x, relres) with relres = ||b - J x|| / ||b|| from the true
    residual (the Belos status-check analog), plus the total Krylov
    iteration count with return_iters."""
    n_dofs = disc.n_dofs
    method = cfg.method
    if method == "auto":
        method = "dense" if n_dofs <= cfg.dense_cutoff else "gmres"
    op_T = J_T.transpose(0, 1) if transpose else J_T
    norm_b = _norm(b)
    safe_nb = norm_b if norm_b > 0 else 1.0

    if method == "dense":
        A = dense_matrix(op_T.permute(2, 0, 1), disc.edofs, n_dofs)
        A = apply_dbcs_dense(A, diag, bc_dofs)
        x = torch.linalg.solve(A, b)
        rr = _norm(b - A @ x) / safe_nb
        return (x, rr, 0) if return_iters else (x, rr)
    if method not in ("gmres", "cg"):
        raise NotImplementedError(f"linear algebra method {method!r} is not ported")

    op, M = _gmres_setup(cfg, J_T, disc, diag, bc_dofs, transpose, mg, mg_state)

    if method == "cg":
        x, _ = pcg(op, b, M, cfg.tol, cfg.max_iters)
        for _ in range(cfg.refine_iters):
            r = b - op(x)
            if _norm(r) <= cfg.tol * norm_b:
                break
            dx, _ = pcg(op, r, M, cfg.tol, cfg.max_iters)
            cand = x + dx
            if bool(torch.isfinite(cand).all()):
                x = cand
        rr = _norm(b - op(x)) / safe_nb
        return (x, rr, 0) if return_iters else (x, rr)

    # GMRES with MANUAL restarts (calibr8_tpu solve/linear.py:197-271):
    # each cycle starts from the TRUE residual with an in-cycle target
    # one digit below the outer atol; a non-improving or non-finite
    # cycle is dropped; after a no-progress cycle the next one runs full
    # length (early exit off); two consecutive no-progress cycles end the
    # solve.  max_iters counts the inner iterations of the first
    # ceil(max_iters / restart) cycles; refine_iters cycles more may
    # follow.  RIGHT preconditioning keeps the minimization in the true
    # residual norm.
    restart = min(cfg.restart, n_dofs)
    n_outer = max(1, -(-cfg.max_iters // restart)) + cfg.refine_iters
    atol = cfg.tol * norm_b

    def opM(v):
        return op(M(v))

    x = torch.zeros_like(b)
    stag, ki = 0, 0
    for _ in range(n_outer):
        r = b - op(x)
        rn = _norm(r)
        cyc_atol = 0.0 if stag > 0 else 0.1 * atol
        dy, _, k_used = gmres_cycle(opM, r, restart, cyc_atol)
        ki += k_used
        cand = x + M(dy)
        rn_new = _norm(b - op(cand))
        better = np.isfinite(rn_new) and rn_new < rn
        if better:
            x = cand
        progress = better and rn_new <= 0.95 * rn
        stag = 0 if progress else stag + 1
        if min(rn_new, rn) <= atol or stag >= 2:
            break
    relres = _norm(b - op(x)) / safe_nb
    return (x, relres, ki) if return_iters else (x, relres)


def _operator(cfg, J_T, disc, diag, bc_dofs, transpose):
    """The Krylov operator.  The ELL operator assembles the forward J_T
    either way and applies A^T with the ell_spmv_T kernel when
    transposed; the EBE operator applies the transposed element blocks
    (a transposed copy of J_T)."""
    if cfg.operator != "ebe":
        return EllOperator(disc, J_T, diag, bc_dofs, transpose=transpose)
    op_T = J_T.transpose(0, 1).contiguous() if transpose else J_T

    def op(v):
        return apply_dbcs_matvec(ebe_matvec_T(op_T, disc, v), diag, v, bc_dofs)

    return op


def _gmres_setup(cfg, J_T, disc, diag, bc_dofs, transpose, mg=None, mg_state=None):
    """Krylov operator + preconditioner."""
    op = _operator(cfg, J_T, disc, diag, bc_dofs, transpose)
    if mg is not None:
        # the multigrid cycle of the (transposed) element blocks
        op_T = J_T.transpose(0, 1) if transpose else J_T
        with timers.phase("mg/make", disc.device):
            M = mg.make(op_T, diag, bc_dofs, op, transpose=transpose, state=mg_state)
    elif cfg.preconditioner == "block_gs":
        # transpose solves use the TRANSPOSED forward preconditioner
        M = BlockJacobiGS(disc, J_T, diag, bc_dofs, transpose=transpose)
    elif cfg.preconditioner == "jacobi":
        safe_diag = torch.where(diag.abs() > 1e-300, diag, torch.ones_like(diag))

        def M(v):
            return v / safe_diag

    else:
        raise NotImplementedError(
            f"preconditioner {cfg.preconditioner!r} is not ported: geometric multigrid "
            "comes as a factory (solve/mg.py, Problem.mg_factory); aggregation AMG "
            "(solve/amg.py's AMGPrecondFactory) is not ported yet"
        )
    return op, M
