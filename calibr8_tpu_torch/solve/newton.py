"""Global Newton solve with backtracking Armijo line search.

The counterpart of calibr8_tpu's solve/newton.py (reference primal
Newton loop, source/calibr8/src/primal.cpp:31-209, and its line search,
line_search.hpp): merit phi = 1/2 ||R||^2, base slope -||R_0||^2, trial
slope R(alpha) . (A(alpha) dx), Hermite-cubic backtracking with
safeguards, and contraction on failed local solves.

The local state is re-solved at every residual evaluation (the fused
assembly returns it), so the merit is a pure function of alpha; each
Newton iteration reuses the line search's accepted-trial assembly as its
base assembly.  The assembly is the fused kernel on the card (its plain
version on the CPU), the slope's matvec the EBE kernel.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from calibr8_tpu_torch.fem.assembly import ebe_matvec_T
from calibr8_tpu_torch.fem.bcs import apply_dbcs_matvec, apply_dbcs_residual
from calibr8_tpu_torch.solve import linear as linear_mod
from calibr8_tpu_torch.utils import timers


@dataclass
class LineSearchParams:
    """Deck sublist 'line search' (line_search.hpp:25-38)."""

    c1: float = 1.0e-4
    backtrack_min: float = 0.5
    backtrack_max: float = 0.9
    max_evals: int = 4


@dataclass
class NewtonCfg:
    max_iters: int = 15
    abs_tol: float = 1e-8
    rel_tol: float = 1e-8
    print_convergence: bool = False
    linear: linear_mod.LinearCfg = field(default_factory=linear_mod.LinearCfg)
    line_search: LineSearchParams = field(default_factory=LineSearchParams)


def _cubic_min(phi_0, dphi_0, a, phi, slope_a):
    """Two-point Hermite cubic minimizer (line_search.hpp:59-76)."""
    d1 = dphi_0 + slope_a - 3.0 * (phi_0 - phi) / (0.0 - a)
    radicand = d1 * d1 - dphi_0 * slope_a
    if radicand < 0.0:
        return 0.5 * a
    d2 = np.sqrt(radicand)
    denom = slope_a - dphi_0 + 2.0 * d2
    if denom == 0.0:
        return 0.5 * a
    return a - a * (slope_a + d2 - d1) / denom


class NewtonSolveError(RuntimeError):
    pass


class StepSolver:
    """Solves one pseudo-time step: R(x; x_prev, xi(x), p) = 0."""

    def __init__(self, assembler, cfg: NewtonCfg):
        self.assembler = assembler
        self.cfg = cfg
        # Krylov iterations of each linear solve of the last step
        self.krylov_iters: list[int] = []

    def _assemble(self, x, x_prev, xi_prev, params, bc_dofs, bc_vals, ext_force):
        R, J_T, diag, xi, path, nfail = self.assembler.assemble(x, xi_prev, params,
                                                                x_prev=x_prev)
        R_bc = apply_dbcs_residual(R - ext_force, diag, x, bc_dofs, bc_vals)
        return dict(
            xi=xi, path=path, nfail=int(nfail), R=R_bc, J_T=J_T, diag=diag,
            norm=float(torch.linalg.vector_norm(R_bc)),
        )

    def _slope(self, J_T, diag, R, dx, bc_dofs) -> float:
        Adx = apply_dbcs_matvec(ebe_matvec_T(J_T, self.assembler.disc, dx), diag, dx, bc_dofs)
        return float(torch.dot(R, Adx))

    def _linear_solve(self, base, bc_dofs):
        """Solve J dx = -R."""
        dx, relres, ki = linear_mod.solve_info(
            self.cfg.linear, base["J_T"], self.assembler.disc, base["diag"], -base["R"],
            bc_dofs, return_iters=True,
        )
        self.krylov_iters.append(ki)
        return self._check_linear(dx, relres)

    def _check_linear(self, dx, relres):
        """Belos-status-check analog (linear_solve.cpp:106-123): a diverged
        or non-finite Krylov solve must not feed the Newton update
        (primal.cpp:163-195)."""
        if not np.isfinite(relres) or relres > 0.5:
            raise NewtonSolveError(f"linear solve diverged (relative residual {relres:.3e})")
        if self.cfg.print_convergence and relres > 10.0 * self.cfg.linear.tol:
            print(f" > linear solve: loose relative residual {relres:.3e}")
        return dx

    def solve_at_step(self, x, x_prev, xi_prev, params, bc_dofs, bc_vals, ext_force,
                      step: int = 0):
        """Returns (x, xi, path, info); raises NewtonSolveError on failure
        (primal.cpp:99-104, 183-191, 203-207).  x_prev is the previous
        step's solution, which the finite-deformation twins read."""
        cfg = self.cfg
        do_print = cfg.print_convergence
        dev = self.assembler.disc.device
        t0 = time.perf_counter()
        self.krylov_iters = []
        if do_print:
            print(f"ON PRIMAL STEP ({step})")

        with timers.phase("primal/assemble", dev):
            base = self._assemble(x, x_prev, xi_prev, params, bc_dofs, bc_vals, ext_force)
        if base["nfail"] > 0:
            raise NewtonSolveError(f"primal step {step}: local solve failed at the base point")

        converged = False
        resid_norm_0 = 1.0
        it = 1
        while it <= cfg.max_iters:
            if do_print:
                print(f" > ({it}) Newton iteration")
            abs_norm = base["norm"]
            if it == 1:
                resid_norm_0 = abs_norm
            rel_norm = abs_norm / max(resid_norm_0, 1e-300)
            if do_print:
                print(f" > absolute ||R|| = {abs_norm:e}")
                print(f" > relative ||R|| = {rel_norm:e}")
            if abs_norm < cfg.abs_tol or rel_norm < cfg.rel_tol:
                converged = True
                break

            with timers.phase("primal/linear_solve", dev):
                dx = self._linear_solve(base, bc_dofs)

            # --- Armijo backtracking line search (line_search.hpp) ---
            ls = cfg.line_search
            phi_0 = 0.5 * abs_norm * abs_norm
            dphi_0 = -2.0 * phi_0
            armijo_slope = ls.c1 * dphi_0
            alpha = 1.0
            best = None  # (phi, alpha, assembled state)
            accepted = None
            for n in range(1, ls.max_evals + 1):
                with timers.phase("primal/assemble", dev):
                    trial = self._assemble(
                        x + alpha * dx, x_prev, xi_prev, params, bc_dofs, bc_vals, ext_force
                    )
                if trial["nfail"] > 0:
                    alpha *= 0.5
                    continue
                tn = trial["norm"]
                phi = 0.5 * tn * tn
                if best is None or phi < best[0]:
                    best = (phi, alpha, trial)
                if phi <= phi_0 + alpha * armijo_slope:
                    accepted = (alpha, trial)
                    if do_print and n > 1:
                        print(f" > line search: alpha = {alpha:.3e} ({n} evals)")
                    break
                with timers.phase("primal/slope", dev):
                    slope = self._slope(trial["J_T"], trial["diag"], trial["R"], dx, bc_dofs)
                alpha_model = _cubic_min(phi_0, dphi_0, alpha, phi, slope)
                alpha = min(max(alpha_model, ls.backtrack_min * alpha), ls.backtrack_max * alpha)

            if accepted is None:
                if best is None:
                    raise NewtonSolveError(
                        f"primal step {step}, Newton iter {it}: line search could not "
                        "assemble at any trial step (local solve diverged)"
                    )
                if do_print:
                    print(f" > line search: reached max evals, alpha = {best[1]:.3e}")
                accepted = (best[1], best[2])

            alpha, base = accepted
            x = x + alpha * dx
            it += 1

        if not converged:
            raise NewtonSolveError(f"Newton's method failed in {cfg.max_iters} iterations")
        # host wall time of the step; the final norm was read back, so
        # the card has finished the step's work
        info = dict(iterations=it, resid_norm=base["norm"], krylov_iters=list(self.krylov_iters),
                    seconds=time.perf_counter() - t0)
        return x, base["xi"], base["path"], info
