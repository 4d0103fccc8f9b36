"""The recursive multigrid V-cycle (3 or more refinements; calibr8_tpu_torch/
solve/mg.py) against calibr8_tpu's on the smallest mixed notch2D deck that
routes to it (h=0.3 refined 3 times, 1,536 elements, small_J2), float64:
M(r) forward and transposed on the same element Jacobians, its
`precond reuse: step` state, and the adjoint gradient under reuse `step`
against `none`.  calibr8_tpu's recursive cycle costs ~30 s to trace, once
per direction; the file holds two tests so that the test run's loadfile
queue runs it beside the slow files."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.adjoint import Adjoint
from tests.test_torch_mg_composite import (
    assert_blocks_close, mg_deck, mg_system, preconditioners,
)


def test_recursive_cycle_matches_jax():
    """M(r) to 1e-11 of each block's max|z|, forward and transposed; M built
    from make_state (the reuse-step state) equals M built in one go."""
    s = mg_system(mg_deck(0.3, 3))
    tp = s["tp"]
    mg = tp.mg_factory
    assert mg.recursive and tp.disc.spec.mixed
    r = s["r"]
    for transpose in (False, True):
        M_j, _, M_t, op = preconditioners(s, transpose)
        z_t = M_t(torch.tensor(r))
        assert_blocks_close(z_t.numpy(), np.asarray(M_j(jnp.asarray(r))), tp.disc.n_dofs_u, 1e-11)
        J = s["J_T"].transpose(0, 1) if transpose else s["J_T"]
        state = mg.make_state(J, s["diag"], s["bc"], op, transpose=transpose)
        z_s = mg.make(J, s["diag"], s["bc"], op, transpose=transpose, state=state)(torch.tensor(r))
        assert torch.allclose(z_s, z_t, rtol=0, atol=1e-13 * float(z_t.abs().max()))


def test_adjoint_precond_reuse_step_matches_none():
    """The adjoint sweep with `preconditioner reuse: step` (the transposed
    hierarchy state built apart from the solve) gives the reuse-none
    gradient to 1e-9 of its scale (tests/test_adjoint_mg.py:163-197, on
    the port alone); every transposed solve reaches its tolerance."""
    prob = Problem(load_deck(mg_deck(0.3, 3, tolerance=1e-10)), device="cpu")
    assert prob.mg_factory.recursive
    traj = prob.solve_primal()
    grads = {}
    for reuse in ("none", "step"):
        cfg = dataclasses.replace(prob.step_solver.cfg.linear, tol=1e-10, precond_reuse=reuse)
        adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, cfg, mg_factory=prob.mg_factory)
        g, _ = adj.sweep(traj, prob.params0, prob.time_grid)
        assert all(0 < s["krylov_iters"] and s["relres"] <= 1e-10 for s in adj.step_info)
        grads[reuse] = g.numpy()
    scale = max(np.abs(grads["none"]).max(), 1.0)
    np.testing.assert_allclose(grads["step"], grads["none"], rtol=0, atol=1e-9 * scale)
