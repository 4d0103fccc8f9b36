"""The adjoint and the domain-decomposed solver with the aggregation AMG
(calibr8_tpu_torch/solve/amg.py, parallel/dist_mg.py), float64 on the
CPU (the plain versions of the kernels), on tests/test_adjoint_mg.py's
deck (notch2D h=0.25 refined once, small_J2, mixed u/p, GMRES at 1e-12,
`preconditioner: amg`):

 - dJ/dp through the port's Adjoint with the mirrored AMG cycle against
   calibr8_tpu's with its own, on the port's AMG primal trajectory, within
   1e-8 of max|dJ/dp|, every linear solve at its tolerance;
 - DistAMG at 4 parts: M(r), forward and transposed, against calibr8_tpu's
   DistAMG under jax.jit on the same dist state, within 1e-10 of each
   block's max; DistPrimal's x and J within 1e-10 and DistAdjoint's dJ/dp
   within 1e-10 of max of the port's single-device AMG run (tests/
   test_adjoint_mg.py:134 and tests/test_dist_mg.py:35 hold calibr8_tpu's
   dist path to its single-device one the same way).

calibr8_tpu's smoothers run on the port's number of power iterations
(amg.LMAX_ITERS; tests/test_torch_amg.py)."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.parallel import dist_mg as jax_dist_mg
from calibr8_tpu.parallel.dist import DistContext as JaxDistContext
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve import amg as jax_amg
from calibr8_tpu.solve.adjoint import Adjoint as JaxAdjoint
from calibr8_tpu.solve.primal import Trajectory as JaxTrajectory
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.parallel.dist import DistAdjoint, DistContext, DistPrimal
from calibr8_tpu_torch.parallel.dist_mg import DistAMG
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.adjoint import Adjoint
from calibr8_tpu_torch.solve.amg import LMAX_ITERS, AMGPrecondFactory
from tests.decks import BCS_2D, J2_MAT, make_deck
from tests.test_torch_mg_composite import assert_blocks_close


@pytest.fixture(autouse=True)
def jax_lmax_iters(monkeypatch):
    """calibr8_tpu's smoothers, single-device and dist, on the port's number
    of power iterations (tests/test_torch_amg.py, ROADMAP.md queue 3)."""
    fn = functools.partial(jax_amg._power_lmax, iters=LMAX_ITERS)
    monkeypatch.setattr(jax_amg, "_power_lmax", fn)
    monkeypatch.setattr(jax_dist_mg, "_power_lmax", fn)


def amg_adjoint_deck(num_steps=1):
    deck = make_deck({"type": "notch2D", "h": 0.25, "refinements": 1}, "small_J2", J2_MAT,
                     BCS_2D(0.001), num_steps)
    deck["linear algebra"] = {"preconditioner": "amg", "method": "gmres", "tolerance": 1e-12}
    return deck


def tight(cfg):
    return dataclasses.replace(cfg, tol=1e-12, refine_iters=3)


def test_adjoint_gradient_with_amg_matches_jax():
    """Both sweeps run on the port's primal trajectory (GMRES with the AMG
    cycle at 1e-12): calibr8_tpu's AMG primal would take half a minute
    more here, for the same states to ~1e-12."""
    deck = amg_adjoint_deck()
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    assert isinstance(tp.mg_factory, AMGPrecondFactory)
    traj = tp.solve_primal()
    assert all(k > 0 and rr <= 1e-12 for info in traj.newton_info
               for k, rr in zip(info["krylov_iters"], info["linear_relres"]))
    adj = Adjoint(tp.assembler, tp.qoi, tp.dbcs, tight(tp.step_solver.cfg.linear),
                  mg_factory=tp.mg_factory)
    g_t, _ = adj.sweep(traj, tp.params0, tp.time_grid)
    assert all(0 < s["krylov_iters"] and s["relres"] <= 1e-12 for s in adj.step_info)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    jadj = JaxAdjoint(jp.assembler, jp.qoi, jp.dbcs, tight(jp.step_solver.cfg.linear),
                      mg_factory=jp.mg_factory)
    jtraj = JaxTrajectory(*([jnp.asarray(a.numpy()) for a in seq]
                            for seq in (traj.x, traj.xi, traj.path)), list(traj.qoi_values))
    g_j, _ = jadj.sweep(jtraj, jp.params0, jp.time_grid)
    g_j = np.asarray(g_j)
    err = np.abs(g_t.numpy() - g_j).max() / np.abs(g_j).max()
    assert err <= 1e-8, err


def test_dist_amg_cycle_primal_and_adjoint():
    deck = amg_adjoint_deck()
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    tc = DistContext(tp, n_parts=4)
    assert isinstance(tc._mg, DistAMG) and tc._mg.factory is tp.mg_factory
    disc = tp.disc

    # M(r) against calibr8_tpu's DistAMG on the same state (its cycle
    # built and applied under one jax.jit)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    jc = JaxDistContext(jp, n_parts=4)
    rng = np.random.default_rng(0)
    x = 1e-3 * rng.standard_normal(disc.n_dofs)
    xi0 = np.tile(np.asarray(jp.assembler.model.init_xi())[None], (disc.n_elem, 1))
    ref = jax.jit(jc.assemble)(jc.to_dist(jnp.asarray(x)), jc.to_dist(jnp.asarray(x)),
                               jc.to_dist_elem(xi0), jp.params0)
    _, J_T, diag, _, _, _ = tc.assemble(tc.to_dist(torch.tensor(x)), tc.to_dist(torch.tensor(x)),
                                        tc.to_dist_elem(torch.tensor(xi0)), tp.params0)
    bc_dofs = tp.dbcs.arrays(1.0, 1)[0]
    bc_t, _ = tc.bc_dist(bc_dofs, torch.zeros(len(bc_dofs), dtype=torch.float64))
    bc_j, _ = jc.bc_dist(jnp.asarray(bc_dofs.numpy()), jnp.zeros(len(bc_dofs)))
    r = rng.standard_normal(disc.n_dofs)
    n_u = disc.n_dofs_u
    for transpose in (False, True):
        J_j = ref[1].swapaxes(1, 2) if transpose else ref[1]
        J_tt = J_T.transpose(0, 1).contiguous() if transpose else J_T

        def apply_j(rd, J_j=J_j, transpose=transpose):
            def op(v):
                return jnp.where(bc_j, ref[2] * v, jc.matvec(J_j, v))

            return jc._mg.make(J_j, ref[2], bc_j, op, transpose=transpose)(rd)

        def op_t(v, J_tt=J_tt):
            return torch.where(bc_t, diag * v, tc.matvec(J_tt, v))

        z_j = np.asarray(jc.from_dist(jax.jit(apply_j)(jc.to_dist(jnp.asarray(r)))))
        M_t = tc._mg.make(J_tt, diag, bc_t, op_t, transpose=transpose)
        z_t = tc.from_dist(M_t(tc.to_dist(torch.tensor(r)))).numpy()
        assert_blocks_close(z_t, z_j, n_u, 1e-10)

    # the dist primal and adjoint against the port's single-device run
    traj_s = tp.solve_primal()
    adj = Adjoint(tp.assembler, tp.qoi, tp.dbcs, tight(tp.step_solver.cfg.linear),
                  mg_factory=tp.mg_factory)
    g_s, _ = adj.sweep(traj_s, tp.params0, tp.time_grid)
    traj_d = DistPrimal(tc).run()
    x_s = traj_s.x[-1].numpy()
    x_d = tc.from_dist(traj_d["x"][-1]).numpy()
    assert np.abs(x_d - x_s).max() <= 1e-10 * np.abs(x_s).max()
    J_d = sum(traj_d["qoi_values"])
    assert abs(J_d - traj_s.J) <= 1e-10 * abs(traj_s.J)
    dadj = DistAdjoint(tc, linear_cfg=tight(tp.step_solver.cfg.linear))
    g_d, _ = dadj.sweep(traj_d, tp.params0, tp.time_grid)
    assert all(s["relres"] <= 1e-12 for s in dadj.step_info)
    g_s = g_s.numpy()
    assert np.abs(g_d.numpy() - g_s).max() <= 1e-10 * np.abs(g_s).max()
