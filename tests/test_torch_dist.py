"""The port's domain-decomposed solver (calibr8_tpu_torch/parallel/dist.py)
against calibr8_tpu's DistContext on notch2D h=0.22, small_J2 (2D mixed
u/p, ndpn 3), 8 parts, float64 on the CPU (the plain versions of kernel
1c and of 3c per part), through the global views from_dist /
from_dist_elem:

 - assemble (R, diag, xi, path, nfail) at a state made with numpy from a
   seed, matvec (EBE), ell_matvec (the per-part ELL apply and its
   Export-ADD), halo_gather and make_precond's apply, forward and
   transposed, each to 1e-12 of its max;
 - DistPrimal x and J to 1e-10, and DistAdjoint dJ/dp with tol 1e-13 and
   3 refinement cycles to 1e-10 of its max, as tests/test_dist.py:113-143
   holds calibr8_tpu's dist path against its single-device one.

calibr8_tpu's side runs on the 8 host devices of tests/conftest.py, its
shard_map operators under jax.jit (eager, they run op by op for
minutes); its DistContext takes ~3 s to build and its primal and adjoint
~9 s each, so this file holds two tests."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.parallel.dist import DistAdjoint as JaxDistAdjoint
from calibr8_tpu.parallel.dist import DistContext as JaxDistContext
from calibr8_tpu.parallel.dist import DistPrimal as JaxDistPrimal
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.parallel.dist import DistAdjoint, DistContext, DistPrimal
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, J2_MAT, make_deck

DECK = make_deck({"type": "notch2D", "h": 0.22}, "small_J2", J2_MAT, BCS_2D(0.001), 2)
P = 8


@pytest.fixture(scope="module")
def pair():
    jp = JaxProblem(jax_load_deck(copy.deepcopy(DECK)))
    tp = Problem(load_deck(copy.deepcopy(DECK)), device="cpu")
    return jp, JaxDistContext(jp, n_parts=P), tp, DistContext(tp, n_parts=P)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def test_dist_operators_match_calibr8_tpu(pair):
    jp, jc, tp, tc = pair
    disc = tp.disc
    rng = np.random.default_rng(0)
    x = 1e-3 * rng.standard_normal(disc.n_dofs)
    xp = 1e-4 * rng.standard_normal(disc.n_dofs)
    xi0 = np.tile(np.asarray(jp.assembler.model.init_xi())[None], (disc.n_elem, 1))
    ref = jax.jit(jc.assemble)(jc.to_dist(jnp.asarray(x)), jc.to_dist(jnp.asarray(xp)),
                               jc.to_dist_elem(xi0), jp.params0)
    R, J_T, diag, xi, path, nfail = tc.assemble(
        tc.to_dist(torch.tensor(x)), tc.to_dist(torch.tensor(xp)),
        tc.to_dist_elem(torch.tensor(xi0)), tp.params0)
    assert _close(tc.from_dist(R), jc.from_dist(ref[0]), 1e-12)
    assert _close(tc.from_dist(diag), jc.from_dist(ref[2]), 1e-12)
    assert _close(tc.from_dist_elem(xi), jc.from_dist_elem(ref[3]), 1e-12)
    np.testing.assert_array_equal(tc.from_dist_elem(path).numpy(),
                                  np.asarray(jc.from_dist_elem(ref[4])))
    assert 0 < int(path.sum()) < disc.n_elem, "single-branch state"
    assert int(nfail) == int(ref[5]) == 0

    v = rng.standard_normal(disc.n_dofs)
    vd, jvd = tc.to_dist(torch.tensor(v)), jc.to_dist(jnp.asarray(v))
    assert _close(tc.from_dist(tc.matvec(J_T, vd)),
                  jc.from_dist(jax.jit(jc.matvec)(ref[1], jvd)), 1e-12)
    A_T = tc.ell_assemble(J_T)
    assert _close(tc.from_dist(tc.ell_matvec(A_T, vd)),
                  jc.from_dist(jax.jit(lambda J, v: jc.ell_matvec(jc.ell_assemble(J), v))(
                      ref[1], jvd)), 1e-12)
    # halo_gather on arbitrary owned values, pads included
    V = rng.standard_normal((P, tc.part.N_own, 3))
    assert _close(tc.halo_gather(torch.tensor(V)), jax.jit(jc.halo_gather)(jnp.asarray(V)),
                  1e-12)
    bc_mask, _ = tc.bc_dist(*tp.dbcs.arrays(1.0, 1))
    jbc_mask, _ = jc.bc_dist(*jp.dbcs.arrays(1.0, 1))
    np.testing.assert_array_equal(bc_mask.numpy(), np.asarray(jbc_mask))
    for transpose in (False, True):
        M = tc.make_precond(J_T, diag, bc_mask, transpose=transpose)
        jM = jax.jit(lambda J, d, m, r, t=transpose: jc.make_precond(J, d, m, transpose=t)(r))
        assert _close(M(torch.tensor(V)), jM(ref[1], ref[2], jbc_mask, jnp.asarray(V)),
                      1e-12), transpose


def test_dist_primal_and_adjoint_match_calibr8_tpu(pair):
    jp, jc, tp, tc = pair
    ref = JaxDistPrimal(jc).run()
    traj = DistPrimal(tc).run()
    assert _close(tc.from_dist(traj["x"][-1]), jc.from_dist(ref["x"][-1]), 1e-10)
    np.testing.assert_allclose(traj["qoi_values"], ref["qoi_values"], rtol=1e-10)

    tight = dataclasses.replace(jp.step_solver.cfg.linear, tol=1e-13, refine_iters=3)
    g_ref, _ = JaxDistAdjoint(jc, linear_cfg=tight).sweep(ref, jp.params0, jp.time_grid)
    tight_t = dataclasses.replace(tp.step_solver.cfg.linear, tol=1e-13, refine_iters=3)
    g, _ = DistAdjoint(tc, linear_cfg=tight_t).sweep(traj, tp.params0, tp.time_grid)
    assert _close(g, g_ref, 1e-10)
