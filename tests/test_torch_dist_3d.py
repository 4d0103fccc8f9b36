"""The port's domain-decomposed solver in 3D mixed u/p (ndpn 4, the
finite-deformation hyper_J2, which reads x_prev) on cube n=2 at 4 parts,
float64 on the CPU, against calibr8_tpu's DistContext:

 - the assembly at a state made with numpy from a seed (x != x_prev, some
   elements plastic): xi and R to 1e-12 of their max, the element
   Jacobians to 1e-11, path and nfail equal;
 - J of a 2-step DistPrimal to 1e-10.

calibr8_tpu's shard_map assembly is called under jax.jit (eager, it runs
op by op for minutes); this file holds two tests."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.parallel.dist import DistContext as JaxDistContext
from calibr8_tpu.parallel.dist import DistPrimal as JaxDistPrimal
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.parallel.dist import DistContext, DistPrimal
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_3D, CUBE, HYPER_MAT, make_deck
from tests.test_torch_hyper_assembly import hyper_state, hyper_xi_prev

DECK = make_deck(CUBE, "hyper_J2", HYPER_MAT, BCS_3D(0.01), 2)
P = 4


@pytest.fixture(scope="module")
def pair():
    jp = JaxProblem(jax_load_deck(copy.deepcopy(DECK)))
    tp = Problem(load_deck(copy.deepcopy(DECK)), device="cpu")
    return jp, JaxDistContext(jp, n_parts=P), tp, DistContext(tp, n_parts=P)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_dist_hyper_assembly_matches_calibr8_tpu(pair):
    jp, jc, tp, tc = pair
    disc = tp.disc
    coords = disc.mesh.coords
    x = hyper_state(coords, disc.n_nodes, 3, True, 0.02, seed=0)
    xp = hyper_state(coords, disc.n_nodes, 3, True, 0.01, seed=2)
    xi0 = hyper_xi_prev(tp.model, disc.n_elem)
    ref = jax.jit(jc.assemble)(jc.to_dist(jnp.asarray(x)), jc.to_dist(jnp.asarray(xp)),
                               jc.to_dist_elem(xi0), jp.params0)
    R, J_T, diag, xi, path, nfail = tc.assemble(
        tc.to_dist(torch.tensor(x)), tc.to_dist(torch.tensor(xp)),
        tc.to_dist_elem(torch.tensor(xi0)), tp.params0)
    assert _rel(tc.from_dist_elem(xi), jc.from_dist_elem(ref[3])) <= 1e-12
    assert _rel(tc.from_dist(R), jc.from_dist(ref[0])) <= 1e-12
    # the port's (nde, nde, P * E_loc) -> calibr8_tpu's (P, nde, nde, E_loc)
    nde, E = tc.nde, tc.part.E_loc
    assert _rel(J_T.reshape(nde, nde, P, E).permute(2, 0, 1, 3), ref[1]) <= 1e-11
    np.testing.assert_array_equal(tc.from_dist_elem(path).numpy(),
                                  np.asarray(jc.from_dist_elem(ref[4])))
    assert 0 < int(path.sum()) < disc.n_elem, "single-branch state"
    assert int(nfail) == int(ref[5]) == 0


def test_dist_hyper_primal_matches_calibr8_tpu(pair):
    jp, jc, tp, tc = pair
    ref = JaxDistPrimal(jc).run()
    traj = DistPrimal(tc).run()
    np.testing.assert_allclose(traj["qoi_values"], ref["qoi_values"], rtol=1e-10)
    np.testing.assert_allclose(np.sum(traj["qoi_values"]), np.sum(ref["qoi_values"]), rtol=1e-10)
