"""The implicit-mode fused assembly of the hypo_hill plane twins
(hypo_hill_plane_strain, mixed u/p; hypo_hill_plane_stress, displacement
only with the material rotation Q and the z-stretch PK1 rows) in its
plain version (the CPU path, and the oracle the CUDA kernel is held to on
the card) against calibr8_tpu's fused Pallas kernel in interpret mode, on
notch2D h=0.3 at the twin cases' constants, float64.

The state is tests/test_torch_hyper_assembly.py's: x and x_prev differ
(the unrotated rate reads (F - F_prev) F^-1), xi_prev is the initial state
(lambda_z = 1) plus a small perturbation with alpha >= 0, and some
elements yield.  Tolerances: path and nfail equal; xi and R to 1e-12 of
their max, J and diag to 1e-11 of max|J|.  Each case runs calibr8_tpu's
interpret-mode kernel (~30 s), so this file holds two tests and runs
beside tests/test_dist_pallas.py under xdist's loadfile queue."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem import pallas_assembly
from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu.models.twin_cases import case_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import FusedAssembler
from calibr8_tpu_torch.problem import Problem
from tests.test_torch_hyper_assembly import _rel, hyper_state

TWINS = {c[0]: c for c in TWIN_CASES}


def hypo_xi_prev(model, n_elem, alpha_idx, seed=1):
    """The model's initial state plus 1e-4 noise, alpha >= 0."""
    nxi = len(model.init_xi())
    xi = np.tile(model.init_xi(), (n_elem, 1)) + 1e-4 * np.random.default_rng(seed).standard_normal(
        (n_elem, nxi))
    xi[:, alpha_idx] = np.abs(xi[:, alpha_idx])
    return xi


@pytest.mark.parametrize("name", ["hypo_hill_plane_strain", "hypo_hill_plane_stress"])
def test_plane_twin_matches_pallas_interpret(name):
    deck = case_deck(TWINS[name], num_steps=1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jd = jp.disc
    coords, d, mixed = np.asarray(jd.coords), jd.spec.dim, jd.spec.mixed
    x = hyper_state(coords, jd.n_nodes, d, mixed, 0.02, seed=0)
    x_prev = hyper_state(coords, jd.n_nodes, d, mixed, 0.01, seed=2)
    xi_prev = hypo_xi_prev(jp.model, jd.n_elem, 3)
    asm = pallas_assembly.make_pallas_assemble(jp.assembler, block_e=128, interpret=True)
    R, J_e, diag, xi, path, nfail = asm(jnp.asarray(x), jnp.asarray(x_prev), jnp.asarray(xi_prev),
                                        jp.params0)
    E = jd.n_elem
    ref = dict(R=np.asarray(R), J_e=np.asarray(J_e)[:E], diag=np.asarray(diag),
               xi=np.asarray(xi)[:E], path=np.asarray(path)[:E], nfail=int(nfail))
    R_t, J_T, diag_t, xi_t, path_t, nfail_t = FusedAssembler(tp.disc, tp.model).assemble(
        torch.tensor(x), torch.tensor(xi_prev), tp.params0, x_prev=torch.tensor(x_prev))
    assert int(nfail_t) == ref["nfail"] == 0
    assert 0 < ref["path"].sum() < E, "single-branch state"
    np.testing.assert_array_equal(path_t.numpy(), ref["path"])
    assert _rel(xi_t.numpy(), ref["xi"]) <= 1e-12
    assert _rel(R_t.numpy(), ref["R"]) <= 1e-12
    J_scale = np.abs(ref["J_e"]).max()
    assert np.abs(np.moveaxis(J_T.numpy(), -1, 0) - ref["J_e"]).max() <= 1e-11 * J_scale
    assert np.abs(diag_t.numpy() - ref["diag"]).max() <= 1e-11 * J_scale
