"""The implicit-mode fused assembly of hybrid_hyper_J2_plane_stress (the
hyper_J2_plane_stress twin with its hardening curve an embedded network)
in its plain version (the CPU path, and the oracle the CUDA kernel is held
to on the card) against calibr8_tpu's fused Pallas kernel in interpret
mode, on the twin case's notch2D h=0.3 (calibr8_tpu/models/twin_cases.py:
175-181, case_deck :218-222: sigmoid, [1, 4, 1], output scale 10), float64.
The port's initial parameters, network weights included, equal
calibr8_tpu's bit for bit.

The state is made with numpy from a seed, as tests/test_torch_hyper_
assembly.py makes it: x and x_prev differ, xi_prev is the initial state
plus a small perturbation with alpha >= 0, and some elements yield.
Tolerances: path and nfail equal; xi and R to 1e-12 of their max, J and
diag to 1e-11 of max|J| (float64 rounding through another operation
order).  The interpret-mode kernel takes ~20 s, so this file holds two
tests and runs beside tests/test_dist_pallas.py under xdist's loadfile
queue."""

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
from tests.test_torch_hyper_assembly import _rel, hyper_state, hyper_xi_prev

CASE = {c[0]: c for c in TWIN_CASES}["hybrid_hyper_J2_plane_stress"]


@pytest.fixture(scope="module")
def problems():
    deck = case_deck(CASE, num_steps=1)
    return (JaxProblem(jax_load_deck(copy.deepcopy(deck))),
            Problem(load_deck(copy.deepcopy(deck)), device="cpu"))


def test_hybrid_params0_equal_bitwise(problems):
    jp, tp = problems
    assert tp.model.param_names == tuple(jp.model.param_names)
    assert len(tp.model.param_names) == 3 + 13
    np.testing.assert_array_equal(tp.params0.numpy(), np.asarray(jp.params0))


def test_hybrid_plain_matches_pallas_interpret(problems):
    jp, tp = problems
    jd = jp.disc
    coords, d = np.asarray(jd.coords), jd.spec.dim
    # the hyper plane-stress test's states, twice the pull, so that the
    # network's hardening is reached on some elements
    x = hyper_state(coords, jd.n_nodes, d, False, 0.04, seed=0)
    x_prev = hyper_state(coords, jd.n_nodes, d, False, 0.02, seed=2)
    xi_prev = hyper_xi_prev(jp.model, jd.n_elem)
    asm = pallas_assembly.make_pallas_assemble(jp.assembler, block_e=128, interpret=True)
    R, J_e, diag, xi, path, nfail = asm(jnp.asarray(x), jnp.asarray(x_prev),
                                        jnp.asarray(xi_prev), jp.params0)
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
