"""The implicit-mode fused assembly of the finite-deformation plane twins
(hyper_J2_plane_strain, mixed u/p; hyper_J2_plane_stress, displacement
only with the z-stretch PK1 rows) in its plain version (the CPU path, and
the oracle the CUDA kernel is held to on the card) against calibr8_tpu's
fused Pallas kernel in interpret mode, on notch2D h=0.3, float64.

The state is made with numpy from a seed: x and x_prev differ (the trial
state reads F F_prev^-1), xi_prev is the initial state (Ie = 1, lambda_z
= 1) plus a small perturbation with alpha >= 0, and some elements yield.
Tolerances: path and nfail equal; xi and R to 1e-12 of their max, J and
diag to 1e-11 of max|J| (float64 rounding through another operation
order).  Each case runs calibr8_tpu's interpret-mode kernel (~15-20 s),
so this file holds two tests and runs beside tests/test_dist_pallas.py
under xdist's loadfile queue."""

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

TWINS = {c[0]: c for c in TWIN_CASES}


def hyper_state(coords, n_nodes, d, mixed, scale, seed):
    """tests/test_torch_implicit.py's displacement state (u_y = scale y^2,
    u_x = -0.3 scale x, plus noise) and a random nodal pressure for mixed
    specs, as one flat dof vector."""
    rng = np.random.default_rng(seed)
    u = np.zeros((n_nodes, d))
    u[:, 1] = scale * coords[:, 1] ** 2
    u[:, 0] = -0.3 * scale * coords[:, 0]
    u = u + 0.02 * scale * rng.standard_normal(u.shape)
    parts = [u.reshape(-1)]
    if mixed:
        parts.append(0.5 * rng.standard_normal(n_nodes))
    return np.concatenate(parts)


def hyper_xi_prev(model, n_elem, seed=1):
    """The model's initial state plus 1e-4 noise, alpha (the last slot) >= 0."""
    nxi = len(model.init_xi())
    xi = np.tile(model.init_xi(), (n_elem, 1)) + 1e-4 * np.random.default_rng(seed).standard_normal(
        (n_elem, nxi))
    xi[:, -1] = np.abs(xi[:, -1])
    return xi


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name", ["hyper_J2_plane_strain", "hyper_J2_plane_stress"])
def test_plane_twin_matches_pallas_interpret(name):
    deck = case_deck(TWINS[name], num_steps=1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jd = jp.disc
    coords, d, mixed = np.asarray(jd.coords), jd.spec.dim, jd.spec.mixed
    x = hyper_state(coords, jd.n_nodes, d, mixed, 0.02, seed=0)
    x_prev = hyper_state(coords, jd.n_nodes, d, mixed, 0.01, seed=2)
    xi_prev = hyper_xi_prev(jp.model, jd.n_elem)
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
