"""isotropic_elastic through the port on the CPU, float64, against
calibr8_tpu:

 - the analytic-mode fused assembly with the displacement-only rows in
   its plain version (the CPU path, and the oracle the CUDA kernel is held
   to on the card) against calibr8_tpu's fused Pallas kernel in interpret
   mode, on the twin case's cube n=2 (calibr8_tpu/models/twin_cases.py:
   116-122, case_deck :216: 'mixed formulation: false') and on notch2D
   h=0.3 in 2D, at a deformed state made with numpy from a seed: R and J
   (and the diagonal) to 1e-12 of their max.  Thickness 1: calibr8_tpu's
   Pallas kernel multiplies the non-mixed rows by it, its generic path
   (and the port) under plane stress only;
 - the twin case end to end, 2 load steps: J to 1e-10 and dJ/dp over (E,
   nu) in canonical coordinates to 1e-8 of calibr8_tpu's.

Both run calibr8_tpu (the interpret-mode kernel ~5 s a mesh), so this
file holds two tests."""

import copy

import jax.numpy as jnp
import numpy as np
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem import pallas_assembly
from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu.models.twin_cases import case_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import FusedAssembler
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, make_deck
from tests.test_torch_adjoint import _jax_side, _port_objective, _rel

CASE = {c[0]: c for c in TWIN_CASES}["isotropic_elastic"]
ISO_INVERSE = {"materials": {"body": {"E": [800.0, 1200.0], "nu": [0.2, 0.3]}}}


def _decks():
    notch = make_deck({"type": "notch2D", "h": 0.3}, "isotropic_elastic", CASE[3], BCS_2D(0.01), 1)
    notch["residuals"]["global residual"]["mixed formulation"] = False
    return {"cube n=2 (3D)": case_deck(CASE, num_steps=1), "notch2D h=0.3 (2D)": notch}


def test_isotropic_plain_matches_pallas_interpret():
    for label, deck in _decks().items():
        jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
        tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
        jd = jp.disc
        assert not jd.spec.mixed and not tp.disc.spec.mixed
        rng = np.random.default_rng(3)
        coords = np.asarray(jd.coords)
        u = 0.01 * coords * np.linspace(1.0, -0.5, jd.spec.dim) + 1e-3 * rng.standard_normal(
            coords.shape)
        x = u.reshape(-1)
        xi_prev = np.zeros((jd.n_elem, 1))
        asm = pallas_assembly.make_pallas_assemble(jp.assembler, block_e=128, interpret=True)
        R, J_e, diag, xi, path, nfail = asm(jnp.asarray(x), jnp.asarray(x), jnp.asarray(xi_prev),
                                            jp.params0)
        E = jd.n_elem
        R_t, J_T, diag_t, xi_t, path_t, nfail_t = FusedAssembler(tp.disc, tp.model).assemble(
            torch.tensor(x), torch.tensor(xi_prev), tp.params0)
        nde = (jd.spec.dim + 1) * jd.spec.dim  # displacement only
        assert J_T.shape == (nde, nde, E), label
        assert int(nfail_t) == int(nfail) == 0
        np.testing.assert_array_equal(path_t.numpy(), np.asarray(path)[:E])
        np.testing.assert_array_equal(xi_t.numpy(), np.asarray(xi)[:E])
        assert _rel(R_t.numpy(), np.asarray(R)) <= 1e-12, label
        J_ref = np.asarray(J_e)[:E]
        J_scale = np.abs(J_ref).max()
        assert np.abs(np.moveaxis(J_T.numpy(), -1, 0) - J_ref).max() <= 1e-12 * J_scale, label
        assert np.abs(diag_t.numpy() - np.asarray(diag)).max() <= 1e-12 * J_scale, label


def test_isotropic_J_and_gradient_match_jax():
    deck = case_deck(CASE)
    j = _jax_side(deck, ISO_INVERSE)
    tp, adj, obj = _port_objective(deck, ISO_INVERSE)
    J = obj.value(j["x0"])
    assert abs(J - float(j["traj"].J)) <= 1e-10 * abs(float(j["traj"].J))
    assert _rel(obj.gradient(j["x0"]), j["g"]) <= 1e-8
