"""The adjoint of hybrid_hyper_J2_plane_stress, float64 on the CPU,
against calibr8_tpu:

 - J and dJ/dp end to end on the deck of tests/test_nn_models.py's
   test_hybrid_model_primal_and_gradient (notch2D h=0.2, 3 load steps, Y
   = 2, the twin case's network: sigmoid, [1, 4, 1], output scale 10),
   with Y, nn_0 and nn_1 active over its ranges: the port's
   AdjointObjective against calibr8_tpu's, J to 1e-10 and dJ/dp in
   canonical coordinates to 1e-8 relative (two primal solves, each
   converged to Newton's 1e-8);
 - the 8 adjoint element blocks on notch2D h=0.12 against
   make_adjoint_blocks_kernel("all"), each to 1e-12 of its max: dC/dp
   spans E, nu, Y and the 13 network weights.

Both run calibr8_tpu, so this file holds two tests."""

import copy

from tests.decks import BCS_2D, NOTCH2D, make_deck
from tests.test_torch_adjoint import _jax_side, _port_objective, _rel
from tests.test_torch_adjoint_blocks import check_blocks

NET = {"activation function": "sigmoid", "topology": [1, 4, 1], "input scale": 1.0,
       "output scale": 10.0}


def hybrid_deck(mesh, materials, pull, num_steps):
    deck = make_deck(mesh, "hybrid_hyper_J2_plane_stress", materials, BCS_2D(pull), num_steps,
                     global_type="mechanics_plane_stress", max_iters=30)
    deck["residuals"]["local residual"]["embedded model"] = copy.deepcopy(NET)
    return deck


NN_DECK = hybrid_deck({"type": "notch2D", "h": 0.2}, {"E": 1000.0, "nu": 0.25, "Y": 2.0},
                      0.005, 3)
NN_INVERSE = {"materials": {"body": {"Y": [1.0, 3.0], "nn_0": [-2.0, 2.0],
                                     "nn_1": [-2.0, 2.0]}}}


def test_hybrid_J_and_gradient_match_jax():
    j = _jax_side(NN_DECK, NN_INVERSE)
    assert int(j["traj"].path[-1].sum()) > 0, "no element yields"
    tp, adj, obj = _port_objective(NN_DECK, NN_INVERSE)
    J = obj.value(j["x0"])
    assert abs(J - float(j["traj"].J)) <= 1e-10 * abs(float(j["traj"].J))
    assert _rel(obj.gradient(j["x0"]), j["g"]) <= 1e-8


def test_adjoint_blocks_hybrid_match_jax():
    deck = hybrid_deck(NOTCH2D, {"E": 1000.0, "nu": 0.25, "Y": 10.0}, 0.02, 1)
    _, B = check_blocks(deck, 1.0, tol=1e-12)
    assert B["dC_dp_T"].shape[1] == 3 + 13
    assert float(B["dC_dp_T"][:, 3:].abs().max()) > 0.0
