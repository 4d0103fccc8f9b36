"""The adjoint of the finite-deformation plane twins, float64 on the CPU,
against calibr8_tpu:

 - dJ/dp end to end on notch2D h=0.12 with hyper_J2_plane_strain (its
   twin case's constants, calibr8_tpu/models/twin_cases.py:147-152, 2 load
   steps, some elements yield): the port's AdjointObjective.gradient
   against calibr8_tpu's in canonical coordinates, to 1e-8 relative (two
   primal solves, each converged to Newton's 1e-8); and the port's sweep
   on calibr8_tpu's own trajectory, carried across by
   convert.trajectory_from_numpy (the hyper xi layout, Ie = 1 at step 0,
   and x_prev as the previous step's x), to 1e-10 of max|dJ/dp|;
 - the 8 adjoint element blocks of hyper_J2_plane_stress (displacement
   only, the z-stretch rows) against make_adjoint_blocks_kernel("all"),
   each to 1e-12 of its max.

Both run calibr8_tpu, so this file holds two tests."""

import numpy as np
import torch

from calibr8_tpu_torch.convert import trajectory_from_numpy
from tests.decks import BCS_2D, NOTCH2D, make_deck
from tests.test_torch_adjoint import _jax_side, _port_objective, _rel
from tests.test_torch_adjoint_blocks import check_blocks

PLANE_STRAIN = make_deck(NOTCH2D, "hyper_J2_plane_strain",
                         {"E": 1000.0, "nu": 0.25, "K": 50.0, "Y": 10.0, "Y_inf": 15.0,
                          "delta": 2.0}, BCS_2D(0.005), 2)
PLANE_STRAIN_INVERSE = {"materials": {"body": {"E": [800.0, 1200.0], "K": [40.0, 60.0],
                                               "Y": [8.0, 12.0], "Y_inf": [12.0, 18.0]}}}
PLANE_STRESS_MAT = {"E": 1000.0, "nu": 0.25, "Y": 10.0, "S": 5.0, "D": 2.0, "A": 0.0, "n": 0.0,
                    "K": 50.0}


def test_gradient_end_to_end_plane_strain_hyper():
    j = _jax_side(PLANE_STRAIN, PLANE_STRAIN_INVERSE)
    assert int(j["traj"].path[-1].sum()) > 0, "no element yields"
    tp, adj, obj = _port_objective(PLANE_STRAIN, PLANE_STRAIN_INVERSE)
    assert _rel(obj.gradient(j["x0"]), j["g"]) <= 1e-8
    jt = j["traj"]
    traj = trajectory_from_numpy([np.asarray(a) for a in jt.x], [np.asarray(a) for a in jt.xi],
                                 [np.asarray(a) for a in jt.path], jt.qoi_values, device="cpu")
    np.testing.assert_array_equal(traj.xi[0].numpy(), np.tile(tp.model.init_xi(), (tp.disc.n_elem, 1)))
    grad, _ = adj.sweep(traj, torch.tensor(np.asarray(j["params_all"])), tp.time_grid)
    assert _rel(grad, j["grad_all"]) <= 1e-10


def test_adjoint_blocks_plane_stress_hyper_match_jax():
    deck = make_deck(NOTCH2D, "hyper_J2_plane_stress", PLANE_STRESS_MAT, BCS_2D(0.02), 1,
                     global_type="mechanics_plane_stress")
    _, B = check_blocks(deck, 1.0, tol=1e-12)
    assert float(B["dC_dxprev_T"].abs().max()) > 1e-3
