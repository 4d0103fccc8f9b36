"""The eigensolver family through the port on the CPU, float64:

 - the notch_small_hosford golden (tests/decks.py: notch3D, 4 steps,
   a = 100) through Problem, at its tolerance of 1e-8 (~30 s);
 - dJ/dp end to end on cube n=2 with small_hosford at its twin case's
   constants (the pull tilted as in chip_smoke.eig_deck: under a uniform
   pull every element is in uniaxial tension, where calibr8_tpu's local
   Newton stalls), 2 load steps, some elements yielding: the port's
   AdjointObjective.gradient against calibr8_tpu's in canonical
   coordinates, to 1e-8 relative (two primal solves, each converged to
   Newton's 1e-8), and the port's sweep on calibr8_tpu's own trajectory
   to 1e-10 of max|dJ/dp|.

The notch_hypo_barlat golden takes ~60 s on the CPU and runs on the card
(chip_smoke.py phase 3).  Two tests: xdist's loadfile runs this file
beside tests/test_dist_pallas.py."""

import numpy as np
import torch

from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu_torch.convert import trajectory_from_numpy
from tests.decks import BCS_3D, CUBE, PRIMAL_REGRESSIONS, make_deck
from tests.test_torch_adjoint import _jax_side, _port_objective, _rel
from tests.test_torch_primal import check_golden

HOSFORD = make_deck(CUBE, "small_hosford", {c[0]: c for c in TWIN_CASES}["small_hosford"][3],
                    BCS_3D(0.02), 2)
HOSFORD["dirichlet bcs"]["expression"]["bc 4"] = [0, 1, "ymax", "0.02 * t * (0.5 + x)"]
HOSFORD_INVERSE = {"materials": {"body": {"E": [800.0, 1200.0], "Y": [8.0, 12.0],
                                          "a": [6.0, 10.0], "K": [40.0, 60.0]}}}


def test_small_hosford_golden():
    check_golden(*PRIMAL_REGRESSIONS["notch_small_hosford"][:3])


def test_gradient_end_to_end_small_hosford():
    j = _jax_side(HOSFORD, HOSFORD_INVERSE)
    assert int(j["traj"].path[-1].sum()) > 0, "no element yields"
    tp, adj, obj = _port_objective(HOSFORD, HOSFORD_INVERSE)
    assert _rel(obj.gradient(j["x0"]), j["g"]) <= 1e-8
    jt = j["traj"]
    traj = trajectory_from_numpy([np.asarray(a) for a in jt.x], [np.asarray(a) for a in jt.xi],
                                 [np.asarray(a) for a in jt.path], jt.qoi_values, device="cpu")
    grad, _ = adj.sweep(traj, torch.tensor(np.asarray(j["params_all"])), tp.time_grid)
    assert _rel(grad, j["grad_all"]) <= 1e-10
