"""dJ/dp end to end, each package running its own primal, float64 on the
CPU: the port's AdjointObjective.gradient against calibr8_tpu's in
canonical coordinates, to 1e-8 relative (two primal solves, each
converged to Newton's 1e-8).  The notch2D small_J2 8-step deck with E, K,
Y active (bounds as in tests/test_adjoint_gradient.py) is the slice's
exit; the plane-strain Hill deck repeats it through an implicit twin."""

import numpy as np

from tests.decks import BCS_2D, NOTCH2D, VOCE_MAT, make_deck
from tests.test_torch_adjoint import NOTCH_J2, NOTCH_J2_INVERSE, _jax_side, _port_objective, _rel

PLANE_STRAIN = make_deck(NOTCH2D, "small_hill_plane_strain",
                         {**VOCE_MAT, "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}, BCS_2D(0.005), 2)
PLANE_STRAIN_INVERSE = {"materials": {"body": {"E": [800.0, 1200.0], "Y": [1.5, 2.5], "S": [8.0, 12.0],
                                               "R11": [0.9, 1.1]}}}


def test_gradient_end_to_end_notch_small_J2():
    """dJ/d(E, K, Y), canonical: the slice's exit (ROADMAP)."""
    j = _jax_side(NOTCH_J2, NOTCH_J2_INVERSE)
    _, _, obj = _port_objective(NOTCH_J2, NOTCH_J2_INVERSE)
    g = obj.gradient(j["x0"])
    assert np.all(np.isfinite(g)) and np.all(g != 0.0)
    assert _rel(g, j["g"]) <= 1e-8


def test_gradient_end_to_end_plane_strain_hill():
    j = _jax_side(PLANE_STRAIN, PLANE_STRAIN_INVERSE)
    _, _, obj = _port_objective(PLANE_STRAIN, PLANE_STRAIN_INVERSE)
    assert _rel(obj.gradient(j["x0"]), j["g"]) <= 1e-8
