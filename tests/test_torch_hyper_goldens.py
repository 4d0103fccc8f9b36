"""The two heavier goldens of the hyper_J2 family through the port alone
on the CPU (tests/decks.py): cube_hyper_J2 (10 plastic load steps, 3D
mixed u/p, ~5 s) and notch2D_hyper_J2_plane_stress (5 steps, the
z-stretch rows, ~12-16 s), each at its tests/decks.py tolerance.  The
family's three cheaper goldens are in test_torch_primal.py; these two
sit in a file of two tests, which xdist's loadfile queue runs beside
tests/test_dist_pallas.py."""

import pytest

from tests.decks import PRIMAL_REGRESSIONS
from tests.test_torch_primal import check_golden


@pytest.mark.parametrize("name", ["cube_hyper_J2", "notch2D_hyper_J2_plane_stress"])
def test_hyper_golden(name):
    check_golden(*PRIMAL_REGRESSIONS[name][:3])
