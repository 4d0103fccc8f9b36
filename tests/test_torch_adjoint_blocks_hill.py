"""The adjoint element blocks of the implicit Hill twins (small_hill on
cube n=2, small_hill_plane_stress on notch2D, displacement only) against
calibr8_tpu's make_adjoint_blocks_kernel("all"), float64 on the CPU, as
test_torch_adjoint_blocks.py holds the analytic twins: all 8 blocks to
1e-10 of each block's max."""

import pytest

from calibr8_tpu.models.twin_cases import HILL2D
from tests.decks import BCS_2D, BCS_3D, CUBE, NOTCH2D, UNIT_R, VOCE_MAT, make_deck
from tests.test_torch_adjoint_blocks import check_blocks

HILL_CASES = {
    # deck, deformation scale (some elements yield, some do not)
    "cube2_small_hill": (make_deck(CUBE, "small_hill", {**VOCE_MAT, **UNIT_R}, BCS_3D(0.02), 1), 0.1),
    "notch2D_small_hill_plane_stress": (
        make_deck(NOTCH2D, "small_hill_plane_stress", HILL2D, BCS_2D(0.02), 1,
                  global_type="mechanics_plane_stress"), 1.0),
}


@pytest.mark.parametrize("case", list(HILL_CASES))
def test_adjoint_blocks_match_jax(case):
    check_blocks(*HILL_CASES[case])
