"""hypo_barlat in 3D (cube n=2, mixed u/p, its twin case's constants),
float64 on the CPU, against calibr8_tpu:

 - the plain fused assembly against calibr8_tpu's twin local_solve (plain
   JAX) and its generic residual and Jacobian at the twin's state:
   xi and R to 1e-12 of their max, J to 1e-11
   (tests/test_torch_hosford_assembly_3d.py's check);
 - the 8 adjoint element blocks against make_adjoint_blocks_kernel("all"),
   each to 1e-12 of its max, at the path the local solve returns, which
   for this frozen-branch twin is the branch of the first guess (the
   primal records it, and both packages differentiate C at it).

Each test takes ~30-60 s, most of it compiling the JAX references."""

import copy

import torch

from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.mechanics.global_residual import elem_kinematics
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_3D, CUBE, make_deck
from tests.test_torch_adjoint_blocks import _block_state, check_blocks
from tests.test_torch_hosford_assembly_3d import check_eig_twin

BARLAT_MAT = {c[0]: c for c in TWIN_CASES}["hypo_barlat"][3]


def test_hypo_barlat_matches_twin_and_generic():
    check_eig_twin("hypo_barlat")


def test_adjoint_blocks_hypo_barlat_match_jax_at_frozen_path():
    deck = make_deck(CUBE, "hypo_barlat", BARLAT_MAT, BCS_3D(0.02), 1)
    _, B = check_blocks(deck, 1.0, tol=1e-12)
    # the unrotated rate reads F_prev: dC/dx_prev is not zero
    assert float(B["dC_dxprev_T"].abs().max()) > 1e-3
    # check_blocks' path (the local solve's, _block_state) is the branch
    # of the first guess, not pathfn at the converged xi
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    bm = tp.assembler.bmodel
    x, x_prev, xi, xi_prev, path = _block_state(tp, 1.0)
    d = tp.disc
    guT = elem_kinematics(d.spec, x[d.edofs].T, d.gN_T)
    gupT = elem_kinematics(d.spec, x_prev[d.edofs].T, d.gN_T)
    parT = tp.params0[d.es_ids].T
    xipT = xi_prev.T
    path0 = bm.pathfn(bm.first_guess(xipT, guT, parT, gupT), xipT, guT, parT, gupT)
    assert torch.equal(path, path0)
    assert 0 < int(path.sum()) < d.n_elem
