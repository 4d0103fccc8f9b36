"""hypo_hill in 3D (cube n=2, mixed u/p, its twin case's constants),
float64 on the CPU, against calibr8_tpu:

 - the plain fused assembly against calibr8_tpu's twin BatchedHypoHill
   .local_solve, run as plain JAX on the same trailing arrays (xi, path),
   and its generic residual and Jacobian at the twin's state (R, J), as
   tests/test_torch_hyper_assembly_3d.py holds hyper_J2 (interpret mode
   takes minutes in 3D): xi and R to 1e-12 of their max, J to 1e-11;
 - the 8 adjoint element blocks against make_adjoint_blocks_kernel("all"),
   each to 1e-12 of its max.  The x_prev blocks (dC/dx_prev) are nonzero
   here: the unrotated rate reads grad_u_prev.

States from numpy with a seed (tests/test_torch_hyper_assembly.py's);
some elements yield, some do not.  The JAX references take ~30 s to
compile, so this file holds two tests."""

import copy

import jax.numpy as jnp
import numpy as np
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.models.base import Kinematics
from calibr8_tpu.models.batched import get_batched_model as jax_batched_model
from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import FusedAssembler
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_3D, CUBE, make_deck
from tests.test_torch_adjoint_blocks import check_blocks
from tests.test_torch_hyper_assembly import _rel, hyper_state
from tests.test_torch_hypo_assembly import hypo_xi_prev

HYPO_MAT = {c[0]: c for c in TWIN_CASES}["hypo_hill"][3]


def test_hypo_hill_matches_twin_and_generic():
    deck = make_deck(CUBE, "hypo_hill", HYPO_MAT, BCS_3D(0.01), 1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jd = jp.disc
    coords = np.asarray(jd.coords)
    x = hyper_state(coords, jd.n_nodes, 3, True, 0.02, seed=0)
    x_prev = hyper_state(coords, jd.n_nodes, 3, True, 0.01, seed=2)
    xi_prev = hypo_xi_prev(jp.model, jd.n_elem, 6)
    gN = np.asarray(jd.grad_N)

    def grad_u_T(v):
        u_e = v[np.asarray(jd.edofs)].reshape(jd.n_elem, 4, 4)[:, :, :3]
        return jnp.asarray(np.einsum("eni,enj->ije", u_e, gN))

    parT = jnp.asarray(np.asarray(jp.params0)[np.asarray(jd.es_ids)].T)
    kin = Kinematics(grad_u=grad_u_T(x), grad_u_prev=grad_u_T(x_prev))
    xiT, path, failed = jax_batched_model(jp.assembler.model).local_solve(
        jnp.asarray(xi_prev.T), kin, parT)
    R, J_e, diag = jp.assembler.residual_and_jacobian(
        jnp.asarray(x), jnp.asarray(x_prev), xiT.T, jnp.asarray(xi_prev), path, jp.params0)
    path = np.asarray(path)
    R_t, J_T, diag_t, xi_t, path_t, nfail_t = FusedAssembler(tp.disc, tp.model).assemble(
        torch.tensor(x), torch.tensor(xi_prev), tp.params0, x_prev=torch.tensor(x_prev))
    assert int(nfail_t) == int(np.sum(np.asarray(failed))) == 0
    assert 0 < path.sum() < jd.n_elem
    np.testing.assert_array_equal(path_t.numpy(), path)
    assert _rel(xi_t.numpy(), np.asarray(xiT).T) <= 1e-12
    assert _rel(R_t.numpy(), R) <= 1e-12
    J_e = np.asarray(J_e)
    assert _rel(np.moveaxis(J_T.numpy(), -1, 0), J_e) <= 1e-11
    assert np.abs(diag_t.numpy() - np.asarray(diag)).max() <= 1e-11 * np.abs(J_e).max()


def test_adjoint_blocks_hypo_hill_match_jax():
    _, B = check_blocks(make_deck(CUBE, "hypo_hill", HYPO_MAT, BCS_3D(0.02), 1), 1.0, tol=1e-12)
    # the unrotated rate reads F_prev: dC/dx_prev is not zero
    assert float(B["dC_dxprev_T"].abs().max()) > 1e-3
