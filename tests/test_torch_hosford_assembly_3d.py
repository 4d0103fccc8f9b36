"""small_hosford and hypo_hosford in 3D (cube n=2, mixed u/p, their twin
cases' constants), float64 on the CPU, against calibr8_tpu: the plain
fused assembly against calibr8_tpu's twin local_solve (its
_implicit_newton with the frozen branch and the line search), run as
plain JAX on the same trailing arrays (xi, path, failed), and its generic
residual and Jacobian at the twin's state (R, J), as
tests/test_torch_hypo_assembly_3d.py holds hypo_hill: xi and R to 1e-12
of their max, J to 1e-11.  The path compared is the frozen one: the
branch of the first guess, which the condensation linearizes at.

States from numpy with a seed (tests/test_torch_hyper_assembly.py's);
some elements yield, some do not; none has two equal principal stresses,
where calibr8_tpu's eigenvectors are undefined (tests/test_torch_eig.py).
Each test takes ~20 s, most of it compiling the JAX references."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
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
from tests.test_torch_hyper_assembly import _rel, hyper_state
from tests.test_torch_hypo_assembly import hypo_xi_prev

MATS = {c[0]: c[3] for c in TWIN_CASES}


def check_eig_twin(name, scale=0.02):
    """The port's plain assembly against calibr8_tpu's twin + generic path
    on cube n=2; returns the path."""
    deck = make_deck(CUBE, name, MATS[name], BCS_3D(0.01), 1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jd = jp.disc
    coords = np.asarray(jd.coords)
    x = hyper_state(coords, jd.n_nodes, 3, True, scale, seed=0)
    x_prev = hyper_state(coords, jd.n_nodes, 3, True, 0.5 * scale, seed=2)
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
    return path


@pytest.mark.parametrize("name", ["small_hosford", "hypo_hosford"])
def test_hosford_twin_matches_twin_and_generic(name):
    check_eig_twin(name)
