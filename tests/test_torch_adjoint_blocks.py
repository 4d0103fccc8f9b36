"""The adjoint element blocks of the port (fem/adjoint_blocks.py: one
linearization of [C; R] over [xi, x_e, x_prev_e, xi_prev, p], static
condensation) against calibr8_tpu's make_adjoint_blocks_kernel("all"),
float64 on the CPU: all 8 blocks to 1e-10 of each block's max, in states
where some elements yield and some do not.  This file holds the analytic
twins (elastic, small_J2) and the chunking; the implicit Hill twins are
in test_torch_adjoint_blocks_hill.py.  Each case compiles its JAX
reference (3-10 s)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.adjoint_blocks import BLOCK_NAMES, adjoint_blocks
from calibr8_tpu_torch.fem.fused_assembly import fused_assembly_plain
from calibr8_tpu_torch.mechanics.global_residual import make_elem_residual
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, BCS_3D, CUBE, ELASTIC_MAT, J2_MAT, NOTCH2D, make_deck


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


BLOCK_CASES = {
    # deck, deformation scale (some elements yield, some do not)
    "cube2_elastic": (make_deck(CUBE, "elastic", ELASTIC_MAT, BCS_3D(0.02), 1), 1.0),
    "notch2D_elastic": (make_deck(NOTCH2D, "elastic", ELASTIC_MAT, BCS_2D(0.02), 1), 1.0),
    "cube2_small_J2": (make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1), 1.0),
    "notch2D_small_J2": (make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.02), 1), 1.0),
}


def _block_state(tp, scale=1.0, seed=0):
    """A deformed state with a random nodal pressure, its previous state,
    a small previous plastic strain, and (xi, path) from the local solve."""
    d = tp.disc
    rng = np.random.default_rng(seed)
    c = d.mesh.coords
    u = np.zeros((d.n_nodes, d.spec.dim))
    u[:, 1] = 0.02 * scale * c[:, 1] ** 2
    u[:, 0] = -0.006 * scale * c[:, 0]
    u += 4e-4 * scale * rng.standard_normal(u.shape)
    x = torch.tensor(np.concatenate([u.reshape(-1), 0.3 * rng.standard_normal(d.n_nodes if d.spec.mixed else 0)]))
    nxi = tp.model.nxi()
    xi_prev = torch.zeros(d.n_elem, nxi, dtype=torch.float64)
    if tp.model.name != "elastic":
        xi_prev = torch.tensor(1e-4 * rng.standard_normal((d.n_elem, nxi)))
    _, _, xiT, path, _ = fused_assembly_plain(d, tp.assembler.bmodel, x, xi_prev, tp.params0)
    return x, 0.5 * x, xiT.T.contiguous(), xi_prev, path


def check_blocks(deck, scale):
    """The port's blocks against calibr8_tpu's on the deck's problem."""
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    x, x_prev, xi, xi_prev, path = _block_state(tp, scale)
    if tp.model.name != "elastic":
        assert 0 < int(path.sum()) < tp.disc.n_elem
    bm = tp.assembler.bmodel
    B = adjoint_blocks(tp.disc, bm, make_elem_residual(bm, tp.disc.spec), x, x_prev, xi,
                       xi_prev, path, tp.params0)
    a = jp.assembler
    Bj = jax.jit(a.make_adjoint_blocks_kernel("all"))(
        a.gather(jnp.asarray(x.numpy())).T, a.gather(jnp.asarray(x_prev.numpy())).T,
        jnp.asarray(xi.numpy()).T, jnp.asarray(xi_prev.numpy()).T, jnp.asarray(path.numpy()),
        jnp.moveaxis(jp.disc.grad_N, 0, -1), jp.disc.detJ, jp.disc.h,
        a.params_per_elem(jp.params0).T,
    )
    assert set(Bj) == set(BLOCK_NAMES)
    for k in BLOCK_NAMES:
        assert B[k].shape == Bj[k].shape, k
        assert _rel(B[k], Bj[k]) <= 1e-10, (k, _rel(B[k], Bj[k]))


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_adjoint_blocks_match_jax(case):
    check_blocks(*BLOCK_CASES[case])


def test_adjoint_blocks_chunked_match_whole():
    """The element chunks give the same blocks as one pass."""
    deck, scale = BLOCK_CASES["cube2_small_J2"]
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    state = _block_state(tp, scale, seed=1)
    bm = tp.assembler.bmodel
    er = make_elem_residual(bm, tp.disc.spec)
    whole = adjoint_blocks(tp.disc, bm, er, *state, tp.params0)
    chunked = adjoint_blocks(tp.disc, bm, er, *state, tp.params0, chunk=20)
    for k in BLOCK_NAMES:
        assert torch.equal(whole[k], chunked[k]), k
