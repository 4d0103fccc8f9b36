"""The fused assembly's plain version (the CPU path, and the oracle the
CUDA kernel is held to on the card) against calibr8_tpu.

In 2D the reference is calibr8_tpu's fused Pallas kernel in interpret
mode (make_pallas_assemble(..., interpret=True), as
tests/test_batched_twins.py runs it); in 3D, where interpret mode takes
minutes, it is the generic path (local Newton + jax.linearize), which
converges to the same root as the closed-form return.  Inputs are made
with numpy from a seed as tests/test_batched_twins.py:_state makes them,
so that plastic and elastic branches are both active.

Tolerances: path equal; xi to 1e-12 absolute (|xi| ~ 1e-3); R to
1e-12 max|R|; J and diag to 1e-10 max|J| (float64 rounding through a
different operation order: ~1e-15 seen, the margin covers the 3D
reference's local Newton, converged to 1e-12)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem import pallas_assembly
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import FusedAssembler, fused_assembly, fused_assembly_plain
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, BCS_3D, CUBE, NOTCH2D, J2_MAT, make_deck

EL_MAT = {"E": 1000.0, "nu": 0.25, "cte": 1e-5, "delta_T": 10.0}
CASES = {
    "small_J2_2D": (NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.02), "interpret"),
    "small_J2_3D": ({"type": "cube", "n": 2}, "small_J2", J2_MAT, BCS_3D(0.02), "generic"),
    "elastic_2D": (NOTCH2D, "elastic", EL_MAT, BCS_2D(0.02), "interpret"),
    "elastic_3D": (CUBE, "elastic", EL_MAT, BCS_3D(0.02), "generic"),
}


def _state(disc_coords, n_nodes, d, scale, seed=0):
    """tests/test_batched_twins.py:_state as numpy, plus a nodal
    pressure so the pressure columns see a non-zero state."""
    rng = np.random.default_rng(seed)
    u = np.zeros((n_nodes, d))
    u[:, 1] = scale * disc_coords[:, 1] ** 2
    u[:, 0] = -0.3 * scale * disc_coords[:, 0]
    u = u + 0.02 * scale * rng.standard_normal(u.shape)
    p = 0.5 * rng.standard_normal(n_nodes)
    return np.concatenate([u.reshape(-1), p])


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    mesh, model, mats, bcs, ref = CASES[request.param]
    deck = make_deck(mesh, model, mats, bcs, 1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jd = jp.disc
    x = _state(np.asarray(jd.coords), jd.n_nodes, jd.spec.dim, 0.02)
    nxi = jp.assembler.nxi
    rng = np.random.default_rng(1)
    # a small previous plastic strain, so the return starts off zero
    xi_prev = 1e-4 * rng.standard_normal((jd.n_elem, nxi)) if model == "small_J2" else np.zeros((jd.n_elem, nxi))
    a = jp.assembler
    xj, xpj, xipj = jnp.asarray(x), jd.zero_x(), jnp.asarray(xi_prev)
    if ref == "interpret":
        asm = pallas_assembly.make_pallas_assemble(a, block_e=128, interpret=True)
        R, J_e, diag, xi, path, nfail = asm(xj, xpj, xipj, jp.params0)
        assert int(nfail) == 0
    else:
        loc = a.local_solve(xj, xpj, xipj, jp.params0)
        R, J_e, diag = a.residual_and_jacobian(xj, xpj, loc.xi, xipj, loc.path, jp.params0)
        xi, path = loc.xi, loc.path
    ref_out = dict(R=np.asarray(R), J_e=np.asarray(J_e)[: jd.n_elem], diag=np.asarray(diag),
                   xi=np.asarray(xi)[: jd.n_elem], path=np.asarray(path)[: jd.n_elem])
    asm_t = FusedAssembler(tp.disc, tp.model)
    R_t, J_T, diag_t, xi_t, path_t, nfail_t = asm_t.assemble(
        torch.tensor(x), torch.tensor(xi_prev), tp.params0
    )
    port = dict(R=R_t.numpy(), J_T=J_T.numpy(), diag=diag_t.numpy(), xi=xi_t.numpy(),
                path=path_t.numpy(), nfail=int(nfail_t))
    return request.param, model, ref_out, port


def test_path_and_xi(case):
    name, model, ref, port = case
    assert port["nfail"] == 0
    np.testing.assert_array_equal(port["path"], ref["path"])
    if model == "small_J2":
        assert ref["path"].min() == 0 and ref["path"].max() == 1, "single-branch state"
    np.testing.assert_allclose(port["xi"], ref["xi"], rtol=0, atol=1e-12)


def test_residual(case):
    name, model, ref, port = case
    scale = np.abs(ref["R"]).max()
    np.testing.assert_allclose(port["R"], ref["R"], rtol=0, atol=1e-12 * scale)


def test_jacobian_and_diag(case):
    name, model, ref, port = case
    J_ref = ref["J_e"]
    scale = np.abs(J_ref).max()
    np.testing.assert_allclose(np.moveaxis(port["J_T"], -1, 0), J_ref, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(port["diag"], ref["diag"], rtol=0, atol=1e-10 * scale)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the kernel wrapper is the plain version (and counts
    no launch)."""
    from calibr8_tpu_torch import kernels

    deck = make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1)
    tp = Problem(load_deck(deck), device="cpu")
    d = tp.disc
    x = torch.tensor(_state(d.mesh.coords, d.n_nodes, 3, 0.02))
    xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=torch.float64)
    before = dict(kernels.launches)
    a = fused_assembly(d, tp.assembler.bmodel, x, xi_prev, tp.params0)
    b = fused_assembly_plain(d, tp.assembler.bmodel, x, xi_prev, tp.params0)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert kernels.launches == before


def test_float32_plain_version_close_to_float64():
    """The float32 path (the card's other precision) stays within f32
    rounding of the float64 result: J to 1e-5 max|J|."""
    deck = make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1)
    res = {}
    for dt in (torch.float32, torch.float64):
        tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu", dtype=dt)
        d = tp.disc
        x = torch.tensor(_state(d.mesh.coords, d.n_nodes, 3, 0.02), dtype=dt)
        xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=dt)
        res[dt] = fused_assembly_plain(d, tp.assembler.bmodel, x, xi_prev, tp.params0)
    J32, J64 = res[torch.float32][1].double(), res[torch.float64][1]
    assert torch.equal(res[torch.float32][3], res[torch.float64][3])
    assert (J32 - J64).abs().max() <= 1e-5 * J64.abs().max()
