"""The implicit-mode fused assembly (the small-strain Hill family) and the
displacement-only plane-stress rows, in their plain version (the CPU
path, and the oracle the CUDA kernel is held to on the card), against
calibr8_tpu.

2D (plane strain, mixed; plane stress, displacement only) on notch2D
h=0.3: the reference is calibr8_tpu's fused Pallas kernel in interpret
mode, as tests/test_batched_twins.py runs it.  Tolerances: path and
nfail equal, xi to 1e-12 absolute (|xi| ~ 1e-2), R to 1e-12 max|R|, J
and diag to 1e-10 max|J| (float64 rounding through another operation
order).

3D small_hill on cube n=2, where interpret mode takes minutes: xi and
path against calibr8_tpu's twin BatchedSmallHill.local_solve run as
plain JAX on the same trailing arrays (xi to 1e-12), and R and J
against the generic path (residual_and_jacobian, jax.linearize) at the
twin's state, at tests/test_batched_twins.py's tolerances (R 1e-9, J
5e-7 of max|J|).

Inputs are made with numpy from a seed, as tests/test_batched_twins.py
makes them; every case has plastic and elastic elements.  One module-
scoped fixture per case shares the reference runs."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem import pallas_assembly
from calibr8_tpu.models.base import Kinematics
from calibr8_tpu.models.batched import get_batched_model as jax_batched_model
from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu.models.twin_cases import case_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import FusedAssembler, fused_assembly, fused_assembly_plain
from calibr8_tpu_torch.models.batched import implicit_newton
from calibr8_tpu_torch.problem import Problem

MODELS = ("small_hill_plane_stress", "small_hill_plane_strain", "small_hill")
TWINS = {c[0]: c for c in TWIN_CASES}


def _state(coords, n_nodes, d, mixed, scale=0.02, seed=0):
    """tests/test_batched_twins.py:_state as numpy, plus a nodal pressure
    for mixed specs so the pressure columns see a non-zero state."""
    rng = np.random.default_rng(seed)
    u = np.zeros((n_nodes, d))
    u[:, 1] = scale * coords[:, 1] ** 2
    u[:, 0] = -0.3 * scale * coords[:, 0]
    u = u + 0.02 * scale * rng.standard_normal(u.shape)
    parts = [u.reshape(-1)]
    if mixed:
        parts.append(0.5 * rng.standard_normal(n_nodes))
    return np.concatenate(parts)


@pytest.fixture(scope="module", params=MODELS)
def case(request):
    name = request.param
    deck = case_deck(TWINS[name], num_steps=1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jd = jp.disc
    x = _state(np.asarray(jd.coords), jd.n_nodes, jd.spec.dim, jd.spec.mixed)
    nxi = jp.assembler.nxi
    # a small previous plastic strain, so the Newton starts off zero
    xi_prev = 1e-4 * np.random.default_rng(1).standard_normal((jd.n_elem, nxi))
    xj, xpj, xipj = jnp.asarray(x), jd.zero_x(), jnp.asarray(xi_prev)
    a = jp.assembler
    ref = {}
    if jd.spec.dim == 2:
        asm = pallas_assembly.make_pallas_assemble(a, block_e=128, interpret=True)
        R, J_e, diag, xi, path, nfail = asm(xj, xpj, xipj, jp.params0)
        ref.update(R=R, J_e=np.asarray(J_e)[: jd.n_elem], diag=diag, xi=np.asarray(xi)[: jd.n_elem],
                   path=np.asarray(path)[: jd.n_elem], nfail=int(nfail))
        tol = dict(R=1e-12, J=1e-10)
    else:
        # the twin itself, plain JAX, on the same trailing arrays
        gN = np.asarray(jd.grad_N)
        u_e = x[np.asarray(jd.edofs)].reshape(jd.n_elem, jd.spec.npe, jd.spec.ndofs_per_node)[:, :, :3]
        gu_T = np.einsum("eni,enj->ije", u_e, gN)
        parT = jnp.asarray(np.asarray(jp.params0)[np.asarray(jd.es_ids)].T)
        bm = jax_batched_model(a.model)
        kin = Kinematics(grad_u=jnp.asarray(gu_T), grad_u_prev=jnp.zeros_like(jnp.asarray(gu_T)))
        xiT, path, failed = bm.local_solve(jnp.asarray(xi_prev.T), kin, parT)
        # the generic residual and Jacobian at the twin's local state
        R, J_e, diag = a.residual_and_jacobian(xj, xpj, xiT.T, xipj, path, jp.params0)
        ref.update(R=R, J_e=np.asarray(J_e), diag=diag, xi=np.asarray(xiT).T, path=np.asarray(path),
                   nfail=int(np.sum(np.asarray(failed))))
        tol = dict(R=1e-9, J=5e-7)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    asm_t = FusedAssembler(tp.disc, tp.model)
    R_t, J_T, diag_t, xi_t, path_t, nfail_t = asm_t.assemble(
        torch.tensor(x), torch.tensor(xi_prev), tp.params0
    )
    port = dict(R=R_t.numpy(), J_T=J_T.numpy(), diag=diag_t.numpy(), xi=xi_t.numpy(),
                path=path_t.numpy(), nfail=int(nfail_t))
    return name, ref, port, tol


def test_path_and_xi(case):
    name, ref, port, _ = case
    assert port["nfail"] == ref["nfail"] == 0
    assert ref["path"].min() == 0 and ref["path"].max() == 1, "single-branch state"
    np.testing.assert_array_equal(port["path"], ref["path"])
    np.testing.assert_allclose(port["xi"], ref["xi"], rtol=0, atol=1e-12)


def test_residual(case):
    name, ref, port, tol = case
    scale = np.abs(ref["R"]).max()
    np.testing.assert_allclose(port["R"], ref["R"], rtol=0, atol=tol["R"] * scale)


def test_jacobian_and_diag(case):
    name, ref, port, tol = case
    J_ref = ref["J_e"]
    scale = np.abs(J_ref).max()
    np.testing.assert_allclose(np.moveaxis(port["J_T"], -1, 0), J_ref, rtol=0, atol=tol["J"] * scale)
    np.testing.assert_allclose(port["diag"], ref["diag"], rtol=0, atol=tol["J"] * scale)


def test_implicit_newton_semantics():
    """The per-lane Newton: an elastic lane is done at the first
    iteration with xi = xi_prev; a lane whose step is not finite gets xi
    + 0 * dxi, NaN, as calibr8_tpu's gated update gives it; a plastic
    lane that the iteration cap cuts short is flagged failed."""
    deck = case_deck(TWINS["small_hill_plane_strain"], num_steps=1)
    tp = Problem(load_deck(deck), device="cpu")
    bm = tp.assembler.bmodel
    E = 3
    parT = tp.params0[0][:, None].expand(-1, E).clone()
    gu = torch.zeros(2, 2, E, dtype=torch.float64)
    gu[1, 1] = torch.tensor([1e-4, 0.05, 0.05])  # elastic, plastic, plastic
    parT[0, 2] = float("nan")  # a NaN modulus: the lane's step is not finite
    xipT = torch.zeros(4, E, dtype=torch.float64)
    xi, path, failed = implicit_newton(bm, xipT, gu, parT)
    assert path.tolist()[:2] == [0, 1] and failed.tolist()[:2] == [0, 0]
    assert torch.equal(xi[:, 0], xipT[:, 0])
    assert bool(torch.isnan(xi[:, 2]).all())
    bm.newton_iters = 1
    _, _, failed1 = implicit_newton(bm, xipT, gu, parT)
    assert failed1.tolist()[:2] == [0, 1]


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors both wrappers are the plain version (and count no
    launch)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.fem.fused_assembly import implicit_assembly

    deck = case_deck(TWINS["small_hill_plane_stress"], num_steps=1)
    tp = Problem(load_deck(deck), device="cpu")
    d = tp.disc
    x = torch.tensor(_state(d.mesh.coords, d.n_nodes, 2, False))
    xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=torch.float64)
    before = dict(kernels.launches)
    bm = tp.assembler.bmodel
    outs = [f(d, bm, x, xi_prev, tp.params0) for f in (fused_assembly, implicit_assembly, fused_assembly_plain)]
    for u, v, w in zip(*outs):
        assert torch.equal(u, w) and torch.equal(v, w)
    assert kernels.launches == before
