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


HYPER = {
    # name: (dim, param_names, init_xi)
    "hyper_J2": (3, ("E", "nu", "Y", "S", "D", "A", "n", "K"), [0, 0, 0, 0, 0, 0, 1, 0]),
    "hyper_J2_plane_strain": (2, ("E", "nu", "K", "Y", "Y_inf", "delta"), [0, 0, 0, 1, 0]),
    "hyper_J2_plane_stress": (2, ("E", "nu", "Y", "S", "D", "A", "n", "K"), [0, 0, 0, 1, 1, 0]),
}


def test_hyper_registry_and_first_guess():
    """The three finite-deformation models as calibr8_tpu registers them
    (models/hyper_j2.py), and the first guess of their local Newton: the
    elastic trial state, which is xi_prev when F = F_prev (no relative
    deformation); the small-strain twins start from xi_prev whatever F
    is.  A small elastic step of a mixed twin converges at the first guess
    (the plane-stress twin still solves for lambda_z)."""
    from calibr8_tpu_torch.models import create_local_model
    from calibr8_tpu_torch.models.batched import get_batched_model

    E = 4
    rng = np.random.default_rng(3)
    for name, (dim, names, init) in HYPER.items():
        m = create_local_model(name, dim)
        assert m.param_names == names and m.nxi() == len(init)
        np.testing.assert_array_equal(m.init_xi(), init)
        m.abs_tol = 1e-12
        bm = get_batched_model(m)
        assert bm.finite_deformation and not bm.analytic_solve
        parT = torch.tensor([[1000.0, 0.25] + [10.0] * (len(names) - 2)] * E, dtype=torch.float64).T
        if name == "hyper_J2_plane_strain":
            parT[2:] = torch.tensor([50.0, 10.0, 15.0, 2.0], dtype=torch.float64)[:, None]
        else:
            parT[2:] = torch.tensor([10.0, 5.0, 2.0, 0.0, 0.0, 50.0], dtype=torch.float64)[:, None]
        xipT = torch.tensor(init, dtype=torch.float64)[:, None].repeat(1, E)
        gu = torch.tensor(1e-4 * rng.standard_normal((dim, dim, E)))
        np.testing.assert_allclose(bm.first_guess(xipT, gu, parT, gu).numpy(), xipT.numpy(),
                                   rtol=0, atol=1e-15)
        xi, path, failed = bm.local_solve(xipT, gu, parT, torch.zeros_like(gu))
        assert path.tolist() == [0] * E and failed.tolist() == [0] * E
        if not bm.plane_stress:
            assert torch.equal(xi, bm.first_guess(xipT, gu, parT, torch.zeros_like(gu)))
        with pytest.raises(ValueError, match="grad_u_prev"):
            bm.first_guess(xipT, gu, parT)
    hill = get_batched_model(create_local_model("small_hill_plane_strain", 2))
    xipT = torch.tensor(rng.standard_normal((4, E)))
    gu = torch.tensor(rng.standard_normal((2, 2, E)))
    assert torch.equal(hill.first_guess(xipT, gu, None), xipT)
    with pytest.raises(NotImplementedError, match="3D only"):
        get_batched_model(create_local_model("hyper_J2", 2))


def test_hyper_wrappers_run_plain_version_on_cpu():
    """On CPU tensors the wrappers are the plain version for a hyper twin
    too (and count no launch), and report each element's local Newton
    iterations as the kernel does; x_prev is required."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.fem.fused_assembly import implicit_assembly

    deck = case_deck(TWINS["hyper_J2_plane_stress"], num_steps=1)
    tp = Problem(load_deck(deck), device="cpu")
    d = tp.disc
    x = torch.tensor(_state(d.mesh.coords, d.n_nodes, 2, False))
    x_prev = torch.tensor(_state(d.mesh.coords, d.n_nodes, 2, False, scale=0.01, seed=4))
    xi_prev = torch.tensor(tp.model.init_xi())[None].repeat(d.n_elem, 1)
    before = dict(kernels.launches)
    bm = tp.assembler.bmodel
    outs = [f(d, bm, x, xi_prev, tp.params0, x_prev=x_prev)
            for f in (fused_assembly, implicit_assembly, fused_assembly_plain)]
    for u, v, w in zip(*outs):
        assert torch.equal(u, w) and torch.equal(v, w)
    assert 0 < int(outs[0][3].sum()) < d.n_elem
    assert kernels.launches == before
    iters = torch.full((d.n_elem,), -1, dtype=torch.int32)
    implicit_assembly(d, bm, x, xi_prev, tp.params0, newton_iters=iters, x_prev=x_prev)
    # the plane-stress twin solves for lambda_z even where elastic
    assert 1 <= int(iters.min()) and int(iters.max()) <= bm.newton_iters
    with pytest.raises(ValueError, match="grad_u_prev"):
        fused_assembly(d, bm, x, xi_prev, tp.params0)


HYPO = {
    # name: (dim, param_names, initial xi)
    "hypo_hill": (3, ("E", "nu", "Y", "R00", "R11", "R22", "R01", "R02", "R12", "S", "D"), [0.0] * 7),
    "hypo_hill_plane_strain": (2, ("E", "nu", "Y", "S", "D", "R00", "R11", "R22", "R01"),
                               [0.0] * 5),
    "hypo_hill_plane_stress": (2, ("E", "nu", "Y", "S", "D", "R00", "R11", "R22", "R01", "Q00", "Q01",
                                   "Q10", "Q11"), [0.0, 0.0, 0.0, 0.0, 1.0]),
}


class _NoHoist:
    """A twin seen without its precompute hook."""

    def __init__(self, bm):
        self._bm = bm

    def __getattr__(self, k):
        if k == "precompute":
            raise AttributeError(k)
        return getattr(self._bm, k)


def test_hypo_registry_first_guess_and_hoist():
    """The three hypo models as calibr8_tpu registers them (models/hypo.py),
    their kernel ids, the first guess of their local Newton (xi_prev when
    F = F_prev: no rate), and implicit_newton with the rate hoisted out of
    the loop (precompute / residual_aux) against the same Newton that
    forms it in every residual: the same xi, path, failures and
    iteration counts, in a state where some elements yield."""
    from calibr8_tpu_torch.models import create_local_model
    from calibr8_tpu_torch.models.batched import KERNEL_MODEL_ID, get_batched_model

    E = 64
    rng = np.random.default_rng(5)
    for name, (dim, names, init) in HYPO.items():
        m = create_local_model(name, dim)
        assert m.param_names == names and m.nxi() == len(init)
        np.testing.assert_array_equal(m.init_xi(), init)
        m.abs_tol = 1e-12
        bm = get_batched_model(m)
        assert bm.finite_deformation and not bm.analytic_solve and bm.newton_iters == 20
        assert KERNEL_MODEL_ID[name] == 6 + list(HYPO).index(name)
        mats = {"E": 1000.0, "nu": 0.25, "Y": 10.0, "S": 5.0, "D": 2.0, "R00": 1.0, "R11": 1.1,
                "R22": 0.95, "R01": 1.05, "R02": 1.0, "R12": 1.0, "Q00": 0.8, "Q01": -0.6,
                "Q10": 0.6, "Q11": 0.8}
        parT = torch.tensor([mats[k] for k in names], dtype=torch.float64)[:, None].repeat(1, E)
        xipT = torch.tensor(init, dtype=torch.float64)[:, None] + torch.tensor(
            1e-4 * rng.standard_normal((len(init), E)))
        xipT[3 if dim == 2 else 6] = xipT[3 if dim == 2 else 6].abs()
        gu_prev = torch.tensor(0.01 * rng.standard_normal((dim, dim, E)))
        np.testing.assert_allclose(bm.first_guess(xipT, gu_prev, parT, gu_prev).numpy(),
                                   xipT.numpy(), rtol=0, atol=1e-15)
        # increments from none to ~2%: some elements yield, some do not
        gu = gu_prev + torch.tensor(0.02 * np.linspace(0.0, 1.0, E) * rng.standard_normal((dim, dim, E)))
        runs = []
        for twin in (bm, _NoHoist(bm)):
            iters = torch.zeros(E, dtype=torch.int32)
            runs.append(implicit_newton(twin, xipT, gu, parT, gu_prev, iters) + (iters,))
        (xi, path, failed, iters), (xi2, path2, failed2, iters2) = runs
        assert 0 < int(path.sum()) < E and int(failed.sum()) == 0
        for a, b in ((path, path2), (failed, failed2), (iters, iters2)):
            assert torch.equal(a, b)
        assert float((xi - xi2).abs().max()) <= 1e-14 * float(xi.abs().max())
        with pytest.raises(ValueError, match="grad_u_prev"):
            bm.first_guess(xipT, gu, parT)
    with pytest.raises(ValueError, match="3D model"):
        create_local_model("hypo_hill", 2)


def test_probe_plain_version_matches_numpy():
    """Kernel 4's plain version (probe.py) on the CPU: the inverse trig
    within its limits of numpy, the three loop forms equal to numpy's
    loop; no launch is counted."""
    from calibr8_tpu_torch import kernels, probe

    before = dict(kernels.launches)
    records, outs = probe.run(torch.device("cpu"))
    assert [r["probe"] for r in records] == ["trig", "trig", "loop"]
    assert all(r["ok"] for r in records), records
    assert outs["float32"].dtype == torch.float32 and outs["loop"].shape == (3, 8, 1024)
    assert kernels.launches == before
    assert probe.main(["--device", "cpu"]) == 0


def test_isotropic_and_hybrid_registry_defaults_and_cap():
    """isotropic_elastic and the hybrid as calibr8_tpu registers them
    (models/elastic.py:68, models/hybrid.py): the analytic displacement-
    only twin takes only non-mixed specs; the hybrid's parameters are E, nu,
    Y and its network's weights nn_<i>, which the deck may leave out (they
    default to the network's initial ones, as calibr8_tpu's problem.py:
    122-134 fills them).  The kernel's network cap raises
    NotImplementedError in the wrapper's argument check; the plain version
    on CPU tensors takes any network and counts no launch."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.fem.fused_assembly import check_supported, hybrid_net_args
    from calibr8_tpu_torch.mechanics.global_residual import MechanicsSpec
    from calibr8_tpu_torch.models import create_local_model
    from calibr8_tpu_torch.models.batched import get_batched_model
    from calibr8_tpu_torch.models.nn import FFNN

    iso = create_local_model("isotropic_elastic", 3)
    assert iso.param_names == ("E", "nu") and iso.nxi() == 1
    iso.abs_tol = 1e-12
    bm = get_batched_model(iso)
    assert bm.analytic_solve and bm.displacement_only
    check_supported(bm, MechanicsSpec(dim=3, mixed=False))
    check_supported(bm, MechanicsSpec(dim=2, mixed=False, plane_stress=True))
    with pytest.raises(NotImplementedError, match="displacement-only"):
        check_supported(bm, MechanicsSpec(dim=3))

    net = {"activation function": "tanh", "topology": [1, 3, 2, 1], "output scale": 2.0}
    m = create_local_model("hybrid_hyper_J2_plane_stress", 2, config={"embedded model": net})
    assert m.param_names[:3] == ("E", "nu", "Y") and len(m.param_names) == 3 + 6 + 8 + 3
    assert m.param_names[3:] == tuple(f"nn_{i}" for i in range(17))
    w0 = FFNN("tanh", [1, 3, 2, 1]).init_params
    np.testing.assert_array_equal(m.default_params(), np.concatenate([np.zeros(3), w0]))
    deck = case_deck(TWINS["hybrid_hyper_J2_plane_stress"], num_steps=1)
    lr = deck["residuals"]["local residual"]
    lr["embedded model"] = net
    lr["materials"]["body"]["nn_2"] = 0.125
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    want = np.concatenate([[1000.0, 0.25, 10.0], w0])
    want[3 + 2] = 0.125
    np.testing.assert_array_equal(tp.params0.numpy()[0], want)
    bm = tp.assembler.bmodel
    args = hybrid_net_args(bm, tp.params0)
    assert args[:2] == (2, 3) and list(args[2]) == [1, 3, 2, 1] and args[3:] == (1.0, 2.0, 20)

    for topo in ([1, 17, 1], [1, 2, 2, 2, 2, 2, 1], [2, 4, 1]):
        bm.nn = FFNN("tanh", topo)
        with pytest.raises(NotImplementedError, match="cap"):
            hybrid_net_args(bm, tp.params0)
    bm.nn = FFNN("tanh", [1, 16, 16, 16, 16, 1])
    hybrid_net_args(bm, tp.params0)

    # the plain version has no cap: 20 hidden units on the CPU
    lr["embedded model"] = {**net, "topology": [1, 20, 1]}
    lr["materials"]["body"].pop("nn_2")
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    d = tp.disc
    x = torch.tensor(_state(d.mesh.coords, d.n_nodes, 2, False))
    xi_prev = torch.tensor(tp.model.init_xi())[None].repeat(d.n_elem, 1)
    before = dict(kernels.launches)
    out = fused_assembly(d, tp.assembler.bmodel, x, xi_prev, tp.params0, x_prev=0.5 * x)
    ref = fused_assembly_plain(d, tp.assembler.bmodel, x, xi_prev, tp.params0, x_prev=0.5 * x)
    assert all(torch.equal(u, v) for u, v in zip(out, ref))
    assert kernels.launches == before and bool(torch.isfinite(out[1]).all())
