"""The calibration and reaction-mismatch QoIs of the port against
calibr8_tpu's, float64 on the CPU, on notch2D h=0.3 with 2 load steps
(small_hill_plane_stress, tests/test_calibration_recovery.py's deck,
test_torch_femu_recovery.deck):

 1. each step's value and its x / xi / p partials (calibr8_tpu: evaluate
    and jax.grad of it) on calibr8_tpu's own converged calibration state,
    with the distance mask off and on (a seeded `distance` field), to
    1e-12 of max|.|;
 2. the calibration AdjointObjective's J and canonical dJ/dp at the start
    point, each package running its own primal, to 1e-8 (as the notch2D
    small_J2 dJ/dp test holds them);
 3. the 3D form of the calibration QoI (J_disp over the facets of the
    `displacement side set`, order-2 facet rule), on cube n=2 under
    `mechanics` (small_J2, mixed u/p), with the distance mask off and on:
    value and x / xi / p partials to 1e-12 of max|.| at a seeded state.

The port writes the synthetic data at the truth (its load.dat and
measured_<step> fields), and both packages read the same."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.mesh import generators as jax_generators
from calibr8_tpu.opt.objective import ActiveParams as JaxActive
from calibr8_tpu.opt.objective import AdjointObjective as JaxObjective
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.qoi import create_qoi as jax_create_qoi
from calibr8_tpu.solve.adjoint import Adjoint as JaxAdjoint
from calibr8_tpu.solve.linear import LinearCfg as JaxLinearCfg
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.io.synthetic import attach_synthetic
from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.qoi import create_qoi
from calibr8_tpu_torch.solve.adjoint import Adjoint
from calibr8_tpu_torch.solve.linear import LinearCfg
from calibr8_tpu_torch.mesh import generators
from tests.decks import BCS_3D, CUBE, J2_MAT, make_deck
from tests.test_torch_femu_recovery import ACTIVE, PLANE, START, TRUTH, deck

DISTANCE_THRESHOLD = 0.5

def qoi_decks(load_file):
    cal = {"type": "calibration", "balance factor": 4.22, **PLANE,
           "displacement weights": [3.98e7, 3.98e7], "load input file": load_file}
    return {
        "calibration, no mask": deck(START, cal),
        "calibration, distance mask": deck(START, {**cal,
                                                   "distance threshold": DISTANCE_THRESHOLD}),
        "reaction mismatch": deck(START, {"type": "reaction mismatch", **PLANE,
                                          "load input file": load_file}),
    }


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """The port's synthetic data at the truth (load.dat, measured_<step>)
    plus a seeded `distance` field, on the port's mesh and on calibr8_tpu's
    copy of it; each package's Problem on the unmasked calibration deck;
    and calibr8_tpu's calibration objective at the start point with its J
    and canonical dJ/dp (its primal trajectory stays cached)."""
    load_file = str(tmp_path_factory.mktemp("femu") / "load.dat")
    syn = Problem(load_deck(deck(TRUTH, {"type": "reaction mismatch", **PLANE,
                                         "load out file": load_file})), device="cpu")
    attach_synthetic(syn.mesh, syn.disc, syn.solve_primal())
    syn.mesh.fields["distance"] = np.random.default_rng(7).uniform(0.0, 1.0, syn.mesh.n_nodes)
    jax_mesh = jax_generators.notch2d(0.3)
    assert np.array_equal(jax_mesh.coords, syn.mesh.coords)
    assert np.array_equal(jax_mesh.conn, syn.mesh.conn)
    jax_mesh.fields = dict(syn.mesh.fields)

    d = qoi_decks(load_file)["calibration, no mask"]
    jp = JaxProblem(jax_load_deck(copy.deepcopy(d)), mesh=jax_mesh)
    tp = Problem(load_deck(copy.deepcopy(d)), mesh=syn.mesh, device="cpu")
    jactive = JaxActive.from_inverse_spec(ACTIVE, jp.disc.elem_set_names, jp.model.param_names)
    jobj = JaxObjective(jp, JaxAdjoint(jp.assembler, jp.qoi, jp.dbcs, JaxLinearCfg()), jactive)
    x0 = jactive.to_canonical(jactive.extract(jp.params0))
    J_ref, g_ref = jobj.value_and_gradient(x0)
    return dict(load_file=load_file, jax_problem=jp, problem=tp, jax_obj=jobj, x0=x0,
                J_ref=J_ref, g_ref=g_ref)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_qoi_values_and_partials_match_jax(synthetic):
    """Each deck's QoI made by each package's registry on the fixture's
    Problems (the reaction QoIs handed the Problem's assembler, as each
    Problem does), at each step of calibr8_tpu's converged state."""
    jp, tp = synthetic["jax_problem"], synthetic["problem"]
    jobj, x0 = synthetic["jax_obj"], synthetic["x0"]
    traj = jobj._solve(x0)
    params = np.asarray(jobj._params_all(x0))
    n_masked = 0
    for label, d in qoi_decks(synthetic["load_file"]).items():
        cfg = dict(d["quantity of interest"])
        qtype = cfg.pop("type")
        jq = jax_create_qoi(qtype, jp.disc, dict(cfg), model=jp.model)
        tq = create_qoi(qtype, tp.disc, dict(cfg))
        jq.assembler, tq.assembler = jp.assembler, tp.assembler
        if label == "calibration, distance mask":
            n_masked = int((~np.asarray(jq.elem_mask)).sum())
            assert 0 < n_masked < tp.disc.n_elem
            assert tq.area == pytest.approx(jq.area, rel=1e-14)
        tg = jp.time_grid
        for step in (1, 2):
            args = (traj.x[step], traj.x[step - 1], traj.xi[step], params)
            ja = jq.setup_step(step, tg.time(step), tg.dt(step), tg.total_time)
            ta = tq.setup_step(step, tg.time(step), tg.dt(step), tg.total_time)
            targs = tuple(torch.tensor(np.asarray(a)) for a in args)
            J_ref = float(jq.evaluate(*(jnp.asarray(a) for a in args), ja))
            J = float(tq.evaluate(*targs, ta))
            assert abs(J - J_ref) <= 1e-12 * abs(J_ref), (label, step, J, J_ref)
            ref = jq.partials(*(jnp.asarray(a) for a in args), ja)
            got = tq.partials(*targs, ta)
            for name, a, b in zip(("x", "xi", "p"), got, ref):
                assert a.shape == tuple(b.shape), (label, step, name)
                assert np.abs(np.asarray(b)).max() > 0.0, (label, step, name)
                assert _rel(a, b) <= 1e-12, (label, step, name, _rel(a, b))
    assert n_masked > 0


def test_calibration_gradient_matches_jax(synthetic):
    """J and canonical dJ/d(Y, D) of the calibration AdjointObjective at the
    start point (Y 2.5, D 2.8), each package running its own primal."""
    tp = synthetic["problem"]
    active = ActiveParams.from_inverse_spec(ACTIVE, tp.disc.elem_set_names, tp.model.param_names)
    obj = AdjointObjective(tp, Adjoint(tp.assembler, tp.qoi, tp.dbcs, LinearCfg()), active)
    J, g = obj.value_and_gradient(synthetic["x0"])
    J_ref, g_ref = synthetic["J_ref"], synthetic["g_ref"]
    assert J > 0.0 and np.all(np.abs(g) > 0.0)
    assert abs(J - J_ref) <= 1e-8 * abs(J_ref), (J, J_ref)
    assert _rel(g, g_ref) <= 1e-8, (g, g_ref)


@pytest.fixture(scope="module")
def cube3d():
    """Each package's Problem on cube n=2 under `mechanics` (small_J2, mixed
    u/p, 2 steps) with seeded measured_1 and distance fields, and a seeded
    state (x, x_prev, xi, the deck's parameters)."""
    rng = np.random.default_rng(11)
    d = make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.01), 2)
    mesh, jax_mesh = generators.cube(CUBE["n"]), jax_generators.cube(CUBE["n"])
    assert np.array_equal(mesh.coords, jax_mesh.coords)
    assert np.array_equal(mesh.conn, jax_mesh.conn)
    mesh.fields["measured_1"] = 1e-3 * rng.standard_normal((mesh.n_nodes, 3))
    mesh.fields["distance"] = rng.uniform(0.0, 1.0, mesh.n_nodes)
    jax_mesh.fields = dict(mesh.fields)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(d)), mesh=jax_mesh)
    tp = Problem(load_deck(copy.deepcopy(d)), mesh=mesh, device="cpu")
    n_dofs, E, nxi = tp.disc.n_dofs, tp.disc.n_elem, tp.assembler.bmodel.nxi
    x_prev = 1e-3 * rng.standard_normal(n_dofs)
    state = (x_prev + 1e-3 * rng.standard_normal(n_dofs), x_prev,
             1e-4 * rng.uniform(0.0, 1.0, (E, nxi)), np.asarray(jp.params0))
    return jp, tp, state


@pytest.mark.parametrize("masked", [False, True], ids=["no mask", "distance mask"])
def test_calibration_3d_side_set_matches_jax(cube3d, masked):
    """The calibration QoI in 3D: J_disp over the `ymax` side set's facets
    (the load plane y = 1 as well), each package's evaluate and partials
    at step 1 of 2 of the cube's seeded state."""
    jp, tp, state = cube3d
    cfg = {"balance factor": 2.5, **PLANE, "displacement weights": [3.0e4, 2.0e4, 1.0e4],
           "displacement side set": "ymax"}
    if masked:
        cfg["distance threshold"] = DISTANCE_THRESHOLD
    jq = jax_create_qoi("calibration", jp.disc, dict(cfg), model=jp.model)
    tq = create_qoi("calibration", tp.disc, dict(cfg))
    jq.assembler, tq.assembler = jp.assembler, tp.assembler
    assert tq.area == pytest.approx(jq.area, rel=1e-14)
    n_facets = len(tp.mesh.side_sets["ymax"])
    assert tq._nodes.shape[0] == np.asarray(jq.facet_nodes).shape[0]
    assert (0 < tq._nodes.shape[0] < n_facets) if masked else tq._nodes.shape[0] == n_facets

    tg = jp.time_grid
    ja = jq.setup_step(1, tg.time(1), tg.dt(1), tg.total_time)
    ta = tq.setup_step(1, tg.time(1), tg.dt(1), tg.total_time)
    jargs = tuple(jnp.asarray(a) for a in state)
    targs = tuple(torch.tensor(a) for a in state)
    J_ref = float(jq.evaluate(*jargs, ja))
    J = float(tq.evaluate(*targs, ta))
    assert J_ref > 0.0
    assert abs(J - J_ref) <= 1e-12 * abs(J_ref), (J, J_ref)
    for name, a, b in zip(("x", "xi", "p"), tq.partials(*targs, ta), jq.partials(*jargs, ja)):
        assert a.shape == tuple(b.shape), name
        assert np.abs(np.asarray(b)).max() > 0.0, name
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))
