"""The FEMU optimizer's host side against calibr8_tpu's, on the CPU, cheap:
the ActiveParams bound views and optimizer box for each scaling, the
measured-field .npz across the two packages, perturb_measured (and the
`perturb` CLI) bit for bit, the checkpoint and trajectory round trips
and a resume, and _EvalWrapper's two failure modes on a toy objective
that raises each package's own NewtonSolveError.  Then the CLI round
trip of the FEMU path on a small deck: `primal` with `write synthetic`,
`perturb` at sigma 0, `inverse` with `fields file` and an `iteration
limit`, and `objective`."""

import copy
import json

import numpy as np
import pytest
import torch

from calibr8_tpu.cli.main import main as jax_cli_main
from calibr8_tpu.io import synthetic as jax_syn
from calibr8_tpu.mesh import generators as jax_generators
from calibr8_tpu.opt import drivers as jax_drivers
from calibr8_tpu.opt.objective import ActiveParams as JaxActive
from calibr8_tpu.solve.newton import NewtonSolveError as JaxNewtonSolveError
from calibr8_tpu_torch.cli.main import main as cli_main
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.io import synthetic as syn
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.opt import drivers
from calibr8_tpu_torch.opt.checkpoint import (load_checkpoint, load_trajectory, save_checkpoint,
                                              save_trajectory)
from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.adjoint import Adjoint
from calibr8_tpu_torch.solve.linear import LinearCfg
from calibr8_tpu_torch.solve.newton import NewtonSolveError
from calibr8_tpu_torch.solve.primal import Trajectory
from tests.decks import BCS_2D, J2_MAT, make_deck

SPECS = {
    "bounds": {"E": [800.0, 1200.0], "Y": [5.0, 15.0]},
    "log": {"E": 1000.0, "K": 50.0},
    "value": {"nu": None, "Y": None},
    "mixed": {"E": [800.0, 1200.0], "K": 50.0, "Y": None},
}
PARAM_NAMES = ["E", "nu", "K", "Y"]


@pytest.mark.parametrize("kind", list(SPECS))
def test_active_bounds_match_jax(kind):
    spec = {"materials": {"body": SPECS[kind]}}
    a = ActiveParams.from_inverse_spec(spec, ["body"], PARAM_NAMES)
    ref = JaxActive.from_inverse_spec(spec, ["body"], PARAM_NAMES)
    assert a.names == ref.names and a.scales == ref.scales
    assert a.opt_bounds() == ref.opt_bounds()
    if kind == "bounds":
        for view in ("lower", "upper"):
            np.testing.assert_array_equal(getattr(a, view), getattr(ref, view))
        for view in ("span", "mean"):
            np.testing.assert_array_equal(getattr(a, view)(), getattr(ref, view)())
    p = np.asarray([1100.0 if n.endswith("E") else 60.0 if n.endswith("K") else 7.5
                    if n.endswith("Y") else 0.3 for n in a.names])
    np.testing.assert_array_equal(a.to_canonical(p), ref.to_canonical(p))


def _with_fields(mesh, seed):
    rng = np.random.default_rng(seed)
    for step in range(3):
        mesh.fields[f"measured_{step}"] = rng.standard_normal((mesh.n_nodes, 2))
    mesh.fields["distance"] = rng.uniform(size=mesh.n_nodes)
    return mesh


@pytest.mark.parametrize("writer", ["port", "calibr8_tpu"])
def test_fields_npz_across_packages(tmp_path, writer):
    src = _with_fields((generators if writer == "port" else jax_generators).notch2d(0.3), 3)
    dst = (jax_generators if writer == "port" else generators).notch2d(0.3)
    path = str(tmp_path / "fields.npz")
    (syn if writer == "port" else jax_syn).save_fields(src, path)
    (jax_syn if writer == "port" else syn).load_fields(dst, path)
    assert list(dst.fields) == list(src.fields)
    for k, v in src.fields.items():
        np.testing.assert_array_equal(dst.fields[k], v)


def test_perturb_measured_bitwise():
    a = _with_fields(generators.notch2d(0.3), 4)
    b = jax_generators.notch2d(0.3)
    b.fields = {k: v.copy() for k, v in a.fields.items()}
    syn.perturb_measured(a, 1e-3, seed=11)
    jax_syn.perturb_measured(b, 1e-3, seed=11)
    for k, v in b.fields.items():
        np.testing.assert_array_equal(a.fields[k], v)
    assert np.array_equal(a.fields["measured_0"], b.fields["measured_0"])
    assert not np.array_equal(a.fields["measured_1"], _with_fields(generators.notch2d(0.3),
                                                                   4).fields["measured_1"])


def test_perturb_cli_bitwise(tmp_path):
    src = str(tmp_path / "fields.npz")
    syn.save_fields(_with_fields(generators.notch2d(0.3), 5), src)
    out, ref = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    assert cli_main(["perturb", src, "--sigma", "2e-4", "--out", out]) == 0
    assert jax_cli_main(["perturb", src, "--sigma", "2e-4", "--out", ref]) == 0
    with np.load(out) as a, np.load(ref) as b:
        assert a.files == b.files
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


class Quadratic:
    """A toy objective over the canonical coordinates, minimum at c."""

    def __init__(self, c):
        self.c = np.asarray(c, dtype=float)
        self.calls = []

    def value(self, x):
        self.calls.append(np.asarray(x, dtype=float).copy())
        return float(np.sum((np.asarray(x) - self.c) ** 2))

    def gradient(self, x):
        return 2.0 * (np.asarray(x) - self.c)

    def value_and_gradient(self, x):
        return self.value(x), self.gradient(x)


def _active():
    return ActiveParams([(0, 0, "body/a"), (0, 1, "body/b")], [(0.0, 2.0), (1.0, 3.0)])


def test_checkpoint_round_trip_and_resume(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    hist = [(np.asarray([0.1, -0.2]), 3.0), (np.asarray([0.3, 0.4]), 1.5)]
    save_checkpoint(path, np.asarray([0.3, 0.4]), hist, meta={"names": ["a", "b"]})
    x, h, meta = load_checkpoint(path)
    np.testing.assert_array_equal(x, [0.3, 0.4])
    assert meta == {"names": ["a", "b"]}
    assert [float(J) for _, J in h] == [3.0, 1.5]
    np.testing.assert_array_equal(np.stack([r for r, _ in h]), np.stack([r for r, _ in hist]))

    active, c = _active(), [0.25, -0.5]
    first = drivers.run_inverse(Quadratic(c), active, max_iters=1, checkpoint_path=path)
    saved, saved_hist, meta = load_checkpoint(path)
    assert meta == {"names": active.names, "final": True}
    np.testing.assert_array_equal(saved, first.x_canonical)
    assert len(saved_hist) == first.n_evals
    obj = Quadratic(c)
    res = drivers.run_inverse(obj, active, x0=np.zeros(2), checkpoint_path=path, resume=True)
    np.testing.assert_array_equal(obj.calls[0], saved)
    np.testing.assert_allclose(res.x_canonical, c, atol=1e-8)


def test_trajectory_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    traj = Trajectory(x=[torch.tensor(rng.standard_normal(7)) for _ in range(3)],
                      xi=[torch.tensor(rng.standard_normal((4, 2))) for _ in range(3)],
                      path=[torch.tensor(rng.integers(0, 2, 4), dtype=torch.int32)
                            for _ in range(3)],
                      qoi_values=[0.5, 0.25])
    path = str(tmp_path / "traj.npz")
    save_trajectory(path, traj)
    back = load_trajectory(path, device="cpu")
    for k in ("x", "xi", "path"):
        for a, b in zip(getattr(back, k), getattr(traj, k)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert back.qoi_values == traj.qoi_values and back.J == traj.J


class Failing(Quadratic):
    """Quadratic, but the forward solve fails where x[0] > 0.5."""

    def __init__(self, c, error):
        super().__init__(c)
        self.error = error

    def value(self, x):
        if x[0] > 0.5:
            raise self.error("diverged")
        return super().value(x)


@pytest.mark.parametrize("mode", ["penalty_inward", "repeat_last"])
def test_eval_wrapper_failure_modes_match_jax(mode):
    c = [0.1, 0.2]
    port = drivers._EvalWrapper(Failing(c, NewtonSolveError), mode)
    ref = jax_drivers._EvalWrapper(Failing(c, JaxNewtonSolveError), mode)
    xs = [np.asarray(v) for v in ([0.9, 0.0], [0.0, 0.1], [0.3, -0.2], [0.8, 0.4], [0.7, 0.9],
                                  [0.2, 0.2])]
    for x in xs:
        got, want = port.value_and_grad(x), ref.value_and_grad(x)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert port.value(x) == ref.value(x)
    assert port.call_log == ref.call_log and port.n_evals == ref.n_evals
    assert port.n_failed == 2 * 3
    assert [float(J) for _, J in port.history] == [float(J) for _, J in ref.history]


def femu_cli_deck(qoi):
    """notch2D h=0.3 small_J2 (mixed u/p, the analytic twin) over 2 steps,
    Y active in [5, 15] from 12 (truth 10)."""
    deck = make_deck({"type": "notch2D", "h": 0.3}, "small_J2", J2_MAT, BCS_2D(0.02), 2)
    deck["quantity of interest"] = qoi
    deck["inverse"] = {"materials": {"body": {"Y": [5.0, 15.0]}}}
    return deck


def test_cli_femu_round_trip(tmp_path, monkeypatch, capsys):
    """primal (write synthetic, reaction mismatch writing load.dat) ->
    perturb (sigma 0) -> inverse (fields file, iteration limit) ->
    objective, each exiting 0; Y recovered and gradient.dat equal to the
    objective's gradient at the deck's Y."""
    monkeypatch.chdir(tmp_path)
    plane = {"coordinate index": 1, "coordinate value": 1.0, "coordinate tolerance": 1e-6,
             "reaction force component": 1}
    fwd = femu_cli_deck({"type": "reaction mismatch", **plane, "load out file": "load.dat"})
    fwd["problem"] = {"name": "fwd", "write synthetic": True}
    (tmp_path / "fwd.yaml").write_text(json.dumps({"fwd": fwd}))
    assert cli_main(["primal", "fwd.yaml", "--device", "cpu"]) == 0
    assert cli_main(["perturb", "fwd_synthetic.npz", "--sigma", "0", "--out", "meas.npz"]) == 0
    with np.load("fwd_synthetic.npz") as a, np.load("meas.npz") as b:
        assert a.files == b.files == ["measured_0", "measured_1", "measured_2"]
    cal = femu_cli_deck({"type": "calibration", "balance factor": 1.0, **plane,
                         "displacement weights": [1e6, 1e6], "load input file": "load.dat"})
    cal["residuals"]["local residual"]["materials"]["body"]["Y"] = 12.0
    cal["discretization"]["fields file"] = "meas.npz"
    cal["inverse"].update({"iteration limit": 20, "gradient tolerance": 1e-12})
    (tmp_path / "cal.yaml").write_text(json.dumps({"cal": cal}))
    assert cli_main(["inverse", "cal.yaml", "--device", "cpu", "--out", "params.txt"]) == 0
    Y = float(open("params.txt").read().split(":")[1])
    assert abs(Y - 10.0) / 10.0 < 5e-3, Y
    assert cli_main(["objective", "cal.yaml", "--device", "cpu"]) == 0
    g = np.loadtxt("gradient.dat", ndmin=1)
    J = float(open("objective.dat").read())

    prob = Problem(load_deck(copy.deepcopy(cal)), device="cpu")
    syn.load_fields(prob.mesh, "meas.npz")
    active = ActiveParams.from_inverse_spec(cal["inverse"], prob.disc.elem_set_names,
                                            prob.model.param_names)
    obj = AdjointObjective(prob, Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg()), active)
    x0 = active.to_canonical(active.extract(prob.params0))
    g_ref = obj.gradient(x0)
    assert J == pytest.approx(obj.value(x0), rel=1e-12)
    assert np.abs(g - g_ref).max() <= 1e-10 * np.abs(g_ref).max()


def test_cli_objective_femu_writes_value_only(tmp_path, monkeypatch):
    """`objective` on an `objective type: FEMU` deck: the value-only
    objective writes objective.dat, the primal's J at the deck's
    parameters, and no gradient.dat."""
    monkeypatch.chdir(tmp_path)
    plane = {"coordinate index": 1, "coordinate value": 1.0, "coordinate tolerance": 1e-6,
             "reaction force component": 1}
    deck = femu_cli_deck({"type": "reaction mismatch", **plane})
    deck["inverse"]["objective type"] = "FEMU"
    (tmp_path / "femu.yaml").write_text(json.dumps({"femu": deck}))
    assert cli_main(["objective", "femu.yaml", "--device", "cpu"]) == 0
    assert not (tmp_path / "gradient.dat").exists()
    J = float(open("objective.dat").read())
    J_primal = Problem(load_deck(copy.deepcopy(deck)), device="cpu").solve_primal().J
    assert J > 0.0
    assert J == pytest.approx(J_primal, rel=1e-12)
