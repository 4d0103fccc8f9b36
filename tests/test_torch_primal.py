"""The port's primal solve end to end on the CPU: the goldens of
tests/decks.py through Problem (elastic, small_J2, the small-strain
Hill family, three of the hyper_J2 family's five and the hypo_hill
plane-strain one, mixed u/p and plane stress), the CLI, the device rule,
carrying calibr8_tpu's parameters and state across, and the loud failure
of decks outside the port."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.convert import state_from_numpy
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.amg import AMGPrecondFactory
from tests.decks import BCS_2D, BCS_3D, CUBE, J2_MAT, NOTCH2D, PRIMAL_REGRESSIONS, make_deck

ROOT = Path(__file__).resolve().parents[1]


def _notch_gmres():
    deck, gold, tol, _ = PRIMAL_REGRESSIONS["notch2D_small_J2"]
    deck = copy.deepcopy(deck)
    # 288 dofs: GMRES(200) reaches 1e-12 within its two cycles; exercises
    # the ELL operator, block Gauss-Seidel and the restart loop
    deck["linear algebra"] = {"method": "gmres", "tolerance": 1e-12, "maximum iterations": 400}
    return deck, gold, tol


GOLDENS = {
    "cube_elastic": PRIMAL_REGRESSIONS["cube_elastic"][:3],
    "notch2D_small_J2": PRIMAL_REGRESSIONS["notch2D_small_J2"][:3],
    "notch2D_small_J2_gmres": _notch_gmres(),
    # the small-strain Hill family (implicit mode): plane strain (mixed),
    # plane stress ('mechanics_plane_stress'), 3D small_hill on notch3D
    "notch2D_small_J2_plane_strain": PRIMAL_REGRESSIONS["notch2D_small_J2_plane_strain"][:3],
    "notch2D_small_J2_plane_stress": PRIMAL_REGRESSIONS["notch2D_small_J2_plane_stress"][:3],
    "notch_small_J2": PRIMAL_REGRESSIONS["notch_small_J2"][:3],
    # the finite-deformation J2 family (implicit mode, x_prev read): 3D
    # mixed u/p (elastic, elastic with a traction) and plane strain; the
    # 10-step plastic cube and plane stress take 5-16 s and sit in
    # test_torch_hyper_goldens.py
    "cube_hyperelasticity": PRIMAL_REGRESSIONS["cube_hyperelasticity"][:3],
    "cube_hyperelasticity_traction": PRIMAL_REGRESSIONS["cube_hyperelasticity_traction"][:3],
    "notch2D_hyper_J2_plane_strain": PRIMAL_REGRESSIONS["notch2D_hyper_J2_plane_strain"][:3],
    # the hypo_hill family (implicit mode, the polar rotation, x_prev
    # read): plane strain; plane stress and the 3D notch take 12-26 s and
    # sit in test_torch_hypo_goldens.py
    "notch2D_hypo_J2_plane_strain": PRIMAL_REGRESSIONS["notch2D_hypo_J2_plane_strain"][:3],
}


def check_golden(deck, gold, tol, gmres=False):
    """The port's J of `deck` on the CPU within rel `tol` of `gold`."""
    prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    traj = prob.solve_primal()
    assert abs(traj.J - gold) / abs(gold) <= tol, traj.J
    if gmres:
        assert all(k > 0 for info in traj.newton_info for k in info["krylov_iters"])


@pytest.mark.parametrize("name", list(GOLDENS))
def test_primal_golden(name):
    check_golden(*GOLDENS[name], gmres=name.endswith("gmres"))


def test_cli_primal_prints_pass(tmp_path):
    deck, gold, _ = GOLDENS["cube_elastic"]
    deck = copy.deepcopy(deck)
    deck["regression"] = {"QoI": gold, "relative error tol": 1e-6}
    path = tmp_path / "cube_elastic.yaml"
    path.write_text(yaml.safe_dump({"cube_elastic": deck}))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "calibr8_tpu_torch", "primal", str(path), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "J: " in r.stdout
    assert " PASS" in r.stdout


def test_problem_defaults_to_the_card(monkeypatch):
    """Without `device` the Problem runs on the card, and says so when
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck = copy.deepcopy(GOLDENS["cube_elastic"][0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Problem(load_deck(deck))


def test_state_from_numpy_round_trip():
    deck = make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.001), 1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal(jp.disc.n_dofs)
    xi = rng.standard_normal((jp.disc.n_elem, jp.assembler.nxi))
    params, xt, xit = state_from_numpy(np.asarray(jp.params0), x, xi, device="cpu")
    assert torch.equal(params, tp.params0)
    assert xt.shape == (tp.disc.n_dofs,) and xit.shape == (tp.disc.n_elem, tp.model.nxi())
    np.testing.assert_array_equal(xt.numpy(), x)
    np.testing.assert_array_equal(xit.numpy(), xi)
    with pytest.raises(ValueError):
        state_from_numpy(np.zeros(3), device="cpu")


def _unsupported(key):
    deck = make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1)
    if key == "model":
        # a local residual type outside calibr8_tpu's registry, all of which
        # the port has (its materials are not read before the raise)
        deck["residuals"]["local residual"]["type"] = "unknown_model"
    elif key == "multigrid":
        # multigrid on a mesh without refinements: the aggregation AMG
        deck["linear algebra"] = {"preconditioner": "multigrid"}
    elif key == "amg":
        deck["linear algebra"] = {"preconditioner": "amg"}
    elif key == "jitted":
        deck["residuals"]["global residual"]["solver"] = "jitted"
    elif key == "mesh_file":
        del deck["discretization"]["builtin mesh"]
        deck["discretization"]["mesh file"] = "notch.smb"
    elif key == "refinements":
        # a refined mesh with 'preconditioner: amg': calibr8_tpu picks its
        # aggregation AMG even there
        deck["discretization"]["builtin mesh"] = {"type": "cube", "n": 2, "refinements": 1}
        deck["linear algebra"] = {"preconditioner": "amg"}
    elif key == "plane_stress":
        deck["residuals"]["global residual"]["type"] = "mechanics_plane_stress"
    elif key == "displacement_only":
        deck["residuals"]["global residual"]["mixed formulation"] = False
    elif key == "plane_stress_model_mixed":
        deck = copy.deepcopy(PRIMAL_REGRESSIONS["notch2D_small_J2_plane_stress"][0])
        deck["residuals"]["global residual"]["type"] = "mechanics"
    elif key == "qoi":
        deck["quantity of interest"] = {"type": "average stress"}
    return deck


@pytest.mark.parametrize("key", ["model", "multigrid", "amg", "jitted", "mesh_file", "refinements",
                                 "plane_stress", "displacement_only", "plane_stress_model_mixed",
                                 "qoi"])
def test_decks_outside_the_slice_fail_loudly(key):
    """Decks the port cannot run yet raise NotImplementedError.  small_J2
    under a plane-stress or displacement-only residual, and the plane-
    stress twin under the mixed one, run calibr8_tpu's generic path, not
    the fused assembly.  The multigrid, amg and refinements decks are
    calibr8_tpu's aggregation AMG's (problem.py:180-199): they raised
    until the port had it (solve/amg.py) and keep their ids; they now
    build its AMGPrecondFactory.  The jitted deck likewise now builds the
    jitted step solver (solve/jit_newton.py)."""
    if key == "jitted":
        from calibr8_tpu_torch.solve.jit_newton import JitStepSolver

        prob = Problem(load_deck(_unsupported(key)), device="cpu")
        assert isinstance(prob.step_solver, JitStepSolver)
        assert prob.primal.step_solver is prob.step_solver
        return
    if key in ("multigrid", "amg", "refinements"):
        prob = Problem(load_deck(_unsupported(key)), device="cpu")
        assert isinstance(prob.mg_factory, AMGPrecondFactory)
        assert prob.step_solver.mg_factory is prob.mg_factory
        return
    with pytest.raises(NotImplementedError):
        Problem(load_deck(_unsupported(key)), device="cpu")


def test_unported_model_names_what_it_needs():
    with pytest.raises(NotImplementedError,
                       match="'unknown_model' is not a model of calibr8_tpu's registry; the port "
                             r"has all of them: \[.*'hybrid_hyper_J2_plane_stress'.*"
                             "'isotropic_elastic'"):
        Problem(load_deck(_unsupported("model")), device="cpu")
