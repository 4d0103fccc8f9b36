"""The jitted step solver (solve/jit_newton.py) against calibr8_tpu's
solve/jit_newton.py, on the CPU, where the port runs its pieces eagerly:
the trajectory against jax.jit(run), the deck opt-in against calibr8_tpu's
JitStepSolver, the multigrid refusal, and the multi-experiment batch
against jax.jit(jax.vmap(run)).  float64 on both sides."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve.jit_newton import JitStepSolver as JaxJitStepSolver
from calibr8_tpu.solve.jit_newton import make_jit_trajectory as jax_make_jit_trajectory
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.jit_newton import JitStepSolver, JitTrajectory
from tests.decks import BCS_2D, J2_MAT, make_deck

NOTCH = {"type": "notch2D", "h": 0.25}
HILL_PS = {"E": 1000.0, "nu": 0.25, "Y": 2.0, "S": 10.0, "D": 2.0,
           "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}
HILL_DECK = make_deck(NOTCH, "small_hill_plane_stress", HILL_PS, BCS_2D(0.005), 3,
                      global_type="mechanics_plane_stress")


def _jitted(deck):
    deck = copy.deepcopy(deck)
    deck["residuals"]["global residual"]["solver"] = "jitted"
    return deck


# tests/test_jit_newton.py's decks: its trajectory deck (small_J2, 3
# steps) for the batch, its opt-in deck (x at calibr8_tpu's own 1e-9:
# its CPU path and the port's kernel 1a take different tangents at
# converged plastic states) and its multigrid deck
J2_TRAJ_DECK = make_deck(NOTCH, "small_J2", J2_MAT, BCS_2D(0.002), 3)
J2_DECK = _jitted(make_deck(NOTCH, "small_J2", J2_MAT, BCS_2D(0.002), 2))
MG_DECK = _jitted(make_deck(NOTCH, "small_J2", J2_MAT, BCS_2D(0.002), 1))
MG_DECK["linear algebra"] = {"method": "gmres", "tolerance": 1e-8, "maximum iterations": 200,
                             "preconditioner": "multigrid"}
MG_DECK["discretization"]["builtin mesh"]["refinements"] = 1


def _np(outs):
    return [np.asarray(o) for o in outs]


@pytest.fixture(scope="module")
def ref():
    """calibr8_tpu's trajectory of HILL_DECK under jax.jit, that of
    J2_TRAJ_DECK under jax.jit(jax.vmap) for three experiments (params x1,
    x1.05, x0.95), and its JitStepSolver run of J2_DECK."""
    jp = JaxProblem(jax_load_deck(copy.deepcopy(HILL_DECK)))
    single = _np(jax.jit(jax_make_jit_trajectory(jp.assembler, jp.time_grid, jp.dbcs))(
        jp.params0))
    jp = JaxProblem(jax_load_deck(copy.deepcopy(J2_TRAJ_DECK)))
    run = jax_make_jit_trajectory(jp.assembler, jp.time_grid, jp.dbcs)
    base = np.asarray(jp.params0)
    batch = np.stack([base, 1.05 * base, 0.95 * base])
    batched = _np(jax.jit(jax.vmap(run))(jnp.asarray(batch)))
    pj = JaxProblem(jax_load_deck(copy.deepcopy(J2_DECK)))
    assert isinstance(pj.step_solver, JaxJitStepSolver)
    tj = pj.solve_primal()
    return dict(single=single, batch=batch, batched=batched, j2_x=np.asarray(tj.x[-1]),
                j2_J=float(tj.J))


def _run(deck):
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    return tp, JitTrajectory(tp.assembler, tp.time_grid, tp.dbcs)


def _assert_trajectory(got, want, label):
    xs, xis, paths, norms, fails = (t.numpy() for t in got)
    wxs, wxis, wpaths, wnorms, wfails = want
    assert not wfails.any() and not fails.any(), label
    np.testing.assert_array_equal(paths, wpaths, err_msg=label)
    for a, b in ((xs, wxs), (xis, wxis), (norms, wnorms)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, err_msg=label)


def test_trajectory_and_deck_opt_in_match_calibr8_tpu(ref):
    """JitTrajectory on notch2D h=0.25 small_hill_plane_stress, 3
    steps: xs, xis and norms within 1e-10 of calibr8_tpu's jax.jit(run),
    paths and fails equal.  `solver: jitted` builds JitStepSolver: on the
    small_J2 deck x within 1e-9 and J within rel 1e-10 of calibr8_tpu's
    JitStepSolver.  A multigrid deck raises ValueError."""
    tp, run = _run(HILL_DECK)
    _assert_trajectory(run(tp.params0), ref["single"], "trajectory")
    tp = Problem(load_deck(copy.deepcopy(J2_DECK)), device="cpu")
    assert isinstance(tp.step_solver, JitStepSolver)
    traj = tp.solve_primal()
    np.testing.assert_allclose(traj.x[-1].numpy(), ref["j2_x"], rtol=0, atol=1e-9)
    assert abs(traj.J - ref["j2_J"]) <= 1e-10 * abs(ref["j2_J"])
    info = traj.newton_info[-1]
    assert info["host_reads"] == info["iterations"] + 1 and info["replays"] == 0
    with pytest.raises(ValueError, match="jitted"):
        Problem(load_deck(copy.deepcopy(MG_DECK)), device="cpu")


def test_run_batch_matches_vmap(ref):
    """run_batch of three experiments (params x1, x1.05, x0.95) on
    tests/test_jit_newton.py's small_J2 trajectory deck within 1e-10 of
    calibr8_tpu's jax.jit(jax.vmap(run)); the responses differ."""
    tp, run = _run(J2_TRAJ_DECK)
    got = run.run_batch(tp.params0.new_tensor(ref["batch"]))
    assert got[0].shape[0] == 3
    for i in range(3):
        _assert_trajectory([t[i] for t in got], [w[i] for w in ref["batched"]], f"experiment {i}")
    assert float((got[0][1, -1] - got[0][0, -1]).abs().max()) > 1e-9
