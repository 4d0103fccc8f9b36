"""The pieces of the jitted step solver's linear solve against
calibr8_tpu: the sync-free GMRES cycle (solve/gmres.py GmresCycle) and
restart loop (solve/linear.py SyncFreeSolve), run eagerly on the CPU in
chunks of 7 (gmres.CHUNK patched: 7 does not divide the restarts); and
two guards of the captured route that need no card: the launch
bookkeeping of a replayed CUDA graph (kernels.recording /
kernels.replayed) and the step's check of the assembler's state on the
card (const_state).  float64 on both sides."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve import gmres as jax_gmres
from calibr8_tpu.solve import linear as jax_linear
from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.bcs import apply_dbcs_residual
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve import gmres, linear
from calibr8_tpu_torch.solve.jit_newton import _StepProgram
from tests.decks import BCS_2D, make_deck

N, M, CHUNK = 300, 40, 7  # the chunk does not divide m
HILL_PS = {"E": 1000.0, "nu": 0.25, "Y": 2.0, "S": 10.0, "D": 2.0,
           "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}
HILL_DECK = make_deck({"type": "notch2D", "h": 0.25}, "small_hill_plane_stress", HILL_PS,
                      BCS_2D(0.005), 1, global_type="mechanics_plane_stress")


@pytest.fixture(autouse=True)
def chunk_of_7(monkeypatch):
    monkeypatch.setattr(gmres, "CHUNK", CHUNK)


def _cycle(opM, r0, restart, atol):
    """gmres_cycle's function through GmresCycle, run eagerly: (dy,
    res_est, k_used)."""
    cyc = gmres.GmresCycle(restart, r0.numel(), r0.dtype, r0.device)
    cyc.start(r0, torch.as_tensor(atol, dtype=r0.dtype))
    cyc.run(opM, gmres.EagerRunner())
    return cyc.finish(), cyc.res, cyc.k_used


def _solve(cfg, J_T, disc, diag, b, bc_dofs):
    """J x = b through SyncFreeSolve, run eagerly: (x, relres, Krylov
    iterations), as solve_info(..., return_iters=True) returns them."""
    sol = linear.SyncFreeSolve(cfg, disc)
    sol.b.copy_(b)
    sol.setup(J_T, diag, bc_dofs)
    sol.run(gmres.EagerRunner())
    relres = float(torch.linalg.vector_norm(b - sol.op(sol.x)) / torch.linalg.vector_norm(b))
    return sol.x, relres, int(sol.ki)


def _operator(case):
    """(A, r0, atol) of a seeded case: early exit; full length at atol 0;
    happy breakdown (r0 = e_0 of a diagonal A: w - h e_0 is exactly 0
    after one iteration)."""
    rng = np.random.default_rng(3)
    if case == "breakdown":
        A = np.diag(np.arange(1.0, N + 1.0))
        r0 = np.zeros(N)
        r0[0] = 2.0
        return A, r0, 0.0
    A = 4.0 * np.eye(N) + rng.standard_normal((N, N)) / np.sqrt(N)
    r0 = rng.standard_normal(N)
    return A, r0, (1e-6 * np.linalg.norm(r0) if case == "early_exit" else 0.0)


def _launch_bookkeeping():
    """A graph's capture counts nothing; each replay adds what the capture
    recorded, to `launches` and `model_launches` alike."""
    kernels.reset_launches()
    kernels.launches["ell_spmv"] = 5
    key = ("implicit_assembly", "small_hill_plane_stress")
    with kernels.recording() as rec:
        # what the wrappers do where they launch, inside a capture
        kernels.launches["ell_spmv"] += 8
        kernels.launches["implicit_assembly"] += 1
        kernels.model_launches[key] = kernels.model_launches.get(key, 0) + 1
    assert kernels.launches["ell_spmv"] == 5 and kernels.launches["implicit_assembly"] == 0
    assert key not in kernels.model_launches
    assert rec.launches == {"ell_spmv": 8, "implicit_assembly": 1}
    assert rec.model_launches == {key: 1}
    kernels.replayed(rec)
    kernels.replayed(rec, times=2)
    assert kernels.launches["ell_spmv"] == 5 + 3 * 8
    assert kernels.launches["implicit_assembly"] == 3 and kernels.model_launches[key] == 3
    kernels.reset_launches()


def _const_state_guard(monkeypatch):
    """A step pins the assembler's kernel state on the card before its
    capture (GraphRunner.warm_up) and checks it before every solve: the
    same state passes; another one (a hybrid network launched since)
    raises.  The states are faked: on the CPU no kernel keeps any."""
    tp = Problem(load_deck(copy.deepcopy(HILL_DECK)), device="cpu")
    assert tp.assembler.const_state() is None  # no library but the hybrid's keeps one
    bc, _ = tp.dbcs.arrays(1.0, 1)
    prog = _StepProgram(tp.assembler, 2, 1e-8, 1e-8, 2, linear.LinearCfg(method="dense"),
                        tp.params0, bc.numel())
    net = ["network A"]
    monkeypatch.setattr(tp.assembler, "const_state", lambda: net[0])
    prog.pin_const_state()
    prog.check_const_state()
    net[0] = "network B"
    with pytest.raises(RuntimeError, match="captured"):
        prog.check_const_state()


@pytest.mark.parametrize("case", ["early_exit", "full_length", "breakdown",
                                  "launches_under_replay", "const_state_guard"])
def test_sync_free_pieces(case, monkeypatch):
    """GmresCycle, in chunks of 7 with a read of `active` after each,
    against calibr8_tpu's gmres_cycle (m = 40, n = 300): k_used equal, dy
    within 1e-12 of max|dy| (the accumulated rotations round apart from
    the sequential sweep by O(k eps)); the replay bookkeeping; the
    const_state guard."""
    if case == "launches_under_replay":
        _launch_bookkeeping()
        return
    if case == "const_state_guard":
        _const_state_guard(monkeypatch)
        return
    A, r0, atol = _operator(case)
    Aj, At = jnp.asarray(A), torch.tensor(A)
    dy_j, res_j, k_j = jax.jit(
        lambda r: jax_gmres.gmres_cycle(lambda v: Aj @ v, r, M, atol))(jnp.asarray(r0))
    dy_t, res_t, k_t = _cycle(lambda v: At @ v, torch.tensor(r0), M, atol)
    assert int(k_t) == int(k_j)
    assert int(k_t) == {"full_length": M, "breakdown": 1}.get(case, int(k_t))
    if case == "early_exit":
        assert int(k_t) < M and float(res_t) <= atol
    dy_j = np.asarray(dy_j)
    assert np.abs(dy_t.numpy() - dy_j).max() <= 1e-12 * np.abs(dy_j).max()


RESTART_CASES = {
    # one cycle at the decks' default tolerance; short cycles to 1e-13,
    # which stagnate (the stagnation rule and the read after each cycle)
    "one_cycle": dict(method="gmres", tol=1e-6, max_iters=200),
    "restarts": dict(method="gmres", tol=1e-13, max_iters=60, restart=9),
}


def test_sync_free_restart_loop_matches_solve_info():
    """SyncFreeSolve (block GS, chunks of 7) against calibr8_tpu's
    solve_info with method gmres on the notch2D h=0.25 plane-stress Hill
    deck's Jacobian at a plastic state: x within 1e-10 of max|x|, the
    relative residual to 1e-6 of itself and the Krylov count equal."""
    jp = JaxProblem(jax_load_deck(copy.deepcopy(HILL_DECK)))
    tp = Problem(load_deck(copy.deepcopy(HILL_DECK)), device="cpu")
    d = tp.disc
    rng = np.random.default_rng(5)
    c = d.mesh.coords
    u = np.stack([-0.004 * c[:, 0], 0.02 * c[:, 1] ** 2], 1) + 4e-4 * rng.standard_normal((d.n_nodes, 2))
    x = torch.tensor(u.reshape(-1))
    xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=torch.float64)
    R, J_T, diag, _, path, _ = tp.assembler.assemble(x, xi_prev, tp.params0)
    assert int(path.sum()) > 0  # plastic elements
    bc, vals = tp.dbcs.arrays(1.0, 1)
    b = -apply_dbcs_residual(R, diag, x, bc, vals)
    args = (jnp.asarray(J_T.permute(2, 0, 1).numpy()), jp.disc, jnp.asarray(diag.numpy()),
            jnp.asarray(b.numpy()), jnp.asarray(bc.numpy(), jnp.int32))
    for name, fields in RESTART_CASES.items():
        x_j, rr_j, k_j = jax.jit(lambda *a, f=fields: jax_linear.solve_info(
            jax_linear.LinearCfg(**f), a[0], jp.disc, *a[2:], return_iters=True))(
            args[0], None, *args[2:])
        x_t, rr_t, k_t = _solve(linear.LinearCfg(**fields), J_T, d, diag, b, bc)
        x_j = np.asarray(x_j)
        assert k_t == int(k_j), name
        assert abs(rr_t - float(rr_j)) <= 1e-6 * float(rr_j), name
        assert np.abs(x_t.numpy() - x_j).max() <= 1e-10 * np.abs(x_j).max(), name
