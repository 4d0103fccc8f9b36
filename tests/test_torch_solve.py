"""The solve layer of the port against calibr8_tpu: the GMRES cycle, the
block Gauss-Seidel preconditioner, solve_info (dense and GMRES) and one
Newton step.  JAX on the CPU, float64 on both sides."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve import gmres as jax_gmres
from calibr8_tpu.solve import linear as jax_linear
from calibr8_tpu.solve.precond import BlockJacobiGS as JaxBGS
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.bcs import apply_dbcs_residual
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve import gmres, linear
from calibr8_tpu_torch.solve.precond import BlockJacobiGS
from calibr8_tpu.models.twin_cases import HILL2D
from tests.decks import BCS_2D, BCS_3D, CUBE, J2_MAT, NOTCH2D, make_deck


@pytest.mark.parametrize("restart,atol_rel", [(40, 1e-6), (15, 0.0)], ids=["early_exit", "full_cycle"])
def test_gmres_cycle_matches_jax(restart, atol_rel):
    """One fixed nonsymmetric system: the same k_used, dy to 1e-10."""
    rng = np.random.default_rng(7)
    n = 60
    A = 4.0 * np.eye(n) + rng.standard_normal((n, n)) / np.sqrt(n)
    r0 = rng.standard_normal(n)
    atol = atol_rel * np.linalg.norm(r0)
    Aj, At = jnp.asarray(A), torch.tensor(A)
    dy_j, _, k_j = jax_gmres.gmres_cycle(lambda v: Aj @ v, jnp.asarray(r0), restart, atol)
    dy_t, res_t, k_t = gmres.gmres_cycle(lambda v: At @ v, torch.tensor(r0), restart, atol)
    assert k_t == int(k_j)
    if atol_rel:
        assert k_t < restart and res_t <= atol
    dy_j = np.asarray(dy_j)
    assert np.abs(dy_t.numpy() - dy_j).max() <= 1e-10 * np.abs(dy_j).max()


def test_pcg_matches_jax():
    rng = np.random.default_rng(8)
    n = 40
    B = rng.standard_normal((n, n))
    A = B @ B.T + n * np.eye(n)
    b = rng.standard_normal(n)
    Aj, At = jnp.asarray(A), torch.tensor(A)
    dinv = 1.0 / np.diag(A)
    x_j, rr_j = jax_gmres.pcg(lambda v: Aj @ v, jnp.asarray(b), lambda v: jnp.asarray(dinv) * v, 1e-10, 200)
    x_t, rr_t = gmres.pcg(lambda v: At @ v, torch.tensor(b), lambda v: torch.tensor(dinv) * v, 1e-10, 200)
    assert rr_t <= 1e-10
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-10 * np.abs(x_j).max())


DECKS = {
    "cube2": make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1),
    "notch2D": make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.02), 1),
    # displacement only (ndpn = 2): the plane-stress Hill twin
    "notch2D_plane_stress": make_deck(NOTCH2D, "small_hill_plane_stress", HILL2D, BCS_2D(0.02), 1,
                                      global_type="mechanics_plane_stress"),
}


def _state(d, seed):
    rng = np.random.default_rng(seed)
    c = d.mesh.coords
    u = np.stack([0.02 * c[:, 1] ** 2 if i == 1 else -0.006 * c[:, i] for i in range(d.spec.dim)], 1)
    parts = [(u + 4e-4 * rng.standard_normal(u.shape)).reshape(-1)]
    if d.spec.mixed:
        parts.append(0.3 * rng.standard_normal(d.n_nodes))
    return np.concatenate(parts)


@pytest.fixture(scope="module", params=list(DECKS))
def system(request):
    deck = DECKS[request.param]
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    d = tp.disc
    x = torch.tensor(_state(d, 5))
    xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=torch.float64)
    R, J_T, diag, _, _, _ = tp.assembler.assemble(x, xi_prev, tp.params0)
    bc, vals = tp.dbcs.arrays(1.0, 1)
    b = -apply_dbcs_residual(R, diag, x, bc, vals)
    return dict(jp=jp, tp=tp, J_T=J_T, diag=diag, bc=bc, b=b)


def _jax_args(system):
    return (jnp.asarray(system["J_T"].permute(2, 0, 1).numpy()), system["jp"].disc,
            jnp.asarray(system["diag"].numpy()), jnp.asarray(system["b"].numpy()),
            jnp.asarray(system["bc"].numpy(), jnp.int32))


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transpose"])
def test_block_gs_matches_jax(system, transpose):
    J_e, jd, diag, _, bc = _jax_args(system)
    r = np.random.default_rng(11).standard_normal(jd.n_dofs)
    z_j = np.asarray(JaxBGS(jd, J_e, diag, bc, transpose=transpose)(jnp.asarray(r)))
    M = BlockJacobiGS(system["tp"].disc, system["J_T"], system["diag"], system["bc"], transpose=transpose)
    z_t = M(torch.tensor(r)).numpy()
    assert np.abs(z_t - z_j).max() <= 1e-12 * np.abs(z_j).max()


SOLVE_CASES = {
    # id: (LinearCfg fields, transpose)
    "dense": (dict(method="dense"), False),
    "gmres_ell_block_gs": (dict(method="gmres", tol=1e-10, max_iters=400), False),
    "gmres_ebe_block_gs": (dict(method="gmres", tol=1e-10, max_iters=400, operator="ebe"), False),
    "gmres_ell_jacobi": (dict(method="gmres", tol=1e-10, max_iters=400, preconditioner="jacobi"), False),
    "gmres_ell_block_gs_transpose": (dict(method="gmres", tol=1e-10, max_iters=400), True),
    "cg_5_iterations": (dict(method="cg", tol=1e-10, max_iters=5), False),
    # the adjoint's refinement budget (refine_iters more restart cycles),
    # with too few iterations to converge
    "gmres_ell_block_gs_transpose_10_refine_2": (
        dict(method="gmres", tol=1e-10, max_iters=10, restart=10, refine_iters=2), True),
}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_info_matches_jax(system, case):
    """The port's solve_info against calibr8_tpu's on the same system.
    calibr8_tpu's CPU path applies the EBE operator, the port the ELL
    matrix unless operator="ebe"; both use the same preconditioner.
    Dense and GMRES: both reach the tolerance with the same Krylov
    iteration count, x to 1e-10 of max|x| (1e-15 seen).  CG (the mixed
    system is indefinite, so 5 iterations, not convergence) and the
    refinement case (a budget too small to converge): the same iterate
    to 1e-10."""
    fields, transpose = SOLVE_CASES[case]
    J_e, jd, diag, b, bc = _jax_args(system)
    x_j, rr_j, k_j = jax_linear.solve_info(jax_linear.LinearCfg(**fields), J_e, jd, diag, b, bc,
                                           transpose=transpose, return_iters=True)
    x_t, rr_t, k_t = linear.solve_info(linear.LinearCfg(**fields), system["J_T"],
                                       system["tp"].disc, system["diag"], system["b"],
                                       system["bc"], transpose=transpose, return_iters=True)
    x_j = np.asarray(x_j)
    if fields["method"] != "cg" and "refine_iters" not in fields:
        assert rr_t <= 1e-10 and float(rr_j) <= 1e-10
    assert k_t == int(k_j)
    assert np.abs(x_t.numpy() - x_j).max() <= 1e-10 * np.abs(x_j).max()


@pytest.mark.parametrize("system", ["notch2D_plane_stress"], indirect=True)
def test_cg_refinement_matches_jax(system):
    """CG and refine_iters correction solves, each 5 iterations, on the
    displacement-only system (the mixed ones are indefinite, and CG's
    iterates there grow until rounding decides them): the same iterate
    and relative residual to 1e-10."""
    fields = dict(method="cg", tol=1e-10, max_iters=5, refine_iters=2)
    x_j, rr_j = jax_linear.solve_info(jax_linear.LinearCfg(**fields), *_jax_args(system))
    x_t, rr_t = linear.solve_info(linear.LinearCfg(**fields), system["J_T"], system["tp"].disc,
                                  system["diag"], system["b"], system["bc"])
    x_j = np.asarray(x_j)
    x_5, rr_5 = linear.solve_info(linear.LinearCfg(method="cg", tol=1e-10, max_iters=5),
                                  system["J_T"], system["tp"].disc, system["diag"], system["b"],
                                  system["bc"])
    assert rr_t < rr_5
    assert abs(rr_t - float(rr_j)) <= 1e-10 * float(rr_j)
    assert np.abs(x_t.numpy() - x_j).max() <= 1e-10 * np.abs(x_j).max()


def test_solve_info_transpose_dense_matches_jax(system):
    J_e, jd, diag, b, bc = _jax_args(system)
    cfg = dict(method="dense")
    x_j, _ = jax_linear.solve_info(jax_linear.LinearCfg(**cfg), J_e, jd, diag, b, bc, transpose=True)
    x_t, rr = linear.solve_info(linear.LinearCfg(**cfg), system["J_T"], system["tp"].disc,
                                system["diag"], system["b"], system["bc"], transpose=True)
    x_j = np.asarray(x_j)
    assert rr <= 1e-10
    assert np.abs(x_t.numpy() - x_j).max() <= 1e-10 * np.abs(x_j).max()


def test_newton_step_matches_jax():
    """One StepSolver.solve_at_step on cube n=2 small_J2 (dense linear
    solves on both sides): the same Newton count; x, xi to 1e-10 of
    their max; path equal."""
    deck = make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    bc_j, vals_j = jp.dbcs.arrays(1.0, 1)
    x0j = jp.disc.zero_x()
    xi0j = jnp.zeros((jp.disc.n_elem, jp.assembler.nxi))
    xj, xij, pj, info_j = jp.step_solver.solve_at_step(
        x0j, x0j, xi0j, jp.params0, bc_j, vals_j, jnp.zeros_like(x0j), step=1
    )
    bc_t, vals_t = tp.dbcs.arrays(1.0, 1)
    x0t = tp.disc.zero_x()
    xi0t = torch.zeros(tp.disc.n_elem, tp.model.nxi(), dtype=torch.float64)
    xt, xit, pt, info_t = tp.step_solver.solve_at_step(
        x0t, x0t, xi0t, tp.params0, bc_t, vals_t, torch.zeros_like(x0t), step=1
    )
    assert info_t["iterations"] == info_j["iterations"]
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert np.asarray(pj).max() == 1
    for a, b in ((xt, xj), (xit, xij)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-10 * np.abs(b).max()
