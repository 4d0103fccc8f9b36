"""The composite two-level multigrid (1-2 refinements; calibr8_tpu_torch/
solve/mg.py) against calibr8_tpu's on notch2D h=0.25 refined once,
small_J2, mixed u/p, float64: the cycle M(r), forward and transposed, on
the same element Jacobians, the GMRES iteration count it gives, and the
multigrid primal against the dense direct one.  calibr8_tpu's cycle is
traced once per direction (~10 s); the file holds two tests so that the
test run's loadfile queue runs it beside the slow files.  Its helpers
(one multigrid deck wired in both packages, a seeded partly yielded state
assembled by the port, each package's cycle on the same element
Jacobians) serve tests/test_torch_mg_recursive.py too."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem.assembly import ebe_matvec_disc
from calibr8_tpu.fem.bcs import apply_dbcs_matvec as jax_apply_dbcs_matvec
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve.krylov import gmres_counted
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.ellpack import EllOperator
from calibr8_tpu_torch.solve.gmres import gmres_cycle
from tests.decks import BCS_2D, J2_MAT, make_deck

# -- shared with tests/test_torch_mg_recursive.py ---------------------------


def mg_deck(h, refinements, num_steps=1, pull=0.001, **la):
    deck = make_deck({"type": "notch2D", "h": h, "refinements": refinements}, "small_J2", J2_MAT,
                     BCS_2D(pull), num_steps)
    deck["linear algebra"] = {"preconditioner": "multigrid", "method": "gmres", **la}
    return deck


def mg_system(deck):
    """Both packages' Problems on `deck` and the port's element Jacobians
    at a seeded partly yielded state (u_y ~ y^2 with noise, random nodal
    pressure)."""
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    d = tp.disc
    rng = np.random.default_rng(5)
    c = d.mesh.coords
    u = np.stack([-0.0006 * c[:, 0], 0.002 * c[:, 1] ** 2], 1) + 4e-5 * rng.standard_normal(c.shape)
    x = torch.tensor(np.concatenate([u.reshape(-1), 0.3 * rng.standard_normal(d.n_nodes)]))
    xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=torch.float64)
    _, J_T, diag, _, _, _ = tp.assembler.assemble(x, xi_prev, tp.params0)
    bc = tp.dbcs.arrays(1.0, 1)[0]
    return dict(tp=tp, jp=jp, J_T=J_T, diag=diag, bc=bc, r=rng.standard_normal(d.n_dofs))


def preconditioners(s, transpose):
    """(calibr8_tpu's make(...) with its EBE operator, as its tests/test_mg.py
    builds it, its operator; the port's make(...) with its ELL operator, that
    operator) on the transposed element blocks when transpose."""
    tp, jp, J_T, diag, bc = s["tp"], s["jp"], s["J_T"], s["diag"], s["bc"]
    J_e = jnp.asarray(J_T.permute(2, 0, 1).numpy())
    op_e = J_e.swapaxes(-1, -2) if transpose else J_e
    jdiag, jbc = jnp.asarray(diag.numpy()), jnp.asarray(bc.numpy(), jnp.int32)

    def jop(v):
        return jax_apply_dbcs_matvec(ebe_matvec_disc(op_e, jp.disc, v), jdiag, v, jbc)

    M_j = jp.mg_factory.make(op_e, jdiag, jbc, jop, transpose=transpose)
    op = EllOperator(tp.disc, J_T, diag, bc, transpose=transpose)
    M_t = tp.mg_factory.make(J_T.transpose(0, 1) if transpose else J_T, diag, bc, op,
                             transpose=transpose)
    return M_j, jop, M_t, op


def assert_blocks_close(z_t, z_j, n_u, tol):
    """z_t against z_j, the u and the p block each to tol of its own max."""
    for blk in (slice(0, n_u), slice(n_u, None)):
        a, b = z_t[blk], z_j[blk]
        if b.size:
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), (blk, np.abs(a - b).max())


def port_gmres_count(op, M, b, tol=1e-10, maxiter=600, restart=100):
    """Right-preconditioned GMRES(restart) iterations until the recurrence
    residual reaches tol ||b||, restarted from the true residual:
    calibr8_tpu's solve/krylov.py gmres_counted, which tests/test_mg.py's
    _iters uses, on the port's gmres_cycle."""
    target = tol * float(torch.linalg.vector_norm(b))
    x, total = torch.zeros_like(b), 0
    while total < maxiter:
        r = b - op(x)
        if float(torch.linalg.vector_norm(r)) <= target:
            break
        dy, _, k = gmres_cycle(lambda v: op(M(v)), r, min(restart, maxiter - total), target)
        x = x + M(dy)
        total += k
        if k == 0:
            break
    return total, float(torch.linalg.vector_norm(b - op(x))) / float(torch.linalg.vector_norm(b))


# -- the composite cycle ----------------------------------------------------


@pytest.fixture(scope="module")
def system():
    return mg_system(mg_deck(0.25, 1))


def test_composite_cycle_and_gmres_count_match_jax(system):
    """M(r) to 1e-12 of each block's max|z|, forward and transposed; and
    GMRES(100) to 1e-10 on the forward system takes as many iterations
    with either cycle, counted as tests/test_mg.py's _iters counts them."""
    tp = system["tp"]
    assert tp.mg_factory is not None and not tp.mg_factory.recursive
    r = system["r"]
    n_u = tp.disc.n_dofs_u
    for transpose in (False, True):
        M_j, jop, M_t, op = preconditioners(system, transpose)
        assert_blocks_close(M_t(torch.tensor(r)).numpy(), np.asarray(M_j(jnp.asarray(r))), n_u,
                            1e-12)
    M_j, jop, M_t, op = preconditioners(system, False)
    b = np.random.default_rng(1).standard_normal(tp.disc.n_dofs)
    _, info = gmres_counted(jop, jnp.asarray(b), M=M_j, tol=1e-10, maxiter=600, restart=100)
    its, relres = port_gmres_count(op, M_t, torch.tensor(b))
    assert info.converged and relres <= 1e-10
    assert its == info.iterations, (its, info.iterations)


def test_mg_primal_matches_dense():
    """A multigrid-preconditioned Newton solve (GMRES to 1e-12) equals the
    dense direct one: x to 1e-9, the QoI to rel 1e-9 (tests/test_mg.py:
    110-134, on the port alone)."""
    deck = mg_deck(0.25, 1, num_steps=2, pull=0.002, tolerance=1e-12)
    prob = Problem(load_deck(deck), device="cpu")
    assert prob.mg_factory is not None
    traj = prob.solve_primal()
    deck["linear algebra"] = {"method": "dense"}
    traj_d = Problem(load_deck(deck), device="cpu").solve_primal()
    np.testing.assert_allclose(traj.x[-1].numpy(), traj_d.x[-1].numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(traj.qoi_values, traj_d.qoi_values, rtol=1e-9)
    assert all(k > 0 for info in traj.newton_info for k in info["krylov_iters"])
