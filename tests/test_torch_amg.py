"""The aggregation AMG (calibr8_tpu_torch/solve/amg.py) against
calibr8_tpu's (solve/amg.py), float64, on the CPU (kernel 3c's plain
version):

 - the hierarchy (aggregates, coarse graphs, Galerkin maps, transfer
   blocks) the same bit for bit; every level's assembled operator, u and
   p chain, within 1e-12 of its max; the cycle M(r), forward and
   transposed, on the same element Jacobians within 1e-10 of each u / p
   block's max: notch2D h=0.25 refined once (2D mixed, m = 3) and cube
   n=3 (3D mixed, m = 6), both at coarse_cutoff 20, so that the hierarchy
   has 3 levels or more below the fine one;
 - GMRES with the AMG cycle on a displacement-only plane-stress deck takes
   as many iterations as with calibr8_tpu's, +-1; and the port alone keeps
   tests/test_amg.py's h-robustness (notch2D h=0.25, refinements 2 -> 3:
   the count at most doubles and stays under block Gauss-Seidel's).

 - the port's one deviation, queue 3 of ROADMAP.md: calibr8_tpu's 10
   power iterations underestimate lmax(D^-1 A) more the larger the mesh
   (the Chebyshev smoothers then amplify the top of the spectrum, and at
   full width GMRES stalls in both packages); the port takes
   amg.LMAX_ITERS.  Every comparison here runs calibr8_tpu's smoothers
   on that many (its _power_lmax's own `iters` argument), and test 2
   shows the count at cube n=10: 10 iterations more than triple GMRES's.

calibr8_tpu's cycle is traced and compiled once per direction and deck
(jax.jit), which is most of the file's time; the states come from numpy
seeds."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem.assembly import ebe_matvec_disc
from calibr8_tpu.fem.bcs import apply_dbcs_matvec as jax_apply_dbcs_matvec
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve import amg as jax_amg
from calibr8_tpu.solve.amg import AMGPrecondFactory as JaxAMG
from calibr8_tpu.solve.krylov import gmres_counted
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve import amg
from calibr8_tpu_torch.solve.amg import AMGPrecondFactory
from calibr8_tpu_torch.solve.ellpack import EllOperator
from calibr8_tpu_torch.solve.precond import BlockJacobiGS
from calibr8_tpu_torch.profile_primal import bench_deck
from tests.decks import BCS_2D, BCS_3D, J2_MAT, make_deck
from tests.test_torch_mg_composite import assert_blocks_close, port_gmres_count

CUTOFF = 20


@pytest.fixture(autouse=True)
def jax_lmax_iters(monkeypatch):
    """calibr8_tpu's smoothers on the port's number of power iterations."""
    monkeypatch.setattr(jax_amg, "_power_lmax",
                        functools.partial(jax_amg._power_lmax, iters=amg.LMAX_ITERS))


def amg_deck(mesh, model="small_J2", mat=J2_MAT, bcs=None, **kw):
    bcs = bcs or (BCS_3D(0.001) if mesh["type"] == "cube" else BCS_2D(0.001))
    deck = make_deck(mesh, model, mat, bcs, 1, **kw)
    deck["linear algebra"] = {"preconditioner": "amg", "method": "gmres"}
    return deck


def amg_system(deck, coarse_cutoff=None):
    """Both packages' Problems on `deck` (their factories rebuilt at
    `coarse_cutoff` when given) and the port's element Jacobians at a
    seeded partly yielded state."""
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    if coarse_cutoff is not None:
        tp.mg_factory = AMGPrecondFactory(tp.disc, coarse_cutoff=coarse_cutoff)
        jp.mg_factory = JaxAMG(jp.disc, coarse_cutoff=coarse_cutoff)
    d = tp.disc
    dim = d.spec.dim
    rng = np.random.default_rng(5)
    c = d.mesh.coords
    u = 0.002 * c ** 2 * np.where(np.arange(dim) == 1, 1.0, -0.3) + 4e-5 * rng.standard_normal(
        c.shape)
    parts = [u.reshape(-1)] + ([0.3 * rng.standard_normal(d.n_nodes)] if d.spec.mixed else [])
    x = torch.tensor(np.concatenate(parts))
    xi_prev = torch.zeros(d.n_elem, tp.model.nxi(), dtype=torch.float64)
    _, J_T, diag, _, _, _ = tp.assembler.assemble(x, xi_prev, tp.params0)
    bc = tp.dbcs.arrays(1.0, 1)[0]
    return dict(tp=tp, jp=jp, J_T=J_T, diag=diag, bc=bc, r=rng.standard_normal(d.n_dofs))


def jax_cycle(s, transpose):
    """calibr8_tpu's make(...) on the (transposed) element blocks with its
    EBE operator, built and applied under one jax.jit (traced once: eager,
    its unrolled Galerkin sums cost twice as long), and that operator.
    The jitted function returns (z, the u chain's level operators (every
    call of _t_diag_inv), the p chain's level-1 blocks or None)."""
    jp, J_T, diag, bc = s["jp"], s["J_T"], s["diag"], s["bc"]
    J_e = jnp.asarray(J_T.permute(2, 0, 1).numpy())
    op_e = J_e.swapaxes(-1, -2) if transpose else J_e
    jdiag, jbc = jnp.asarray(diag.numpy()), jnp.asarray(bc.numpy(), jnp.int32)

    def jop(v):
        return jax_apply_dbcs_matvec(ebe_matvec_disc(op_e, jp.disc, v), jdiag, v, jbc)

    f = jp.mg_factory
    diag_inv, p_chain = f._t_diag_inv, f._p_chain_from_A1

    def apply(r):
        record = {"u": [], "p1": None}

        def recorded_diag_inv(A_T, lv, dtype):
            record["u"].append(A_T)
            return diag_inv(A_T, lv, dtype)

        def recorded_p_chain(A_p1, dtype):
            record["p1"] = A_p1
            return p_chain(A_p1, dtype)

        f._t_diag_inv, f._p_chain_from_A1 = recorded_diag_inv, recorded_p_chain
        try:
            z = f.make(op_e, jdiag, jbc, jop, transpose=transpose)(r)
        finally:
            del f._t_diag_inv, f._p_chain_from_A1
        return z, record["u"], record["p1"]

    return jax.jit(apply), jop


def port_cycle(s, transpose, record=None):
    """The port's make(...) with its ELL operator; `record` collects every
    level's operator of both chains while it is built."""
    tp, J_T, diag, bc = s["tp"], s["J_T"], s["diag"], s["bc"]
    op = EllOperator(tp.disc, J_T, diag, bc, transpose=transpose)
    f = tp.mg_factory
    if record is not None:
        chain = f._chain

        def recorded(A1_T, m):
            record.setdefault(m, []).append(A1_T)
            for li in range(1, len(f.levels)):
                record[m].append(f._coarse_galerkin(record[m][-1], li, m))
            return chain(A1_T, m)

        f._chain = recorded
    try:
        M = f.make(J_T.transpose(0, 1) if transpose else J_T, diag, bc, op, transpose=transpose)
    finally:
        if record is not None:
            del f._chain
    return M, op


def assert_same_hierarchy(f_t, f_j):
    """Aggregates, coarse graphs, diagonal slots, Galerkin maps and
    transfer blocks equal bit for bit; calibr8_tpu's row-major ELL
    positions row * K + slot are the port's slot * n + row."""
    assert f_t.level_sizes == f_j.level_sizes
    for li, (lt, lj) in enumerate(zip(f_t.levels, f_j.levels)):
        n, K = lt.n, lt.K
        assert (n, K, lt.n_prev) == (lj.n, lj.K, lj.n_prev)
        np.testing.assert_array_equal(lt.agg_prev, np.asarray(lj.agg_prev))
        np.testing.assert_array_equal(lt.nbr, np.asarray(lj.nbr))
        assert np.array_equal(lt.P, lj.P) and lt.P.dtype == lj.P.dtype
        np.testing.assert_array_equal(lt.diag_slot, np.asarray(lj.diag_slot) % K)
        em = np.asarray(lj.emap).astype(np.int64)
        pad = em == n * K
        want = np.where(pad, n * K, (em % K) * n + em // K)
        if li > 0:  # the previous level's entries, row-major there, slot-major here
            Kp = f_t.levels[li - 1].K
            want = want.reshape(lt.n_prev, Kp).T.reshape(-1)
        np.testing.assert_array_equal(lt.emap, want)


def level_ops_jax(f_j, u_ops, p1, m_u):
    """calibr8_tpu's level operators in the port's layout (K, m, m, n): the u
    chain's as recorded, the p chain's from its level-1 blocks summed down
    the Galerkin maps with numpy (the p chain's T is 1)."""
    u, p = [], []
    for lv, A in zip(f_j.levels, u_ops):
        u.append(np.asarray(A).reshape(m_u, m_u, lv.n, lv.K).transpose(3, 0, 1, 2))
    if p1 is not None:
        A = np.asarray(p1).reshape(-1)
        for li, lv in enumerate(f_j.levels):
            if li > 0:
                A = np.bincount(np.asarray(lv.emap), weights=A,
                                minlength=lv.n * lv.K + 1)[:-1]
            p.append(A.reshape(lv.n, lv.K).T[:, None, None, :])
    return u, p


CASES = {
    "notch2D h=0.25 refined once, m=3": {"type": "notch2D", "h": 0.25, "refinements": 1},
    "cube n=3, m=6": {"type": "cube", "n": 3},
}


def test_hierarchy_level_operators_and_cycle_match_jax():
    for case, mesh in CASES.items():
        check_case(case, mesh)


def check_case(case, mesh):
    s = amg_system(amg_deck(mesh), coarse_cutoff=CUTOFF)
    tp, jp = s["tp"], s["jp"]
    f_t, f_j = tp.mg_factory, jp.mg_factory
    assert len(f_t.level_sizes) >= 3, f_t.level_sizes
    assert_same_hierarchy(f_t, f_j)
    n_u = tp.disc.n_dofs_u
    r = s["r"]
    worst = {}
    for transpose in (False, True):
        rec_t = {}
        apply_j, _ = jax_cycle(s, transpose)
        M_t, _ = port_cycle(s, transpose, rec_t)
        z_j, u_ops, p1 = apply_j(jnp.asarray(r))
        z_j = np.asarray(z_j)
        u_j, p_j = level_ops_jax(f_j, u_ops, p1, f_t.m)
        for A_j, A_t in zip(u_j + p_j, rec_t[f_t.m] + rec_t[1]):
            err = np.abs(A_t.numpy() - A_j).max() / np.abs(A_j).max()
            assert err <= 1e-12, (case, transpose, err)
        assert len(u_j) == len(p_j) == len(f_t.levels)
        z_t = M_t(torch.tensor(r)).numpy()
        assert_blocks_close(z_t, z_j, n_u, 1e-10)
        worst[transpose] = max(np.abs(z_t[b] - z_j[b]).max() / np.abs(z_j[b]).max()
                               for b in (slice(0, n_u), slice(n_u, None)))
    print(f"{case}: levels {f_t.level_sizes}, M(r) largest error of a block's max "
          f"{worst[False]:.2e} forward, {worst[True]:.2e} transposed")


def iters_port(prob, tol=1e-8, bgs=False):
    """GMRES(100) iterations to tol on the port's system at the first load
    step's converged state (tests/test_amg.py's probe), AMG or block
    Gauss-Seidel."""
    traj = prob.solve_primal()
    d = prob.disc
    xi_prev = torch.tensor(np.tile(prob.model.init_xi(), (d.n_elem, 1)))
    _, J_T, diag, _, _, _ = prob.assembler.assemble(traj.x[1], xi_prev, prob.params0,
                                                     x_prev=traj.x[0])
    bc = prob.dbcs.arrays(prob.time_grid.time(1), 1)[0]
    op = EllOperator(d, J_T, diag, bc)
    M = BlockJacobiGS(d, J_T, diag, bc) if bgs else prob.mg_factory.make(J_T, diag, bc, op)
    b = torch.tensor(np.random.default_rng(1).standard_normal(d.n_dofs))
    return port_gmres_count(op, M, b, tol=tol)


def test_gmres_counts_h_robustness_and_lmax_iterations(monkeypatch):
    deck = amg_deck({"type": "notch2D", "h": 0.12}, "small_hill_plane_stress",
                    {"E": 1000.0, "nu": 0.25, "Y": 10.0, "S": 5.0, "D": 2.0,
                     "R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0},
                    global_type="mechanics_plane_stress")
    s = amg_system(deck)
    assert not s["tp"].disc.spec.mixed
    apply_j, jop = jax_cycle(s, False)
    M_t, op = port_cycle(s, False)
    b = np.random.default_rng(1).standard_normal(s["tp"].disc.n_dofs)
    M_j = jax.jit(lambda v: apply_j(v)[0])
    _, info = gmres_counted(jop, jnp.asarray(b), M=M_j, tol=1e-10, maxiter=600, restart=100)
    its, relres = port_gmres_count(op, M_t, torch.tensor(b))
    assert info.converged and relres <= 1e-10
    assert abs(its - info.iterations) <= 1, (its, info.iterations)
    print(f"plane stress: GMRES iterations {its} (calibr8_tpu {info.iterations})")

    its, its_bgs = {}, {}
    for L in (2, 3):
        prob = Problem(load_deck(amg_deck({"type": "notch2D", "h": 0.25, "refinements": L})),
                       device="cpu")
        assert isinstance(prob.mg_factory, AMGPrecondFactory)
        its[L], rr = iters_port(prob)
        assert rr <= 1e-8, (L, rr)
        its_bgs[L], _ = iters_port(prob, bgs=True)
    assert its[3] <= 2.0 * its[2] and its[3] < its_bgs[3], (its, its_bgs)
    print(f"GMRES iterations with AMG, refinements 2, 3: {its}; block Gauss-Seidel: {its_bgs}")

    # calibr8_tpu's 10 power iterations against the port's, on the bench
    # deck's first Jacobian (elastic) at cube n=10: the smoothers' lmax
    # falls short of lmax(D^-1 A), and GMRES needs more than 3x as many
    # iterations (88 against 26 here; at cube n=32, on the card, it stalls)
    deck = bench_deck(10)
    deck["linear algebra"] = {"method": "gmres", "preconditioner": "amg"}
    prob = Problem(load_deck(deck), device="cpu")
    d = prob.disc
    xi = torch.tensor(np.tile(prob.model.init_xi(), (d.n_elem, 1)))
    _, J_T, diag, _, _, _ = prob.assembler.assemble(torch.zeros(d.n_dofs, dtype=torch.float64),
                                                     xi, prob.params0)
    bc = prob.dbcs.arrays(1.0, 1)[0]
    op = EllOperator(d, J_T, diag, bc)
    b = torch.tensor(np.random.default_rng(1).standard_normal(d.n_dofs))
    counts, port_iters = {}, amg.LMAX_ITERS
    for iters in (port_iters, 10):
        monkeypatch.setattr(amg, "LMAX_ITERS", iters)
        counts[iters], rr = port_gmres_count(op, prob.mg_factory.make(J_T, diag, bc, op), b,
                                             tol=1e-8)
        assert rr <= 1e-8
    assert counts[10] > 3 * counts[port_iters], counts
    print(f"cube n=10, GMRES iterations by lmax power iterations: {counts}")
