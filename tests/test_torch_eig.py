"""The eigensolver pieces of the port against calibr8_tpu, float64 on the
CPU (plain JAX under jit; no interpret mode):

 - t_eig_sym33, t_hosford_phi_n and t_barlat_phi_n on seeded symmetric
   batches (generic, two equal, three equal and a zero eigenvalue), values
   and jvp tangents;
 - implicit_newton with the frozen branch and the line search against
   calibr8_tpu's _implicit_newton on a batch of small_hosford lanes (xi,
   path, failed, and each lane's iteration count);
 - the twins ported before keep their local Newton: no frozen branch (so
   no line search), and calibr8_tpu's results on small_hill and
   hypo_hill.

At two equal eigenvalues calibr8_tpu's eigenvectors are those of its
selects on a rounding-level matrix.  Where the equal pair is the lower
one (uniaxial tension) the reconstruction sum lam_i v_i v_i^T still
holds and is compared; where it is the upper one (r -> -1) neither
package's vectors span the eigenspaces (the reconstruction misses A by a
share of max|A| in both), so only the eigenvalues, phi and their tangents
are compared there.  On the equal-pair lanes the tangents of the vectors
pass through 1 / (lam_1 - lam_2) ~ 1e7 / p (the clip at 1 - 1e-14 splits
the pair by ~1e-7 p), so there the reconstruction's and the normal's
tangents are held to 1e-7 of their max (measured 3.7e-9), elsewhere to
1e-12.  Barlat's tangents at three equal eigenvalues (a hydrostatic TC,
whose transforms vanish) overflow in calibr8_tpu (NaN in 2 of 24 lanes,
none in the port): that batch is held on values only."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import calibr8_tpu.models.batched as JB
import calibr8_tpu_torch.models.batched as TB
from calibr8_tpu.models import create_local_model as jax_create_model
from calibr8_tpu.models.base import Kinematics
from calibr8_tpu_torch.models import create_local_model

SP = (1.0, 1.05, 0.95, 1.1, 0.9, 1.02, 1.04, 0.97, 1.06)
DP = (0.98, 1.03, 1.07, 0.92, 1.01, 0.96, 1.08, 1.02, 0.94)
A_EXP = 8.0


def sym_batches(n=24, scale=10.0, seed=0):
    """{kind: (3, 3, n)} symmetric batches; in `two_equal` the equal pair
    alternates between the lower and the upper one."""
    rng = np.random.default_rng(seed)

    def rot():
        return np.linalg.qr(rng.standard_normal((3, 3)))[0]

    g = rng.standard_normal((n, 3, 3)) * scale
    two, zero = [], []
    for k in range(n):
        lo, hi = np.sort(rng.standard_normal(2) * scale)
        lam = [hi, lo, lo] if k % 2 == 0 else [hi, hi, lo]
        Q = rot()
        two.append(Q @ np.diag(lam) @ Q.T)
        lz = rng.standard_normal(3) * scale
        lz[k % 3] = 0.0
        Q = rot()
        zero.append(Q @ np.diag(lz) @ Q.T)
    out = {"generic": 0.5 * (g + g.transpose(0, 2, 1)), "two_equal": np.array(two),
           "three_equal": np.array([np.eye(3) * rng.standard_normal() * scale for _ in range(n)]),
           "zero_eig": np.array(zero)}
    return {k: np.moveaxis(v, 0, -1) for k, v in out.items()}


def _jax_fns():
    def eig(A):
        lam, V = JB.t_eig_sym33(A)
        return jnp.stack(lam), sum(lam[i] * JB.t_outer(V[i]) for i in range(3))

    def hos(A):
        return JB.t_hosford_phi_n(A, JB.t_dev3(A), jnp.full(A.shape[-1], A_EXP))

    def bar(A):
        E = A.shape[-1]
        return JB.t_barlat_phi_n(A, tuple(jnp.full(E, c) for c in SP),
                                 tuple(jnp.full(E, c) for c in DP), jnp.full(E, A_EXP))

    return {k: jax.jit(lambda A, dA, f=f: jax.jvp(f, (A,), (dA,)))
            for k, f in (("eig", eig), ("hosford", hos), ("barlat", bar))}


def _torch_fns():
    def eig(A):
        lam, V = TB.t_eig_sym33(A)
        return torch.stack(lam), sum(lam[i] * TB.t_outer(V[i]) for i in range(3))

    def hos(A):
        return TB.t_hosford_phi_n(A, TB.t_dev3(A), torch.full((A.shape[-1],), A_EXP,
                                                             dtype=A.dtype))

    def bar(A):
        E = A.shape[-1]
        full = [torch.full((E,), c, dtype=A.dtype) for c in SP + DP]
        return TB.t_barlat_phi_n(A, tuple(full[:9]), tuple(full[9:]),
                                 torch.full((E,), A_EXP, dtype=A.dtype))

    return {k: (lambda A, dA, f=f: torch.func.jvp(f, (A,), (dA,)))
            for k, f in (("eig", eig), ("hosford", hos), ("barlat", bar))}


def _err(a, b, lanes):
    a, b = np.asarray(a)[..., lanes], np.asarray(b)[..., lanes]
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300) if a.size else 0.0


# (values, reconstruction / normal, their tangents) relative to max|ref|
# on the lanes of each kind; None: not compared (see above)
LIMITS = {"distinct": (1e-13, 1e-13, 1e-12, 1e-12), "lower": (1e-13, 1e-13, 1e-12, 1e-7),
          "upper": (1e-9, None, 1e-7, None)}


def test_eig_and_yield_surfaces_match_jax():
    jf, tf = _jax_fns(), _torch_fns()
    rng = np.random.default_rng(1)
    seen = set()
    for kind, A in sym_batches().items():
        dA = rng.standard_normal(A.shape)
        dA = 0.5 * (dA + dA.transpose(1, 0, 2))
        lam = np.sort(np.linalg.eigvalsh(np.moveaxis(A, -1, 0)), axis=-1)[:, ::-1].T
        gap = np.abs(np.diff(lam, axis=0)) <= 1e-9 * np.abs(lam).max()
        # the equal pair of each lane, if any (three equal counts as upper)
        lanes = {"upper": gap[0], "lower": gap[1] & ~gap[0], "distinct": ~(gap[0] | gap[1])}
        for name in ("eig", "hosford", "barlat"):
            pj, tj = jf[name](jnp.asarray(A), jnp.asarray(dA))
            pt, tt = tf[name](torch.tensor(A), torch.tensor(dA))
            got = [v.numpy() for v in (*pt, *tt)]
            ref = [np.asarray(v) for v in (*pj, *tj)]
            if kind == "three_equal" and name != "eig":
                # a hydrostatic state: no deviator, phi is rounding in both
                # (and Barlat's tangents overflow in calibr8_tpu)
                assert max(np.abs(got[0]).max(), np.abs(ref[0]).max()) <= 1e-13 * np.abs(A).max()
                continue
            for lane_kind, m in lanes.items():
                if not m.any():
                    continue
                seen.add(lane_kind)
                # Barlat reads the spectra of the transformed stresses
                lim = LIMITS["distinct" if name == "barlat" else lane_kind]
                for k, tol in enumerate(lim):
                    if tol is not None:
                        assert _err(got[k], ref[k], m) <= tol, (kind, name, lane_kind, k)
    assert seen == set(LIMITS)


def _hosford_lanes(E=48, seed=3):
    """(xipT, grad_u, parT) of small_hosford lanes: random strains around
    first yield, some elastic, some plastic."""
    rng = np.random.default_rng(seed)
    gu = 0.02 * rng.standard_normal((3, 3, E))
    xip = 1e-4 * rng.standard_normal((7, E))
    xip[6] = np.abs(xip[6])
    par = np.array([1000.0, 0.25, 10.0, A_EXP, 50.0, 5.0, 2.0])[:, None] * np.ones(E)
    return xip, gu, par


def test_implicit_newton_frozen_path_line_search_matches_jax():
    xip, gu, par = _hosford_lanes()
    E = xip.shape[-1]
    jm = jax_create_model("small_hosford", 3)
    tm = create_local_model("small_hosford", 3)
    jbm = JB.BatchedSmallHosford(jm)
    zero = jnp.zeros((3, 3, E))

    @jax.jit
    def solve_k(k):
        # calibr8_tpu's loop stopped after k iterations (k traced: one compile)
        jbm.newton_iters = k
        try:
            return jbm.local_solve(jnp.asarray(xip), Kinematics(jnp.asarray(gu), zero),
                                   jnp.asarray(par))
        finally:
            jbm.newton_iters = 30

    xi_j, path_j, fail_j = [np.asarray(v) for v in solve_k(30)]
    tbm = TB.BatchedSmallHosford(tm)
    iters = torch.zeros(E, dtype=torch.int32)
    xi_t, path_t, fail_t = TB.implicit_newton(tbm, torch.tensor(xip), torch.tensor(gu),
                                               torch.tensor(par), iters=iters)
    np.testing.assert_array_equal(path_t.numpy(), path_j)
    np.testing.assert_array_equal(fail_t.numpy(), fail_j)
    assert 0 < int(path_t.sum()) < E and int(fail_t.sum()) == 0
    assert _err(xi_t.numpy(), xi_j, slice(None)) <= 1e-12
    # the frozen path is the first guess's
    assert torch.equal(path_t, tbm.pathfn(torch.tensor(xip), None, torch.tensor(gu),
                                          torch.tensor(par)))
    # a lane's count: the least k whose stopped loop gives its final xi
    jax_iters = np.full(E, -1)
    for k in range(tbm.newton_iters + 1):
        same = np.all(np.asarray(solve_k(k)[0]) == xi_j, axis=0) & (jax_iters < 0)
        jax_iters[same] = k
        if (jax_iters >= 0).all():
            break
    np.testing.assert_array_equal(iters.numpy(), jax_iters)
    assert iters.max() > 2


def test_ported_twins_keep_their_local_newton():
    """No twin ported before the eigensolver family freezes its branch or
    takes the line search, and small_hill / hypo_hill still give
    calibr8_tpu's _implicit_newton results."""
    for name, cls in TB.BATCHED_MODELS.items():
        frozen = name in ("small_hosford", "hypo_hosford", "hypo_barlat")
        assert getattr(cls, "freeze_path", False) == frozen, name
    rng = np.random.default_rng(5)
    E = 32
    gu = 0.01 * rng.standard_normal((3, 3, E))
    gup = gu - 0.01 * rng.standard_normal((3, 3, E))
    for name, par0 in (("small_hill", [1000.0, 0.25, 10.0, 1.0, 1.1, 0.95, 1.05, 1.0, 1.0, 5.0, 2.0]),
                       ("hypo_hill", [1000.0, 0.25, 10.0] + [1.0] * 6 + [5.0, 2.0])):
        par = np.array(par0)[:, None] * np.ones(E)
        xip = 1e-4 * rng.standard_normal((7, E))
        xip[6] = np.abs(xip[6])
        jbm = JB.get_batched_model(jax_create_model(name, 3))
        kin = Kinematics(grad_u=jnp.asarray(gu), grad_u_prev=jnp.asarray(gup))
        xi_j, path_j, _ = jax.jit(jbm.local_solve)(jnp.asarray(xip), kin, jnp.asarray(par))
        tbm = TB.get_batched_model(create_local_model(name, 3))
        xi_t, path_t, _ = TB.implicit_newton(tbm, torch.tensor(xip), torch.tensor(gu),
                                             torch.tensor(par), torch.tensor(gup))
        np.testing.assert_array_equal(path_t.numpy(), np.asarray(path_j))
        assert 0 < int(path_t.sum()) < E
        assert _err(xi_t.numpy(), np.asarray(xi_j), slice(None)) <= 1e-12, name
