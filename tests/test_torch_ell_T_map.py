"""The transposed slot map tr (solve/ellpack.py transposed_slots) against
calibr8_tpu: y = A^T x computed as a numpy gather over each output node's
own row through the port's maps,

    y[c, j] = sum_{t, i} A_T[tr[c, t], i, j, nbr[c, t]] * x[nbr[c, t], i],

on the port's forward-assembled A_T, then the Dirichlet rows, held at
float64 to 1e-13 of max against calibr8_tpu's EllOperator(transpose=True)
on the same element Jacobians (its CPU path transposes the element blocks
before assembly), mixed u/p and displacement only.  The gather is the
arithmetic of kernel 3b (csrc/ell_spmv_T.cu), so this holds the map the
kernel reads, independently of the scatter form ell_spmv_T_plain.  And
the map's own property, nbr[nbr[c, t], tr[c, t]] == c on every filled
slot with 0 in the pads, and the ValueError of transposed_slots on a
pattern that is not structurally symmetric."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.fem.disc import Disc as JaxDisc
from calibr8_tpu.mechanics.global_residual import MechanicsSpec as JaxSpec
from calibr8_tpu.mesh import generators as jax_generators
from calibr8_tpu.solve import ellpack as jax_ellpack
from calibr8_tpu_torch.fem.disc import Disc
from calibr8_tpu_torch.mechanics.global_residual import MechanicsSpec
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.solve.ellpack import (
    assemble_ell_T, build_ell_maps, ell_maps_from_conn, transposed_slots,
)

MESHES = {
    "cube n=2": (lambda g: g.cube(2)),
    "notch2D h=0.3": (lambda g: g.notch2d(0.3)),
}


def gather_T(A_T, nbr, tr, x, dim):
    """y = A^T x through the transposed slot map, in numpy: A_T (K, P, P,
    N), nbr / tr (N, K), x and y flat (u block, then the p block)."""
    K, P, _, N = A_T.shape
    X = x[: N * dim].reshape(N, dim)
    if P > dim:
        X = np.concatenate([X, x[N * dim:, None]], axis=1)
    filled = nbr < N
    m = np.where(filled, nbr, 0)
    blocks = A_T[tr, :, :, m] * filled[:, :, None, None]  # (N, K, P, P)
    Y = np.einsum("ctij,cti->cj", blocks, X[m])
    return np.concatenate([Y[:, :dim].reshape(-1), Y[:, dim:].reshape(-1)])


def test_gather_through_tr_matches_jax_transposed_operator():
    rng = np.random.default_rng(7)
    for mesh, mixed in itertools.product(MESHES, (True, False)):
        tmesh = MESHES[mesh](generators)
        td = Disc(tmesh, MechanicsSpec(dim=tmesh.dim, mixed=mixed), "cpu")
        jd = JaxDisc(MESHES[mesh](jax_generators), JaxSpec(dim=tmesh.dim, mixed=mixed))
        np.testing.assert_array_equal(np.asarray(jd.conn), td.mesh.conn)
        nde, n_dofs, d = td.spec.ndofs_elem, td.n_dofs, td.spec.dim
        J_T = rng.standard_normal((nde, nde, td.n_elem))
        v = rng.standard_normal(n_dofs)
        diag = rng.standard_normal(n_dofs)
        bc = np.sort(rng.choice(n_dofs, n_dofs // 5, replace=False))

        maps = build_ell_maps(td)
        A_T = assemble_ell_T(torch.tensor(J_T), td).numpy()
        y = gather_T(A_T, maps["nbr"], maps["tr"], v, d)
        y[bc] = diag[bc] * v[bc]

        op = jax_ellpack.EllOperator(jd, jnp.asarray(J_T.transpose(2, 0, 1)), jnp.asarray(diag),
                                     jnp.asarray(bc, jnp.int32), transpose=True)
        want = np.asarray(op(jnp.asarray(v)))
        err = np.abs(y - want).max() / np.abs(want).max()
        assert err <= 1e-13, (mesh, mixed, err)


def test_transposed_slot_map():
    for make in MESHES.values():
        mesh = make(generators)
        N = mesh.n_nodes
        maps = ell_maps_from_conn(mesh.conn, N)
        nbr, tr = maps["nbr"], maps["tr"]
        assert nbr.dtype == tr.dtype == np.int32
        c, t = np.nonzero(nbr < N)
        np.testing.assert_array_equal(nbr[nbr[c, t], tr[c, t]], c)
        assert (tr[nbr == N] == 0).all()
    # one entry added to a row with room: node m in row r, r not in row m
    r = int(np.flatnonzero((nbr == N).any(1))[0])
    m = next(j for j in range(N) if j not in nbr[r] and r not in nbr[j])
    bad = nbr.copy()
    bad[r, np.flatnonzero(bad[r] == N)[0]] = m
    with pytest.raises(ValueError, match="not symmetric"):
        transposed_slots(bad)
