"""The EBE matvec and the node-block ELL operator, forward and transposed
(plain versions: the CPU path, and the oracles of the CUDA kernels on
the card) against calibr8_tpu, Dirichlet rows included.

Tolerance 1e-13 relative to max|y|: the same float64 products summed in
another order."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem import assembly as jax_assembly
from calibr8_tpu.fem.bcs import apply_dbcs_matvec as jax_apply_dbcs_matvec
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve import ellpack as jax_ellpack
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.assembly import dense_matrix, ebe_matvec_disc, jac_is_trailing
from calibr8_tpu_torch.fem.bcs import apply_dbcs_matvec
from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec, ebe_matvec_plain
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.ellpack import (
    EllOperator, assemble_ell_T, build_ell_maps, ell_maps_from_conn, ell_spmv, ell_spmv_plain,
    ell_spmv_T, ell_spmv_T_plain,
)
from calibr8_tpu.models.twin_cases import HILL2D
from tests.decks import BCS_2D, BCS_3D, J2_MAT, NOTCH2D, make_deck

MESHES = {
    # mesh, bcs, model, materials, global residual
    "notch2D": (NOTCH2D, BCS_2D(0.02), "small_J2", J2_MAT, "mechanics"),
    "cube3": ({"type": "cube", "n": 3}, BCS_3D(0.02), "small_J2", J2_MAT, "mechanics"),
    # displacement only: nde = 6, ndpn = 2
    "notch2D_plane_stress": (NOTCH2D, BCS_2D(0.02), "small_hill_plane_stress", HILL2D,
                             "mechanics_plane_stress"),
}
RTOL = 1e-13
# the ELL apply and its transpose (kernels 3a and 3b), called on the ELL
# maps (build_ell_maps) as (wrapper, plain)
DIRECTIONS = {
    "forward": (lambda A_T, maps, v, d: ell_spmv(A_T, maps["nbr_T"], v, d),
                lambda A_T, maps, v, d: ell_spmv_plain(A_T, maps["nbr_T"], v, d)),
    "transpose": (lambda A_T, maps, v, d: ell_spmv_T(A_T, maps["nbr_T"], maps["tr_T"], v, d),
                  lambda A_T, maps, v, d: ell_spmv_T_plain(A_T, maps["nbr_T"], v, d)),
}


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module", params=list(MESHES))
def system(request):
    mesh, bcs, model, mats, gtype = MESHES[request.param]
    deck = make_deck(mesh, model, mats, bcs, 1, global_type=gtype)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    d = tp.disc
    rng = np.random.default_rng(3)
    c = d.mesh.coords
    u = np.stack([0.02 * c[:, 1] ** 2 if i == 1 else -0.006 * c[:, i] for i in range(d.spec.dim)], 1)
    x = np.concatenate([(u + 4e-4 * rng.standard_normal(u.shape)).reshape(-1),
                        rng.standard_normal(d.n_nodes if d.spec.mixed else 0)])
    xi_prev = np.zeros((d.n_elem, tp.model.nxi()))
    _, J_T, diag, _, _, _ = tp.assembler.assemble(torch.tensor(x), torch.tensor(xi_prev), tp.params0)
    bc_dofs, _ = tp.dbcs.arrays(1.0, 1)
    v = rng.standard_normal(d.n_dofs)
    return dict(name=request.param, jp=jp, tp=tp, J_T=J_T, diag=diag, bc=bc_dofs, v=v)


@pytest.mark.parametrize("layout", ["trailing", "elem_first"])
def test_ebe_matches_jax(system, layout):
    J_T, diag, bc, v = system["J_T"], system["diag"], system["bc"], system["v"]
    J = J_T if layout == "trailing" else J_T.permute(2, 0, 1).contiguous()
    jd, td = system["jp"].disc, system["tp"].disc
    assert jac_is_trailing(J, td) == (layout == "trailing")
    y_jax = jax_assembly.ebe_matvec_disc(jnp.asarray(J.numpy()), jd, jnp.asarray(v))
    y_jax = jax_apply_dbcs_matvec(y_jax, jnp.asarray(diag.numpy()), jnp.asarray(v),
                                  jnp.asarray(bc.numpy(), jnp.int32))
    vt = torch.tensor(v)
    y = apply_dbcs_matvec(ebe_matvec_disc(J, td, vt), diag, vt, bc)
    _close(y.numpy(), y_jax)


def test_ebe_wrapper_is_plain_on_cpu(system):
    td = system["tp"].disc
    v = torch.tensor(system["v"])
    a = ebe_matvec(system["J_T"], v, td.edofs_T, td.n_dofs)
    b = ebe_matvec_plain(system["J_T"], v, td.edofs_T, td.n_dofs)
    assert torch.equal(a, b)


def test_ell_maps_match_jax_dense_packing(system, monkeypatch):
    """With calibr8_tpu's stencil canonicalization off, its ELL maps use
    the same dense slot packing as the port's: equal arrays."""
    monkeypatch.setenv("CALIBR8_ELL_STENCIL", "0")
    conn, n = system["tp"].disc.mesh.conn, system["tp"].disc.n_nodes
    mj = jax_ellpack.ell_maps_from_conn(conn, n)
    mt = ell_maps_from_conn(conn, n)
    assert mj["K"] == mt["K"]
    for k in ("nbr", "ell_ids_T"):
        np.testing.assert_array_equal(np.asarray(mj[k]), mt[k])


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_ell_operator_matches_jax(system, direction):
    """The port's ELL assembly + plain apply against calibr8_tpu's
    EllOperator CPU path (assemble_ell) and its EBE matvec, same J.  The
    transposed operator (A^T, then the Dirichlet rows) assembles the
    forward J and applies ell_spmv_T's plain version; calibr8_tpu's
    transposes the element blocks first."""
    J_T, diag, bc, v = system["J_T"], system["diag"], system["bc"], system["v"]
    jd, td = system["jp"].disc, system["tp"].disc
    transpose = direction == "transpose"
    J_ef = jnp.asarray(J_T.permute(2, 0, 1).numpy())
    jdiag, jbc = jnp.asarray(diag.numpy()), jnp.asarray(bc.numpy(), jnp.int32)
    y_jax_ell = jax_ellpack.EllOperator(jd, J_ef, jdiag, jbc, transpose=transpose)(jnp.asarray(v))
    J_op = J_ef.swapaxes(1, 2) if transpose else J_ef
    y_jax_ebe = jax_apply_dbcs_matvec(
        jax_assembly.ebe_matvec_disc(J_op, jd, jnp.asarray(v)), jdiag, jnp.asarray(v), jbc
    )
    y = EllOperator(td, J_T, diag, bc, transpose=transpose)(torch.tensor(v)).numpy()
    _close(y, y_jax_ell)
    _close(y, y_jax_ebe)


def test_ell_assembly_is_the_assembled_matrix(system):
    """A_T densified equals the dense scatter of the element blocks."""
    td, J_T = system["tp"].disc, system["J_T"]
    A_T = assemble_ell_T(J_T, td)
    nbr_T = build_ell_maps(td)["nbr_T"].long()
    K, m, _, n = A_T.shape
    d = td.spec.dim

    def dof(nodes, j):
        return nodes * d + j if j < d else n * d + nodes

    dense = torch.zeros(td.n_dofs, td.n_dofs, dtype=A_T.dtype)
    valid = nbr_T < n
    rows_n = torch.arange(n)[None, :].expand(K, n)[valid]
    for i in range(m):
        for j in range(m):
            dense.index_put_((dof(rows_n, i), dof(nbr_T[valid], j)), A_T[:, i, j][valid],
                             accumulate=True)
    # pad slots carry zero blocks
    assert torch.all(A_T.permute(0, 3, 1, 2)[~valid] == 0)
    ref = dense_matrix(J_T.permute(2, 0, 1), td.edofs, td.n_dofs)
    _close(dense.numpy(), ref.numpy())
    A_jax = jax_assembly.dense_matrix(jnp.asarray(J_T.permute(2, 0, 1).numpy()),
                                      system["jp"].disc.edofs, td.n_dofs)
    _close(ref.numpy(), A_jax)


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_ell_wrapper_is_plain_on_cpu(system, direction):
    wrapper, plain = DIRECTIONS[direction]
    td = system["tp"].disc
    A_T = assemble_ell_T(system["J_T"], td)
    maps = build_ell_maps(td)
    v = torch.tensor(system["v"])
    assert torch.equal(wrapper(A_T, maps, v, td.spec.dim), plain(A_T, maps, v, td.spec.dim))
