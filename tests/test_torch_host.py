"""Host layer of the port against calibr8_tpu: meshes, quadrature,
element geometry and dof maps, boundary conditions, deck validation.
Everything here is numpy work on both sides, so equality is exact or to
1e-14 (float64 rounding of the same formulas)."""

import copy

import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.fem import basis as jax_basis
from calibr8_tpu.mesh import generators as jax_gen
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem import basis
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.problem import Problem
from tests.decks import BCS_2D, BCS_3D, CUBE, ELASTIC_MAT, J2_MAT, NOTCH2D, make_deck

MESHES = {
    "cube2": ("cube", {"n": 2}),
    "cube3": ("cube", {"n": 3}),
    "square": ("square", {"n": 4}),
    "notch2D": ("notch2d", {"h": 0.12}),
    "notch3D": ("notch3d", {"h": 0.15, "lz": 0.1, "nz": 1}),
}

DECKS = {
    "cube_small_J2": make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 2),
    "notch2D_small_J2": make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.001), 2),
    "cube_elastic_traction": make_deck(
        CUBE, "elastic", ELASTIC_MAT, BCS_3D(0.0), 1,
        **{"traction bcs": {"bc 1": [0, "xmax", "0.1 * t", "0.0", "x + z"]}},
    ),
}


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, deck in DECKS.items():
        out[name] = (
            JaxProblem(jax_load_deck(copy.deepcopy(deck))),
            Problem(load_deck(copy.deepcopy(deck)), device="cpu"),
        )
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_generators_match(name):
    fn, kw = MESHES[name]
    a = getattr(jax_gen, fn)(**kw)
    b = getattr(generators, fn)(**kw)
    assert a.dim == b.dim
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.conn, b.conn)
    for sets in ("node_sets", "side_sets", "elem_sets"):
        sa, sb = getattr(a, sets), getattr(b, sets)
        assert list(sa) == list(sb)
        for k in sa:
            np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]))


@pytest.mark.parametrize("dim,order", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_quadrature_tables_match(dim, order):
    pa, wa = jax_basis.quadrature(dim, order)
    pb, wb = basis.quadrature(dim, order)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(jax_basis.shape_values(dim, pa), basis.shape_values(dim, pb))
    np.testing.assert_array_equal(jax_basis.shape_grads_parent(dim), basis.shape_grads_parent(dim))


@pytest.mark.parametrize("name", list(DECKS))
def test_disc_geometry_and_dofs_match(problems, name):
    jp, tp = problems[name]
    jd, td = jp.disc, tp.disc
    assert (jd.n_nodes, jd.n_elem, jd.n_dofs) == (td.n_nodes, td.n_elem, td.n_dofs)
    np.testing.assert_array_equal(np.asarray(jd.mesh.conn), td.mesh.conn)
    for a, b in ((jd.grad_N, td.grad_N), (jd.detJ, td.detJ), (jd.h, td.h)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(np.asarray(jd.edofs), td.edofs.numpy())
    np.testing.assert_array_equal(np.asarray(jd.edofs).T, td.edofs_T.numpy())
    np.testing.assert_array_equal(np.asarray(jd.es_ids), td.es_ids.numpy())
    np.testing.assert_array_equal(
        np.moveaxis(np.asarray(jd.grad_N), 0, -1), td.gN_T.numpy()
    )
    np.testing.assert_array_equal(np.asarray(jp.params0), tp.params0.numpy())


@pytest.mark.parametrize("name", list(DECKS))
def test_boundary_conditions_match(problems, name):
    jp, tp = problems[name]
    for step, t in ((1, 1.0), (2, 0.37)):
        jd, jv = jp.dbcs.arrays(t, step)
        td, tv = tp.dbcs.arrays(t, step)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-14, atol=1e-14)
        if jp.tbcs is not None:
            np.testing.assert_allclose(
                np.asarray(jp.tbcs.array(t)), tp.tbcs.array(t).numpy(), rtol=1e-14, atol=1e-14
            )


def test_deck_validation_matches():
    """An elastic deck without cte / delta_T fails in both, with the same
    message (calibr8_tpu deck.py:201-208)."""
    mats = {"E": 1000.0, "nu": 0.25}
    deck = make_deck(CUBE, "elastic", mats, BCS_3D(0.0), 1)
    with pytest.raises(ValueError) as ej:
        JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    with pytest.raises(ValueError) as et:
        Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    assert str(ej.value) == str(et.value)
    assert "cte" in str(et.value) and "delta_T" in str(et.value)


def test_unknown_sublist_rejected():
    deck = make_deck(CUBE, "elastic", ELASTIC_MAT, BCS_3D(0.0), 1)
    deck["linear algebr"] = {}
    with pytest.raises(ValueError, match="unknown deck sublist"):
        load_deck(deck)


def test_problem_tensors_on_requested_device_and_dtype():
    deck = make_deck(CUBE, "small_J2", J2_MAT, BCS_3D(0.02), 1)
    p = Problem(load_deck(deck), device="cpu", dtype=torch.float32)
    d = p.disc
    assert d.device.type == "cpu"
    for t in (d.grad_N, d.gN_T, d.detJ, d.h, p.params0):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert d.edofs_T.dtype == torch.int32 and d.edofs_T.is_contiguous()


def test_field_dirichlet_bcs_match():
    """Measured-data DBCs read the nodal field <prefix>_<step> attached
    to the mesh (reference dbcs.cpp apply_field_primal_dbcs)."""
    deck = make_deck(NOTCH2D, "small_J2", J2_MAT, BCS_2D(0.001), 2)
    deck["dirichlet bcs"]["field"] = {"bc f": [0, 1, "ymax", "measured"]}
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    rng = np.random.default_rng(4)
    for step in (1, 2):
        field = rng.standard_normal((tp.disc.n_nodes, 2))
        jp.mesh.fields[f"measured_{step}"] = field
        tp.mesh.fields[f"measured_{step}"] = field
        jd, jv = jp.dbcs.arrays(0.5 * step, step)
        td, tv = tp.dbcs.arrays(0.5 * step, step)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    with pytest.raises(ValueError, match="measured_3"):
        tp.dbcs.arrays(1.5, 3)


def test_time_file_matches(tmp_path):
    path = tmp_path / "times.txt"
    path.write_text("0.0\n0.25\n\n0.75\n1.5\n")
    deck = make_deck(CUBE, "elastic", ELASTIC_MAT, BCS_3D(0.0), 1)
    deck["discretization"]["time file"] = str(path)
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    tp = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    np.testing.assert_array_equal(jp.time_grid.times, tp.time_grid.times)
    assert tp.time_grid.num_steps == 3 and tp.time_grid.time(2) == 0.75
