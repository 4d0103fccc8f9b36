"""The port's uniform refinement (calibr8_tpu_torch/mesh/refine.py) against
calibr8_tpu's mesh/refine.py: the same fine mesh, array for array, on the
builtin notch2D and cube meshes, level by level; and build_mesh's
`refinements:` chain.  numpy only (calibr8_tpu's native helpers or their
numpy fallback on its side, the port's vectorised copy on the other)."""

import numpy as np
import pytest

from calibr8_tpu.mesh import generators as jax_generators
from calibr8_tpu.mesh.refine import uniform_refine as jax_uniform_refine
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.mesh.refine import uniform_refine
from calibr8_tpu_torch.problem import build_mesh
from tests.decks import BCS_2D, J2_MAT, make_deck

CASES = [("notch2d", dict(h=0.25), L) for L in (1, 2, 3)] + [("cube", dict(n=2), L) for L in (1, 2)]


def assert_same_refinement(rj, rt):
    fj, ft = rj.fine, rt.fine
    for name, a, b in (("coords", fj.coords, ft.coords), ("conn", fj.conn, ft.conn),
                       ("node_parents", rj.node_parents, rt.node_parents),
                       ("elem_parent", rj.elem_parent, rt.elem_parent)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for sets in ("node_sets", "side_sets", "elem_sets"):
        sj, st = getattr(fj, sets), getattr(ft, sets)
        assert list(sj) == list(st), sets
        for k in sj:
            np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=f"{sets}[{k}]")


@pytest.mark.parametrize("kind,kw,L", CASES, ids=[f"{k}-L{L}" for k, _, L in CASES])
def test_uniform_refine_matches_jax(kind, kw, L):
    """Level L of the chain from the builtin mesh is calibr8_tpu's, array
    for array (the lattice renumbering included on the cube)."""
    mj = getattr(jax_generators, kind)(**kw)
    mt = getattr(generators, kind)(**kw)
    for _ in range(L):
        rj, rt = jax_uniform_refine(mj), uniform_refine(mt)
        mj, mt = rj.fine, rt.fine
    assert_same_refinement(rj, rt)
    assert mt.n_elems == getattr(generators, kind)(**kw).n_elems * (2 ** mt.dim) ** L


def test_build_mesh_keeps_the_chain():
    """`refinements: 2` solves on the twice refined mesh and keeps the
    chain and the base mesh on it, as calibr8_tpu's build_mesh does."""
    from calibr8_tpu.deck import load_deck as jax_load_deck
    from calibr8_tpu.problem import build_mesh as jax_build_mesh

    deck = make_deck({"type": "notch2D", "h": 0.25, "refinements": 2}, "small_J2", J2_MAT,
                     BCS_2D(0.001), 1)
    mj, mt = jax_build_mesh(jax_load_deck(deck)), build_mesh(load_deck(deck))
    assert len(mt.refine_chain) == 2
    for rj, rt in zip(mj.refine_chain, mt.refine_chain):
        assert_same_refinement(rj, rt)
    np.testing.assert_array_equal(mt.refine_base.conn, np.asarray(mj.refine_base.conn))
    assert mt is mt.refine_chain[-1].fine
