"""The multigrid level apply (kernel 3c's plain version, LevelEllOperator)
against calibr8_tpu's LevelEllOperator, whose CPU branch is the einsum of
solve/ellpack.py:408, at node-block widths m = 1, 2, 3; the wrapper's CPU
path; and the multigrid decks that route to the aggregation AMG.  float64, inputs
from numpy seeds."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.deck import load_deck as jax_load_deck
from calibr8_tpu.problem import Problem as JaxProblem
from calibr8_tpu.solve.amg import AMGPrecondFactory as JaxAMGPrecondFactory
from calibr8_tpu.solve.ellpack import LevelEllOperator as JaxLevelEllOperator
from calibr8_tpu.solve.ellpack import ell_maps_from_conn as jax_ell_maps
from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.mesh.refine import uniform_refine
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.amg import AMGPrecondFactory
from calibr8_tpu_torch.solve.ellpack import (
    LevelEllOperator, ell_device_maps, level_ell_spmv, level_ell_spmv_plain,
)
from tests.decks import BCS_2D, J2_MAT, make_deck

# (mesh, m): the pressure chain (m = 1) and the displacement chains (m = dim)
LEVELS = {"m1": (lambda: uniform_refine(generators.notch2d(0.25)).fine, 1),
          "m2": (lambda: uniform_refine(generators.notch2d(0.25)).fine, 2),
          "m3": (lambda: generators.cube(2), 3)}


@pytest.mark.parametrize("case", list(LEVELS))
def test_level_apply_matches_jax(case):
    """y = A_l x to 1e-14 from the same element blocks: the port's dense
    slot packing against calibr8_tpu's maps (its stencil slots where the
    mesh is a lattice)."""
    make_mesh, m = LEVELS[case]
    mesh = make_mesh()
    conn, n = np.asarray(mesh.conn), mesh.n_nodes
    rng = np.random.default_rng(4)
    nb = conn.shape[1] * m
    JT = rng.standard_normal((nb, nb, conn.shape[0]))
    x = rng.standard_normal(n * m)
    jm = jax_ell_maps(conn, n)
    y_j = np.asarray(JaxLevelEllOperator(jnp.asarray(JT), jnp.asarray(jm["nbr"]),
                                         jnp.asarray(jm["ell_ids_T"]), jm["K"], n, m,
                                         offsets=jm.get("offsets"))(jnp.asarray(x)))
    op = LevelEllOperator(torch.tensor(JT), ell_device_maps(conn, n, "cpu"), n, m)
    y_t = op(torch.tensor(x)).numpy()
    assert np.abs(y_t - y_j).max() <= 1e-14 * np.abs(y_j).max()
    # from_assembled (the reuse-step state) applies the same matrix
    again = LevelEllOperator.from_assembled(op.A_T, ell_device_maps(conn, n, "cpu"), m)
    np.testing.assert_array_equal(again(torch.tensor(x)).numpy(), y_t)


def test_level_wrapper_on_cpu_runs_the_plain_version():
    """On CPU tensors the kernel-3c wrapper is its plain version and
    counts no launch."""
    mesh = generators.cube(2)
    maps = ell_device_maps(mesh.conn, mesh.n_nodes, "cpu")
    rng = np.random.default_rng(5)
    A_T = torch.tensor(rng.standard_normal((maps["K"], 3, 3, mesh.n_nodes)))
    x = torch.tensor(rng.standard_normal(mesh.n_nodes * 3))
    before = dict(kernels.launches)
    assert torch.equal(level_ell_spmv(A_T, maps["nbr_T"], x, 3),
                       level_ell_spmv_plain(A_T, maps["nbr_T"], x, 3))
    assert kernels.launches == before


@pytest.mark.parametrize("la,mesh", [({"preconditioner": "amg"}, {"refinements": 1}),
                                     ({"preconditioner": "multigrid"}, {})],
                         ids=["amg_on_a_refined_mesh", "multigrid_without_refinements"])
def test_aggregation_amg_decks_name_the_missing_module(la, mesh):
    """calibr8_tpu runs these on its aggregation AMG (problem.py:180-199),
    and so does the port: Problem's factory is an AMGPrecondFactory with
    calibr8_tpu's level sizes (solve/amg.py).  The name is from when the
    port raised here, naming the module it lacked."""
    deck = make_deck({"type": "notch2D", "h": 0.25, **mesh}, "small_J2", J2_MAT,
                     BCS_2D(0.001), 1)
    deck["linear algebra"] = {"method": "gmres", **la}
    prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    assert isinstance(prob.mg_factory, AMGPrecondFactory)
    assert prob.step_solver.mg_factory is prob.mg_factory and prob.mg_setup_s > 0
    jp = JaxProblem(jax_load_deck(copy.deepcopy(deck)))
    assert isinstance(jp.mg_factory, JaxAMGPrecondFactory)
    assert prob.mg_factory.level_sizes == jp.mg_factory.level_sizes
