"""The port's backward adjoint step and sweep on calibr8_tpu's own primal
trajectory of the notch2D small_J2 8-step deck (via
convert.trajectory_from_numpy), float64 on the CPU: one step with seeded
histories f, g (z, phi, f, g and the step's dJ/dp), and the whole sweep's
dJ/dp, each to 1e-10 of max|.|.  calibr8_tpu's primal and sweep are built
once for the module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu_torch.convert import trajectory_from_numpy
from tests.test_torch_adjoint import NOTCH_J2, NOTCH_J2_INVERSE, _jax_side, _port_objective, _rel


@pytest.fixture(scope="module")
def notch():
    return dict(jax=_jax_side(NOTCH_J2, NOTCH_J2_INVERSE), port=_port_objective(NOTCH_J2, NOTCH_J2_INVERSE))


def _jax_traj_to_port(jt):
    return trajectory_from_numpy([np.asarray(a) for a in jt.x], [np.asarray(a) for a in jt.xi],
                                 [np.asarray(a) for a in jt.path], jt.qoi_values, device="cpu")


def test_adjoint_step_matches_jax(notch):
    """One backward step on calibr8_tpu's state of the last load step with
    seeded histories f, g: z, phi, f, g and the step's dJ/dp."""
    j, (tp, adj, _) = notch["jax"], notch["port"]
    jt, step = j["traj"], 8
    d = tp.disc
    rng = np.random.default_rng(4)
    f = 1e-3 * rng.standard_normal((d.n_elem, d.spec.ndofs_elem))
    g = 1e-3 * rng.standard_normal((d.n_elem, tp.model.nxi()))
    bc_j, _ = j["jp"].dbcs.arrays(j["jp"].time_grid.time(step), step)
    ref = j["adj"]._step(jt.x[step], jt.x[step - 1], jt.xi[step], jt.xi[step - 1], jt.path[step],
                         j["params_all"], jnp.asarray(f), jnp.asarray(g), bc_j, ())
    tr = _jax_traj_to_port(jt)
    bc_t, _ = tp.dbcs.arrays(tp.time_grid.time(step), step)
    res = adj.step(tr.x[step], tr.x[step - 1], tr.xi[step], tr.xi[step - 1], tr.path[step],
                   torch.tensor(np.asarray(j["params_all"])), torch.tensor(f), torch.tensor(g), bc_t)
    assert res.relres <= 1e-10
    for name in ("z", "phi", "f", "g", "grad"):
        assert _rel(getattr(res, name), getattr(ref, name)) <= 1e-10, name


def test_sweep_on_jax_trajectory(notch):
    """The port's sweep on calibr8_tpu's own primal trajectory."""
    j, (tp, adj, _) = notch["jax"], notch["port"]
    grad, zs = adj.sweep(_jax_traj_to_port(j["traj"]), torch.tensor(np.asarray(j["params_all"])),
                         tp.time_grid)
    assert sorted(zs) == list(range(1, 9))
    assert [s["step"] for s in adj.step_info] == list(range(8, 0, -1))
    assert _rel(grad, j["grad_all"]) <= 1e-10
