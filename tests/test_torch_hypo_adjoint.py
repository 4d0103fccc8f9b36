"""The hypo_hill family's kinematics and adjoint, float64 on the CPU,
against calibr8_tpu:

 - t_polar (6 scaled Newton iterations) and t_unrotated_rate on random F
   and F_prev made with numpy from a seed, in 2D and 3D, near the identity
   (|grad_u| ~ 1e-3) and at 30% strain, to 1e-13 of their max;
 - dJ/dp end to end on notch2D h=0.12 with hypo_hill_plane_stress (its
   twin case's constants, calibr8_tpu/models/twin_cases.py:166-173: Q a
   30-degree rotation; 2 load steps, some elements yield): the port's
   AdjointObjective.gradient against calibr8_tpu's in canonical
   coordinates, to 1e-8 relative (two primal solves, each converged to
   Newton's 1e-8); and the port's sweep on calibr8_tpu's own trajectory,
   carried across by convert.trajectory_from_numpy (lambda_z = 1 at step
   0), to 1e-10 of max|dJ/dp|.

The second runs calibr8_tpu's primal and sweep (~30 s), so this file
holds two tests."""

import jax.numpy as jnp
import numpy as np
import torch

from calibr8_tpu.models import batched as jax_batched
from calibr8_tpu.models.base import Kinematics
from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu_torch.convert import trajectory_from_numpy
from calibr8_tpu_torch.models.batched import t_F, t_polar, t_unrotated_rate
from tests.decks import BCS_2D, NOTCH2D, make_deck
from tests.test_torch_adjoint import _jax_side, _port_objective, _rel

PLANE_STRESS = make_deck(NOTCH2D, "hypo_hill_plane_stress",
                         {c[0]: c for c in TWIN_CASES}["hypo_hill_plane_stress"][3], BCS_2D(0.01), 2,
                         global_type="mechanics_plane_stress")
PLANE_STRESS_INVERSE = {"materials": {"body": {"E": [800.0, 1200.0], "Y": [8.0, 12.0],
                                               "S": [4.0, 6.0], "R11": [1.0, 1.2]}}}


def test_polar_and_unrotated_rate_match_jax():
    rng = np.random.default_rng(4)
    for d in (2, 3):
        for amp in (1e-3, 0.3):
            gu, gu_prev = (amp * rng.standard_normal((d, d, 64)) for _ in range(2))
            R_ref = np.asarray(jax_batched.t_polar(jax_batched.t_F(jnp.asarray(gu))))
            R = t_polar(t_F(torch.tensor(gu))).numpy()
            assert _rel(R, R_ref) <= 1e-13, (d, amp)
            # R is orthogonal with det 1: the iteration converged
            RtR = np.einsum("kiE,kjE->ijE", R, R)
            assert np.abs(RtR - np.eye(d)[:, :, None]).max() <= 1e-13
            rate_ref, _ = jax_batched.t_unrotated_rate(
                Kinematics(grad_u=jnp.asarray(gu), grad_u_prev=jnp.asarray(gu_prev)))
            rate, R2 = t_unrotated_rate(torch.tensor(gu), torch.tensor(gu_prev))
            assert torch.equal(R2, torch.tensor(R))
            assert _rel(rate.numpy(), np.asarray(rate_ref)) <= 1e-13, (d, amp)


def test_gradient_end_to_end_plane_stress_hypo():
    j = _jax_side(PLANE_STRESS, PLANE_STRESS_INVERSE)
    assert int(j["traj"].path[-1].sum()) > 0, "no element yields"
    tp, adj, obj = _port_objective(PLANE_STRESS, PLANE_STRESS_INVERSE)
    assert _rel(obj.gradient(j["x0"]), j["g"]) <= 1e-8
    jt = j["traj"]
    traj = trajectory_from_numpy([np.asarray(a) for a in jt.x], [np.asarray(a) for a in jt.xi],
                                 [np.asarray(a) for a in jt.path], jt.qoi_values, device="cpu")
    np.testing.assert_array_equal(traj.xi[0].numpy(), np.tile(tp.model.init_xi(), (tp.disc.n_elem, 1)))
    grad, _ = adj.sweep(traj, torch.tensor(np.asarray(j["params_all"])), tp.time_grid)
    assert _rel(grad, j["grad_all"]) <= 1e-10
