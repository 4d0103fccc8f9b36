"""FEMU recovery through the port alone, float64 on the CPU: the fast
configuration of tests/test_calibration_recovery.py (test_femu_recovery_fast:
notch2D h=0.25, 2 load steps, small_hill_plane_stress).  The forward solve
at the truth writes the synthetic data (the reaction mismatch QoI's
load.dat, attach_synthetic's measured_<step> fields); the calibration QoI's
adjoint objective under scipy L-BFGS-B recovers Y and D from 2.5 / 2.8 to
rel < 5e-3 of the truth.  The port's QoI and gradient are held to
calibr8_tpu's in test_torch_femu_qoi.py."""

import copy

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.io.synthetic import attach_synthetic
from calibr8_tpu_torch.opt.drivers import run_inverse
from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.adjoint import Adjoint
from calibr8_tpu_torch.solve.linear import LinearCfg

HILL = {"R00": 1.0, "R11": 1.0, "R22": 1.0, "R01": 1.0}
TRUTH = {"E": 1000.0, "nu": 0.25, "Y": 2.0, "S": 10.0, "D": 2.0, **HILL}
START = {**TRUTH, "Y": 2.5, "D": 2.8}
ACTIVE = {"materials": {"body": {"Y": [1.0, 3.0], "D": [1.0, 4.0]}}}
# the load plane: the y reaction at the nodes on y = 1
PLANE = {"coordinate index": 1, "coordinate value": 1.0, "coordinate tolerance": 1e-6,
         "reaction force component": 1}


def deck(materials, qoi, h=0.3):
    """tests/test_calibration_recovery.py's deck at its fast configuration's
    load (pull 0.005 t over 2 steps) on notch2D at size h."""
    return {
        "discretization": {"builtin mesh": {"type": "notch2D", "h": h}, "num steps": 2,
                           "step size": 1.0},
        "residuals": {
            "global residual": {"type": "mechanics_plane_stress", "nonlinear max iters": 30,
                                "nonlinear absolute tol": 1e-8, "nonlinear relative tol": 1e-8},
            "local residual": {"type": "small_hill_plane_stress", "nonlinear max iters": 500,
                               "nonlinear absolute tol": 1e-12, "nonlinear relative tol": 1e-12,
                               "materials": {"body": materials}},
        },
        "dirichlet bcs": {"expression": {"bc 1": [0, 0, "xmin", "0.0"],
                                         "bc 2": [0, 1, "ymin", "0.0"],
                                         "bc 3": [0, 1, "ymax", "0.005 * t"]}},
        "quantity of interest": qoi,
    }


def test_femu_recovery_fast(tmp_path):
    load_file = str(tmp_path / "load.dat")
    syn_deck = deck(TRUTH, {"type": "reaction mismatch", **PLANE, "load out file": load_file},
                    h=0.25)
    syn = Problem(load_deck(syn_deck), device="cpu")
    traj = syn.solve_primal()
    attach_synthetic(syn.mesh, syn.disc, traj)
    assert sorted(syn.qoi.load_history) == [1, 2]

    cal_deck = copy.deepcopy(syn_deck)
    cal_deck["residuals"]["local residual"]["materials"] = {"body": dict(START)}
    cal_deck["quantity of interest"] = {
        "type": "calibration", "balance factor": 4.22, **PLANE,
        "displacement weights": [3.98e7, 3.98e7], "load input file": load_file,
    }
    cal = Problem(load_deck(cal_deck), mesh=syn.mesh, device="cpu")
    adj = Adjoint(cal.assembler, cal.qoi, cal.dbcs, LinearCfg())
    active = ActiveParams.from_inverse_spec(ACTIVE, cal.disc.elem_set_names, cal.model.param_names)
    obj = AdjointObjective(cal, adj, active)
    x0 = active.to_canonical(active.extract(cal.params0))
    res = run_inverse(obj, active, x0=x0, max_iters=60, gtol=1e-12)
    recovered = dict(zip([n.split("/")[-1] for n in res.names], res.params))
    assert res.n_failed == 0
    for name in ("Y", "D"):
        rel = abs(recovered[name] - TRUTH[name]) / TRUTH[name]
        assert rel < 5e-3, (
            f"{name} = {recovered[name]:.6f} vs {TRUTH[name]} "
            f"(rel {rel:.2e}); J = {res.J:.3e}, evals = {res.n_evals}"
        )
