"""Outer-loop calibration drivers: scipy optimizers over an objective.

The counterpart of calibr8_tpu's opt/drivers.py (reference Python
driver layer, bin/inverse.py:22-126, util/driver_support.py): scipy
L-BFGS-B or trust-constr over the canonical coordinates, the objective's
value and gradient in process (the reference spawns `objective`
subprocesses and parses objective.dat / gradient.dat).

A failed forward solve (a diverged Newton at an aggressive parameter
point, solve/newton.py NewtonSolveError) becomes a penalty pushing the
optimizer back inward ('penalty_inward'), or repeats the last successful
value ('repeat_last'), as in driver_support.py:181-283.  Every such
event is counted (`n_failed`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from scipy import optimize

from calibr8_tpu_torch.opt.checkpoint import load_checkpoint, save_checkpoint
from calibr8_tpu_torch.solve.newton import NewtonSolveError

# the failure response's numbers (driver_support.py:181-283): the value
# returned for a failed forward solve, and the fake inward gradient's norm,
# min(FAKE_GRAD_SCALE * median of the last GRAD_NORM_WINDOW successful
# gradient norms (FAKE_GRAD_FALLBACK_NORM before any), FAKE_GRAD_CAP)
PENALTY = 1.0e12
FAKE_GRAD_SCALE = 1.0e-3
FAKE_GRAD_CAP = 1.0
FAKE_GRAD_FALLBACK_NORM = 1.0
GRAD_NORM_WINDOW = 25


@dataclass
class InverseResult:
    x_canonical: np.ndarray
    params: np.ndarray
    names: list
    J: float
    n_evals: int
    success: bool
    message: str
    history: list
    n_failed: int = 0


class _EvalWrapper:
    """The objective with failure handling and history recording
    (driver_support.py:181-283).  On a failed forward solve:

      * penalty_inward: the penalty value and a small fake gradient along
        (x - last successful x), so the optimizer's step points back
        toward the last good point; its norm min(FAKE_GRAD_SCALE *
        median successful-gradient norm, FAKE_GRAD_CAP), since a large
        one would poison the L-BFGS curvature pairs;
      * repeat_last: the last successful (J, g), or penalty_inward before
        any success.
    """

    def __init__(self, objective, failure_mode="penalty_inward"):
        self.obj = objective
        self.failure_mode = failure_mode
        self.n_evals = 0
        self.n_failed = 0
        self.history = []
        self.call_log = []
        self._last_good = None
        self._last_good_x = None
        self._grad_norms = []

    def _fake_inward_grad(self, x):
        x = np.asarray(x, dtype=float)
        direction = np.ones_like(x) if self._last_good_x is None else x - self._last_good_x
        nrm = float(np.linalg.norm(direction))
        if not np.isfinite(nrm) or nrm < 1e-12:
            direction = np.ones_like(x)
            nrm = float(np.linalg.norm(direction))
        target = float(np.median(self._grad_norms)) if self._grad_norms else FAKE_GRAD_FALLBACK_NORM
        fake_norm = max(min(FAKE_GRAD_SCALE * target, FAKE_GRAD_CAP), 1e-12)
        return (fake_norm / (nrm + 1e-12)) * direction

    def _record_success(self, x, J, g=None):
        self._last_good_x = np.asarray(x, dtype=float).copy()
        self.history.append((np.asarray(x).copy(), float(J)))
        if g is not None:
            self._last_good = (float(J), np.asarray(g))
            self._grad_norms.append(float(np.linalg.norm(g)))
            del self._grad_norms[:-GRAD_NORM_WINDOW]
        self.call_log.append({"success": True, "objective": float(J)})

    def _handle_failure(self, x, want_grad):
        self.n_failed += 1
        if self.failure_mode == "repeat_last" and self._last_good:
            self.call_log.append({"success": False, "failure_response": "repeat_last"})
            return self._last_good if want_grad else self._last_good[0]
        self.call_log.append({"success": False, "failure_response": "penalty_inward"})
        if want_grad:
            return PENALTY, self._fake_inward_grad(x)
        return PENALTY

    def value_and_grad(self, x):
        self.n_evals += 1
        try:
            J, g = self.obj.value_and_gradient(x)
        except NewtonSolveError:
            return self._handle_failure(x, want_grad=True)
        self._record_success(x, J, g)
        return float(J), np.asarray(g)

    def value(self, x):
        self.n_evals += 1
        try:
            J = self.obj.value(x)
        except NewtonSolveError:
            return self._handle_failure(x, want_grad=False)
        self._record_success(x, J)
        return float(J)


def run_inverse(objective, active, x0=None, method="L-BFGS-B", gtol=1e-8, max_iters=150,
                failure_mode="penalty_inward", out_file=None, checkpoint_path=None, resume=False):
    """Minimize over the canonical coordinates within active.opt_bounds(),
    with the objective's gradient where it has one (a value-only objective
    is finite-differenced by scipy); returns an InverseResult and, with
    out_file, writes the `name: value` lines that check_recovered_params
    reads.  With checkpoint_path the state is saved after every iteration
    and at the end; with resume it restarts from the saved x."""
    x0 = np.zeros(active.n) if x0 is None else np.asarray(x0, dtype=float)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        x0, _, _ = load_checkpoint(checkpoint_path)
    wrapper = _EvalWrapper(objective, failure_mode)
    bounds = active.opt_bounds()

    callback = None
    if checkpoint_path:
        def callback(xk, *unused):
            save_checkpoint(checkpoint_path, np.asarray(xk), wrapper.history,
                            meta={"names": active.names})

    if hasattr(objective, "gradient"):
        fun, jac = wrapper.value_and_grad, True
    else:
        fun, jac = wrapper.value, None
    if method == "L-BFGS-B":
        options = {"maxiter": max_iters, "gtol": gtol, "ftol": 1e-14}
    elif method == "trust-constr":
        options = {"maxiter": max_iters, "gtol": gtol, "xtol": 1e-14}
    else:
        raise ValueError(f"unknown optimizer {method!r}")
    res = optimize.minimize(fun, x0, jac=jac, method=method, bounds=bounds, callback=callback,
                            options=options)

    if checkpoint_path:
        save_checkpoint(checkpoint_path, np.asarray(res.x), wrapper.history,
                        meta={"names": active.names, "final": True})
    params = active.from_canonical(res.x)
    if out_file:
        with open(out_file, "w") as f:
            for name, val in zip(active.names, params):
                f.write(f"{name.split('/')[-1]}: {val:.12e}\n")
    return InverseResult(x_canonical=np.asarray(res.x), params=np.asarray(params),
                         names=active.names, J=float(res.fun), n_evals=wrapper.n_evals,
                         success=bool(res.success), message=str(res.message),
                         history=wrapper.history, n_failed=wrapper.n_failed)
