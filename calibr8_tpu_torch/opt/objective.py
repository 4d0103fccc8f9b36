"""Optimization objectives over material parameters.

The counterpart of calibr8_tpu's opt/objective.py (reference
objective.{hpp,cpp}, adjoint_objective.cpp, femu_objective.cpp): the
active (calibrated) parameters are selected per element set from the
`inverse: materials:` sublist and scaled to canonical coordinates
(opt/transforms.py), with the chain-rule factor applied to gradients.
The adjoint objective re-solves the primal when the parameters change
and runs the backward adjoint sweep for its gradient; value and gradient
share the cached trajectory.  The FEMU objective is value only: the
optimizer (opt/drivers.py) finite-differences it.  Canonical coordinates
and gradients are numpy arrays (the optimizer's view); parameters live on
the Problem's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from calibr8_tpu_torch.opt import transforms as tr


@dataclass
class ActiveParams:
    """Active-parameter bookkeeping: (elem_set, param) pairs and scales,
    each (lo, hi) bounds -> canonical [-1, 1], a float ref value -> log
    scaling, or None -> the value itself."""

    entries: list  # [(es_idx, param_idx, name)]
    scales: list  # [(lo, hi) | float | None] per entry

    @classmethod
    def from_inverse_spec(cls, inverse_params: dict, elem_set_names, param_names):
        """Parse `inverse: materials: <es>: <param>: [lo, hi] | ref | null`
        (objective.cpp:75-110), element-set-major, model-parameter-order
        minor, as the reference orders them."""
        mats = inverse_params.get("materials", {})
        entries, scales = [], []
        for es_idx, es in enumerate(elem_set_names):
            m = mats.get(es, {}) or {}
            for p_idx, pname in enumerate(param_names):
                if pname in m:
                    s = m[pname]
                    entries.append((es_idx, p_idx, f"{es}/{pname}"))
                    if s is None:
                        scales.append(None)
                    elif isinstance(s, (int, float)):
                        scales.append(float(s))
                    else:
                        scales.append((float(s[0]), float(s[1])))
        return cls(entries, scales)

    @property
    def n(self) -> int:
        return len(self.entries)

    @property
    def names(self):
        return [e[2] for e in self.entries]

    # bounds-mode views (valid when every scale is a (lo, hi) pair)
    @property
    def lower(self) -> np.ndarray:
        return np.asarray([s[0] for s in self.scales])

    @property
    def upper(self) -> np.ndarray:
        return np.asarray([s[1] for s in self.scales])

    def span(self) -> np.ndarray:
        return 0.5 * (self.upper - self.lower)

    def mean(self) -> np.ndarray:
        return 0.5 * (self.upper + self.lower)

    def opt_bounds(self):
        """The optimizer's box, one (lo, hi) per entry: (-1, 1) for bounds
        scaling, unbounded (None, None) for value and log scaling."""
        return [tr.opt_bounds(s) for s in self.scales]

    def to_canonical(self, p) -> np.ndarray:
        return tr.transform_parameters(np.asarray(p), self.scales, False)

    def from_canonical(self, x) -> np.ndarray:
        return tr.transform_parameters(np.asarray(x), self.scales, True)

    def grad_to_canonical(self, g, p=None) -> np.ndarray:
        """dJ/dx = dJ/dp * dp/dx; log scaling needs the parameter values p."""
        if p is None:
            if any(tr.is_log(s) for s in self.scales):
                raise ValueError("log-scaled gradients need parameter values")
            p = np.zeros_like(np.asarray(g))
        return tr.grad_transform(np.asarray(g), np.asarray(p), self.scales)

    def insert(self, params_all, p_active):
        """A copy of params_all (n_sets, n_params; a tensor or an array)
        with the active entries set to p_active."""
        out = params_all.clone() if isinstance(params_all, torch.Tensor) else np.array(params_all)
        for k, (es, pi, _) in enumerate(self.entries):
            out[es, pi] = float(p_active[k])
        return out

    def extract(self, params_all) -> np.ndarray:
        a = _numpy(params_all)
        return np.asarray([a[es, pi] for (es, pi, _) in self.entries])

    def extract_grad(self, grad_all) -> np.ndarray:
        return self.extract(grad_all)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class AdjointObjective:
    """value = sum over steps of J; gradient by the backward adjoint
    sweep; both in canonical coordinates."""

    def __init__(self, problem, adjoint, active: ActiveParams):
        self.problem = problem
        self.adjoint = adjoint
        self.active = active
        self._cache_x = None
        self._cache_traj = None

    def _params_all(self, x_canonical):
        return self.active.insert(self.problem.params0, self.active.from_canonical(x_canonical))

    def _solve(self, x_canonical):
        x_c = np.asarray(x_canonical, dtype=np.float64)
        if self._cache_x is not None and np.array_equal(self._cache_x, x_c):
            return self._cache_traj
        traj = self.problem.primal.run(self._params_all(x_c))
        self._cache_x = x_c.copy()
        self._cache_traj = traj
        return traj

    def value(self, x_canonical) -> float:
        return self._solve(x_canonical).J

    def gradient(self, x_canonical) -> np.ndarray:
        traj = self._solve(x_canonical)
        params_all = self._params_all(np.asarray(x_canonical))
        grad_all, _ = self.adjoint.sweep(traj, params_all, self.problem.time_grid)
        g_active = self.active.extract_grad(grad_all)
        return self.active.grad_to_canonical(g_active, self.active.extract(params_all))

    def value_and_gradient(self, x_canonical):
        return self.value(x_canonical), self.gradient(x_canonical)


class MultiProblemObjective:
    """Sum of objectives over independent problems that share one
    ActiveParams (multi-experiment calibration, adjoint_objective.cpp)."""

    def __init__(self, objectives, active: ActiveParams):
        self.objectives = list(objectives)
        self.active = active

    def value(self, x_canonical) -> float:
        return sum(o.value(x_canonical) for o in self.objectives)

    def gradient(self, x_canonical) -> np.ndarray:
        g = np.zeros(self.active.n)
        for o in self.objectives:
            g = g + np.asarray(o.gradient(x_canonical))
        return g

    def value_and_gradient(self, x_canonical):
        J, g = 0.0, np.zeros(self.active.n)
        for o in self.objectives:
            Ji, gi = o.value_and_gradient(x_canonical)
            J += Ji
            g = g + np.asarray(gi)
        return J, g


class FEMUObjective:
    """Value only: the optimizer finite-differences its gradient
    (femu_objective.cpp:13-37)."""

    def __init__(self, problem, active: ActiveParams):
        self.problem = problem
        self.active = active

    def value(self, x_canonical) -> float:
        p_active = self.active.from_canonical(np.asarray(x_canonical))
        return self.problem.primal.run(self.active.insert(self.problem.params0, p_active)).J


def fd_gradient_check(value_fn, grad, x, direction=None, num_steps=13, seed=0):
    """The reference's gradient verification (main_inverse.cpp:126-159):
    finite differences along a random direction with steps 10^-k;
    returns (log10 of max error / min error, errors), ~7-8 decades for a
    correct gradient in float64."""
    x = np.asarray(x, dtype=np.float64)
    if direction is None:
        direction = np.random.default_rng(seed).uniform(-1.0, 1.0, size=x.shape)
    direction = np.asarray(direction)
    gdotv = float(np.dot(np.asarray(grad), direction))
    errs = []
    for k in range(num_steps):
        h = 10.0 ** (-k)
        fd = (value_fn(x + h * direction) - value_fn(x)) / h
        errs.append(abs(fd - gdotv))
    errs = np.asarray(errs)
    drop = np.log10(errs.max() / max(errs.min(), 1e-300))
    return drop, errs
