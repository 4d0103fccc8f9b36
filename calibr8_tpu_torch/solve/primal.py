"""Primal forward solve: the pseudo-time load-stepping loop.

The counterpart of calibr8_tpu's solve/primal.py (reference
Primal::solve_at_step over steps, primal.cpp, main_primal.cpp:221-244).
Stores the per-step trajectory (x, xi, path), which the adjoint sweep
(solve/adjoint.py) consumes backwards.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class TimeGrid:
    """Uniform grid from 'num steps' + 'step size', or explicit times
    (reference: disc.cpp:24-26, 136-140; step 0 is the initial state)."""

    times: np.ndarray  # (n_steps + 1,), times[0] = t0

    @classmethod
    def uniform(cls, num_steps: int, step_size: float, t0: float = 0.0):
        return cls(times=t0 + step_size * np.arange(num_steps + 1))

    @property
    def num_steps(self) -> int:
        return len(self.times) - 1

    def time(self, step: int) -> float:
        return float(self.times[step])

    def dt(self, step: int) -> float:
        return float(self.times[step] - self.times[step - 1])

    @property
    def total_time(self) -> float:
        return float(self.times[-1] - self.times[0])


@dataclass
class Trajectory:
    """Per-step primal history (index 0 = initial condition)."""

    x: list
    xi: list
    path: list
    qoi_values: list  # per-step QoI contributions (steps 1..n)
    newton_info: list = field(default_factory=list)  # per step

    @property
    def J(self) -> float:
        return float(np.sum(self.qoi_values))


class Primal:
    def __init__(self, disc, assembler, step_solver, dbcs, tbcs, qoi, time_grid):
        self.disc = disc
        self.assembler = assembler
        self.step_solver = step_solver
        self.dbcs = dbcs
        self.tbcs = tbcs
        self.qoi = qoi
        self.time_grid = time_grid

    def initial_state(self):
        disc = self.disc
        x0 = disc.zero_x()
        init = torch.as_tensor(self.assembler.model.init_xi(), dtype=disc.dtype, device=disc.device)
        xi0 = init[None, :].repeat(disc.n_elem, 1)
        path0 = torch.zeros(disc.n_elem, dtype=torch.int32, device=disc.device)
        return x0, xi0, path0

    def run(self, params_all) -> Trajectory:
        tg = self.time_grid
        x, xi, path = self.initial_state()
        traj = Trajectory(x=[x], xi=[xi], path=[path], qoi_values=[])
        for step in range(1, tg.num_steps + 1):
            t = tg.time(step)
            bc_dofs, bc_vals = self.dbcs.arrays(t, step)
            ext = self.tbcs.array(t) if self.tbcs is not None else self.disc.zero_x()
            x_new, xi_new, path_new, info = self.step_solver.solve_at_step(
                x, x, xi, params_all, bc_dofs, bc_vals, ext, step=step
            )
            J_step = 0.0
            if self.qoi is not None:
                aux = self.qoi.setup_step(step, t, tg.dt(step), tg.total_time)
                J_step = float(self.qoi.evaluate(x_new, x, xi_new, params_all, aux))
            traj.x.append(x_new)
            traj.xi.append(xi_new)
            traj.path.append(path_new)
            traj.qoi_values.append(J_step)
            traj.newton_info.append(info)
            x, xi, path = x_new, xi_new, path_new
        return traj
