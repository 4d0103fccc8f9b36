"""Where the time of one primal load step goes, on the card.

    python -m calibr8_tpu_torch.profile_primal [--operator auto|ebe]

Builds the bench deck (cube n=32, small_J2, mixed u/p, 2 load steps,
float64, GMRES + block Gauss-Seidel with the ELL or the EBE Krylov
operator), solves load step 1 unprofiled (warm-up),
then load step 2 twice from the same state: once plain, for its wall
time and phase timers, once under torch.profiler, for the card's busy
time (the sum of its kernel, memcpy and memset intervals in the trace:
one stream, so they do not overlap) and the device time by kernel name.
Prints one JSON line with those, the idle share 1 - busy / plain wall,
and the profiled wall (the profiler's own cost shows as the difference).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.utils import timers


def bench_deck(n: int) -> dict:
    """bench.py:106-147's deck (build_problem(n, "f64"))."""
    return {
        "discretization": {"builtin mesh": {"type": "cube", "n": n}, "num steps": 2,
                           "step size": 1.0},
        "residuals": {
            "global residual": {"type": "mechanics"},
            "local residual": {
                "type": "small_J2",
                "nonlinear max iters": 30,
                "nonlinear absolute tol": 1e-12,
                "nonlinear relative tol": 1e-12,
                "materials": {"body": {"E": 1000.0, "nu": 0.25, "K": 100.0, "Y": 10.0,
                                       "cte": 0.0, "delta_T": 0.0}},
            },
        },
        "dirichlet bcs": {"expression": {
            "bc 1": [0, 0, "xmin", "0.0"],
            "bc 2": [0, 1, "ymin", "0.0"],
            "bc 3": [0, 2, "zmin", "0.0"],
            "bc 4": [0, 1, "ymax", "0.02 * t"],
        }},
        "quantity of interest": {"type": "average displacement"},
    }


def device_intervals(trace_path: str):
    """(sum of device intervals in ms, {name: ms}) from a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_name = defaultdict(float)
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name[ev["name"]] += ev["dur"] / 1e3
    return sum(by_name.values()), dict(by_name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--operator", default="auto", choices=("auto", "ebe"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_primal: no CUDA device")

    prob = Problem(load_deck(bench_deck(32)))
    solver = prob.step_solver
    solver.cfg.linear = dataclasses.replace(solver.cfg.linear, operator=args.operator)
    primal = prob.primal
    x, xi, _ = primal.initial_state()

    def step(k, x, xi):
        t = primal.time_grid.time(k)
        bc_dofs, bc_vals = prob.dbcs.arrays(t, k)
        return solver.solve_at_step(x, x, xi, prob.params0, bc_dofs, bc_vals,
                                    prob.disc.zero_x(), step=k)

    x, xi, _, _ = step(1, x, xi)
    torch.cuda.synchronize()
    timers.reset()
    t0 = time.perf_counter()
    _, _, _, info = step(2, x, xi)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    phases = {k: v["total"] * 1e3 for k, v in timers.summary().items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(2, x, xi)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        busy_ms, by_name = device_intervals(path)
    finally:
        os.remove(path)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps(dict(
        profile="primal load step 2", n=32, operator=args.operator, dtype="float64",
        device=torch.cuda.get_device_name(0), newton_iterations=info["iterations"] - 1,
        krylov_iterations=info["krylov_iters"], wall_ms=wall_ms,
        profiled_wall_ms=prof_wall_ms, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, phases_ms=phases,
        device_ms_by_kernel=dict(top),
    )))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
