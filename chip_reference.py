#!/usr/bin/env python3
"""calibr8_tpu's (JAX, CPU, float64) references for chip_smoke.py's
full-width decks: the values chip_smoke.py holds the port to.

    JAX_PLATFORMS=cpu python3 chip_reference.py [plane_stress] [hill] [hyper_plane_stress]
    JAX_PLATFORMS=cpu python3 chip_reference.py adjoint DIR [bench] [hill] [hyper]
    python3 chip_reference.py sweep DIR [bench] [hill] [hyper]
    JAX_PLATFORMS=cpu python3 chip_reference.py mg DIR [cube] [cube_step] [notch] [adjoint]

The first form runs each named deck (all by default) through
calibr8_tpu's Problem(...).solve_primal() and prints one JSON line per
deck with J, the per-step contributions and the wall time.

The second runs calibr8_tpu's AdjointObjective.gradient (the CLI's
`pdeco` objective: default LinearCfg, tightened by Adjoint) on each named
full-width adjoint deck of chip_smoke.py (chip_smoke.adjoint_deck, both by
default) at the deck's own parameters, and prints one JSON line per deck
with the canonical gradient, J, the adjoint's relative residual per step
and the wall times.  A relative residual above calibr8_tpu's
AdjointSolveError bound is recorded in the line (`solve_error`) instead
of ending the run, so that the gradient and trajectory are still saved.  The primal trajectory (x, xi, path of the load steps)
and the gradient go to DIR/adjoint_ref_<name>.npz, so that the
port's sweep can be run on calibr8_tpu's own trajectory.

The third runs that sweep: the port's Adjoint on the card, on the
trajectory saved in DIR/adjoint_ref_<name>.npz, and prints one JSON line
per deck with the canonical gradient against calibr8_tpu's.  It needs
the card and no JAX.

The fourth runs calibr8_tpu's geometric-multigrid decks of chip_smoke.py
(mg_cube_deck with `preconditioner reuse` none and step, mg_notch_deck,
and dJ/dp of adjoint_deck("mg") with Adjoint(mg_factory=...)), all by
default, and prints one JSON line per deck (also written to
DIR/mg_ref_<name>.json) with J or the gradient, the Newton iterations of
each load step, the Krylov iterations and relative residual of every
linear solve (transposed ones for the adjoint) and the wall times.  It
counts the solves by wrapping calibr8_tpu.solve.linear.solve_info from
outside (return_iters), and runs the adjoint step unjitted so that the
counts are concrete.  Run the names as parallel processes to save wall
time.

The first, second and fourth need JAX and the calibr8_tpu package; chip_smoke.py itself
imports neither.  Full-width decks are for a machine with the memory and the
minutes for them (the primal of one such deck took 400-800 s on an 8-core
CPU).
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

DECKS = ("plane_stress", "hill", "hyper_plane_stress")
ADJOINT_DECKS = ("bench", "hill", "hyper")
MG_DECKS = ("cube", "cube_step", "notch", "adjoint")


def primal_references(names, chip_smoke) -> None:
    import jax

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.problem import Problem

    decks = {"plane_stress": ("J_REF_PLANE_STRESS_H004", chip_smoke.plane_stress_deck(0.004)),
             "hill": ("J_REF_HILL_N32", chip_smoke.hill_deck(32)),
             "hyper_plane_stress": ("J_REF_HYPER_PLANE_STRESS_H004",
                                    chip_smoke.hyper_plane_stress_deck(0.004))}
    for name in names:
        const, deck = decks[name]
        t0 = time.perf_counter()
        try:
            traj = Problem(load_deck(copy.deepcopy(deck))).solve_primal()
        except Exception as exc:  # noqa: BLE001 - report, go on with the next deck
            print(json.dumps(dict(reference=const, error=repr(exc),
                                  seconds=time.perf_counter() - t0)), flush=True)
            continue
        print(json.dumps(dict(reference=const, J=traj.J, J_steps=[float(v) for v in traj.qoi_values],
                              seconds=time.perf_counter() - t0, jax=jax.__version__,
                              cpus=os.cpu_count())), flush=True)


def adjoint_references(names, chip_smoke, out_dir) -> None:
    import jax
    import numpy as np

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu.problem import Problem
    from calibr8_tpu.solve.adjoint import Adjoint
    from calibr8_tpu.solve.linear import LinearCfg

    for name in names:
        const = {"bench": "G_REF_N32", "hill": "G_REF_HILL_N32", "hyper": "G_REF_HYPER"}[name]
        t0 = time.perf_counter()
        spec = load_deck(chip_smoke.adjoint_deck(name))
        prob = Problem(spec)
        adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg())
        relres = {}
        check = adj._check_linear

        solve_error = []

        def record(rr, step, check=check, relres=relres, solve_error=solve_error):
            relres[int(step)] = float(rr)
            try:
                check(rr, step)
            except Exception as exc:  # noqa: BLE001 - recorded in the output line
                solve_error.append(repr(exc))

        adj._check_linear = record
        active = ActiveParams.from_inverse_spec(
            spec.inverse, prob.disc.elem_set_names, prob.model.param_names)
        obj = AdjointObjective(prob, adj, active)
        x0 = active.to_canonical(active.extract(np.asarray(prob.params0)))
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        J = obj.value(x0)
        primal_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g = np.asarray(obj.gradient(x0), dtype=np.float64)
        adjoint_s = time.perf_counter() - t0
        traj = obj._cache_traj
        n = len(traj.x)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"adjoint_ref_{name}.npz")
        np.savez_compressed(
            path, grad=g, x0=x0, names=np.asarray(active.names),
            x=np.stack([np.asarray(traj.x[k]) for k in range(1, n)]),
            xi=np.stack([np.asarray(traj.xi[k]) for k in range(1, n)]),
            path=np.stack([np.asarray(traj.path[k]) for k in range(1, n)]),
        )
        print(json.dumps(dict(reference=const, grad=[float(v) for v in g], names=active.names,
                              J=float(J), adjoint_relres=relres, solve_error=solve_error,
                              setup_s=setup_s,
                              primal_s=primal_s, adjoint_s=adjoint_s, saved=path,
                              jax=jax.__version__, cpus=os.cpu_count())), flush=True)


def sweep_on_references(names, chip_smoke, ref_dir) -> None:
    import numpy as np
    import torch

    from calibr8_tpu_torch.convert import trajectory_from_numpy
    from calibr8_tpu_torch.mesh import generators

    mesh = generators.cube(32)
    for name in names:
        z = np.load(os.path.join(ref_dir, f"adjoint_ref_{name}.npz"))
        prob, adj, obj, x0 = chip_smoke.adjoint_objective(chip_smoke.adjoint_deck(name), mesh=mesh)
        disc = prob.disc
        # step 0, the initial state: x = 0 and the model's initial xi in both packages
        traj = trajectory_from_numpy(
            [np.zeros(disc.n_dofs)] + list(z["x"]),
            [np.tile(prob.model.init_xi(), (disc.n_elem, 1))] + list(z["xi"]),
            [np.zeros(disc.n_elem, np.int32)] + list(z["path"]),
            device=disc.device,
        )
        params_all = obj._params_all(x0)
        t0 = time.perf_counter()
        grad_all, _ = adj.sweep(traj, params_all, prob.time_grid)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        g = obj.active.grad_to_canonical(obj.active.extract_grad(grad_all),
                                         obj.active.extract(params_all))
        ref = z["grad"]
        print(json.dumps(dict(sweep_on_reference_trajectory=name, names=obj.active.names,
                              grad=g.tolist(), grad_ref=ref.tolist(),
                              rel_err=float(np.abs(g - ref).max() / np.abs(ref).max()),
                              steps=adj.step_info, sweep_s=sweep_s,
                              device=torch.cuda.get_device_name(0))), flush=True)


def mg_references(names, chip_smoke, out_dir) -> None:
    import jax
    import numpy as np

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu.problem import Problem
    from calibr8_tpu.solve import linear as linear_mod
    from calibr8_tpu.solve.adjoint import Adjoint
    from calibr8_tpu.solve.linear import LinearCfg

    solves = []
    solve_info = linear_mod.solve_info

    def counted(*args, **kwargs):
        want = kwargs.get("return_iters", False)
        kwargs["return_iters"] = True
        x, rr, ki = solve_info(*args, **kwargs)
        solves.append(dict(krylov_iterations=int(ki), relres=float(rr),
                           transpose=bool(kwargs.get("transpose", False))))
        return (x, rr, ki) if want else (x, rr)

    linear_mod.solve_info = counted
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        solves.clear()
        t0 = time.perf_counter()
        rec = dict(reference=name, jax=jax.__version__, cpus=os.cpu_count())
        if name == "adjoint":
            spec = load_deck(chip_smoke.adjoint_deck("mg"))
            prob = Problem(spec)
            adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg(),
                          mg_factory=prob.mg_factory)
            adj._step = adj._step_impl
            active = ActiveParams.from_inverse_spec(
                spec.inverse, prob.disc.elem_set_names, prob.model.param_names)
            obj = AdjointObjective(prob, adj, active)
            x0 = active.to_canonical(active.extract(np.asarray(prob.params0)))
            rec["setup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec["J"] = float(obj.value(x0))
            rec["primal_s"] = time.perf_counter() - t0
            n_primal = len(solves)
            t0 = time.perf_counter()
            g = np.asarray(obj.gradient(x0), dtype=np.float64)
            rec["adjoint_s"] = time.perf_counter() - t0
            rec.update(grad=dict(zip(active.names, (float(v) for v in g))),
                       primal_solves=solves[:n_primal], adjoint_solves=solves[n_primal:])
        else:
            deck = {"cube": lambda: chip_smoke.mg_cube_deck("none"),
                    "cube_step": lambda: chip_smoke.mg_cube_deck("step"),
                    "notch": chip_smoke.mg_notch_deck}[name]()
            prob = Problem(load_deck(copy.deepcopy(deck)))
            steps = []
            solve_at_step = prob.step_solver.solve_at_step

            def per_step(*args, solve_at_step=solve_at_step, steps=steps, **kwargs):
                first = len(solves)
                out = solve_at_step(*args, **kwargs)
                steps.append(dict(newton_iterations=out[3]["iterations"] - 1,
                                  solves=solves[first:]))
                return out

            prob.step_solver.solve_at_step = per_step
            rec["setup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            traj = prob.solve_primal()
            rec.update(J=float(traj.J), J_steps=[float(v) for v in traj.qoi_values],
                       solve_s=time.perf_counter() - t0, n_elem=int(prob.disc.n_elem),
                       n_dofs=int(prob.disc.n_dofs), steps=steps)
        line = json.dumps(rec)
        with open(os.path.join(out_dir, f"mg_ref_{name}.json"), "w") as f:
            f.write(line + "\n")
        print(line, flush=True)


def main(argv) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    args = argv[1:]
    if args[:1] == ["sweep"]:
        import chip_smoke

        sweep_on_references(args[2:] or list(ADJOINT_DECKS), chip_smoke, args[1])
        return 0
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    if args[:1] == ["adjoint"]:
        adjoint_references(args[2:] or list(ADJOINT_DECKS), chip_smoke, args[1])
    elif args[:1] == ["mg"]:
        mg_references(args[2:] or list(MG_DECKS), chip_smoke, args[1])
    else:
        primal_references(args or list(DECKS), chip_smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
