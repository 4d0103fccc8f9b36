#!/usr/bin/env python3
"""calibr8_tpu's (JAX, CPU, float64) references for chip_smoke.py's
full-width decks: the values chip_smoke.py holds the port to.

    JAX_PLATFORMS=cpu python3 chip_reference.py [plane_stress] [hill] [hyper_plane_stress]
                                                [barlat] [hypo_hosford8] [iso] [hybrid]
    JAX_PLATFORMS=cpu python3 chip_reference.py adjoint DIR [bench] [hill] [hyper] [hypo] [hosford]
                                                            [iso]
    python3 chip_reference.py sweep DIR [bench] [hill] [hyper] [hypo]
    JAX_PLATFORMS=cpu python3 chip_reference.py mg DIR [cube] [cube_step] [notch] [adjoint] [hypo_notch]
                                                       [hybrid_adjoint]
    python3 chip_reference.py fd cuda|cpu [test] [twin] [test1] [twin1]
    JAX_PLATFORMS=cpu python3 chip_reference.py dist
    python3 chip_reference.py dist_tol [bench] [hyper]
    JAX_PLATFORMS=cpu python3 chip_reference.py femu [DIR]
    JAX_PLATFORMS=cpu python3 chip_reference.py amg DIR [bench] [plane_stress] [bench16]
    JAX_PLATFORMS=cpu python3 chip_reference.py jitted [DIR]
    JAX_PLATFORMS=cpu python3 chip_reference.py jitted_host

The first form runs each named deck (the first three by default; the
eigensolver decks chip_smoke.eig_deck("hypo_barlat", 32) and
eig_deck("hypo_hosford", 8), iso_deck(32) and hybrid_deck(0.004) by
name) through
calibr8_tpu's Problem(...).solve_primal() and prints one JSON line per
deck with J, the per-step contributions and the wall time.

The second runs calibr8_tpu's AdjointObjective.gradient (the CLI's
`pdeco` objective: default LinearCfg, tightened by Adjoint) on each named
full-width adjoint deck of chip_smoke.py (chip_smoke.adjoint_deck; bench,
hill and hyper by default) at the deck's own parameters, and prints one JSON line per deck
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
and dJ/dp of adjoint_deck("mg") with Adjoint(mg_factory=...); the first
four by default; `hypo_notch` is hypo_mg_notch_deck, `hybrid_adjoint` dJ/dp
of adjoint_deck("hybrid", on hybrid_mg_deck) the same way), and prints one
JSON line per deck (also written to
DIR/mg_ref_<name>.json) with J or the gradient, the Newton iterations of
each load step, the Krylov iterations and relative residual of every
linear solve (transposed ones for the adjoint) and the wall times.  It
counts the solves by wrapping calibr8_tpu.solve.linear.solve_info from
outside (return_iters), and runs the adjoint step unjitted so that the
counts are concrete.  Run the names as parallel processes to save wall
time.

The fifth runs the port's finite-difference check of the hybrid (the
port only, no JAX; on the card with PyTorch's deterministic algorithms,
as chip_smoke.py's phase 5a) and prints one JSON line per deck variant
with the error of every quotient, the log10 drop, and the drop without a
lucky quotient, log10(max(err(1), err(0.1)) / (2 sqrt(noise c))), c =
err(1e-3) / 1e-3 the curvature term's slope and noise the median of
err(h) h over h = 1e-8 .. 1e-10 (J's rounding): `test` sweeps Y, nn_0,
nn_1 ranges and pulls on tests/test_nn_models.py's deck (11 steps, as
phase 5a), `twin` the ranges on the twin case (hybrid_twin_deck, 13
steps, as the CLI); `test1` and `twin1` are the first deck at its
test's ranges and the second as chip_smoke.py holds it.

The sixth runs calibr8_tpu on chip_smoke.dist_adjoint_deck(), its large
domain-decomposed test deck (notch2D h=0.0145, small_J2, GMRES at 1e-13):
the single-device J and dJ/dp (its Adjoint with the deck's linear
settings), then its DistPrimal / DistAdjoint at 8 parts on 8 host
devices, and prints one JSON line with both and their difference; the
first pair is chip_smoke.py's J_REF_DIST / G_REF_DIST.  It fits this
size of deck on a CPU of a few cores.

The seventh, the port only on the card, tabulates J of the full-width
bench and hyper decks at the deck's Newton tolerance and converged to an
absolute 1e-9 .. 1e-11, through the single-device path and DistPrimal at
8 parts: at the deck's tolerance the two paths' J differ by the Newton
tolerance's reach, converged they agree (chip_smoke.py's
converged_deck).

The eighth runs calibr8_tpu's FEMU pipeline on chip_smoke.py's phase
5h(a) decks (chip_smoke.femu_full_decks: notch2D h=0.032 refined 3 times,
small_hill_plane_stress, GMRES with the geometric multigrid): the forward
solve at the truth, whose `reaction mismatch` QoI writes load.dat, then
attach_synthetic, then its calibration QoI's AdjointObjective (the CLI's
default LinearCfg with the problem's multigrid) at the start point, and
prints one JSON line (also written to DIR/femu_ref.json when DIR is
given) with J and the canonical dJ/d(Y, D), chip_smoke.py's J_REF_FEMU /
G_REF_FEMU, the synthetic loads, Newton counts and wall times; a failed
solve is recorded in the line (`error`).

The ninth is the fourth on chip_smoke.py's aggregation-AMG decks:
`bench`, dJ/dp of adjoint_deck("amg") (the bench deck, cube n=32, with
`preconditioner: amg`) and its J; `plane_stress`, J of
amg_plane_stress_deck() (notch2D h=0.004 with `multigrid` on the
unrefined mesh); `bench16`, the first at cube n=16, by name only.  The
lines are written to DIR/mg_ref_amg_<name>.json; chip_smoke.py's
J_REF_AMG, G_REF_AMG and J_REF_AMG_PLANE_STRESS.  calibr8_tpu's smoothers
run there on the port's number of power iterations for lmax
(calibr8_tpu_torch.solve.amg.LMAX_ITERS): with its own 10, GMRES stalls
on these decks (relres 0.79 and 0.82 on the first solve) and its Newton
raises.

The tenth runs calibr8_tpu's bench.py calibration at its default n=10
(chip_smoke.jit_bench_decks: notch2D h=0.01, small_hill_plane_stress,
`solver: jitted`): the synthetic primal through its JitStepSolver, whose
`reaction mismatch` QoI writes load.dat, attach_synthetic, then the
calibration QoI's AdjointObjective (default LinearCfg) at Y 2.5, D 2.8
and run_inverse (L-BFGS-B, 60 iterations, gtol 1e-12) over Y and D, and
prints one JSON line (also DIR/jit_ref.json) with the synthetic J, J and
the canonical dJ/d(Y, D) at the start, the recovered Y and D and the
evaluation count: chip_smoke.py's J_REF_JIT, J_REF_JIT_START, G_REF_JIT
and CAL_REF_JIT (~15 min).  The eleventh runs the same synthetic deck
without `solver` through calibr8_tpu's host StepSolver and prints its J,
chip_smoke.py's J_REF_JIT_HOST.

The first, second, fourth, sixth, eighth, ninth, tenth and eleventh need JAX and the calibr8_tpu package; chip_smoke.py itself
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
AMG_DECKS = ("bench", "plane_stress")
# the adjoint forms of `mg` / `amg` -> chip_smoke.adjoint_deck's name
ADJOINT_MG = {"adjoint": "mg", "hybrid_adjoint": "hybrid", "amg_bench": "amg",
              "amg_bench16": "amg"}


def primal_references(names, chip_smoke) -> None:
    import jax

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.problem import Problem

    decks = {"plane_stress": ("J_REF_PLANE_STRESS_H004", chip_smoke.plane_stress_deck(0.004)),
             "hill": ("J_REF_HILL_N32", chip_smoke.hill_deck(32)),
             "hyper_plane_stress": ("J_REF_HYPER_PLANE_STRESS_H004",
                                    chip_smoke.hyper_plane_stress_deck(0.004)),
             "barlat": ("J_REF_BARLAT_N32", chip_smoke.eig_deck("hypo_barlat", 32)),
             "hypo_hosford8": ("J_REF_HYPO_HOSFORD_N8", chip_smoke.eig_deck("hypo_hosford", 8)),
             "iso": ("J_REF_ISO_N32", chip_smoke.iso_deck(32)),
             "hybrid": ("J_REF_HYBRID_H004", chip_smoke.hybrid_deck(0.004))}
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
        const = {"bench": "G_REF_N32", "hill": "G_REF_HILL_N32", "hyper": "G_REF_HYPER",
                 "hypo": "G_REF_HYPO", "hosford": "G_REF_HOSFORD", "iso": "G_REF_ISO"}[name]
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
        if name in ADJOINT_MG:
            deck = chip_smoke.adjoint_deck(ADJOINT_MG[name])
            if name == "amg_bench16":
                deck["discretization"]["builtin mesh"]["n"] = 16
            spec = load_deck(deck)
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
                    "notch": chip_smoke.mg_notch_deck,
                    "hypo_notch": chip_smoke.hypo_mg_notch_deck,
                    "amg_plane_stress": chip_smoke.amg_plane_stress_deck}[name]()
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


def fd_tables(device, names, chip_smoke) -> None:
    import itertools

    import numpy as np
    import torch

    from calibr8_tpu_torch.opt.objective import fd_gradient_check

    chip_smoke.DEVICE = device
    cs = chip_smoke

    def test_deck(Y, nn, pull):
        deck = cs._deck({"type": "notch2D", "h": 0.2}, "hybrid_hyper_J2_plane_stress",
                        {"E": 1000.0, "nu": 0.25, "Y": 2.0}, cs.bcs_2d(pull), 3,
                        gtype="mechanics_plane_stress")
        deck["residuals"]["global residual"]["nonlinear max iters"] = 30
        deck["residuals"]["local residual"]["embedded model"] = copy.deepcopy(cs.HYBRID_NET)
        deck["inverse"] = {"materials": {"body": {"Y": list(Y), "nn_0": [-nn, nn],
                                                  "nn_1": [-nn, nn]}}}
        return deck

    def twin_deck(Y, nn):
        deck = cs.hybrid_twin_deck()
        deck["inverse"] = {"materials": {"body": {"Y": list(Y), "nn_0": [-nn, nn],
                                                  "nn_1": [-nn, nn]}}}
        return deck

    runs = []
    for name in names:
        if name == "test":
            runs += [(f"test Y{list(Y)} nn+-{nn} pull {pull}", test_deck(Y, nn, pull), 11)
                     for Y, nn, pull in itertools.product(
                         [(1.0, 3.0), (0.5, 3.5), (1.5, 2.5), (1.8, 2.2)], [1.0, 2.0, 3.0],
                         [0.0045, 0.005, 0.0055])]
        elif name == "twin":
            runs += [(f"twin Y{list(Y)} nn+-{nn}", twin_deck(Y, nn), 13)
                     for Y, nn in itertools.product(
                         [(8.0, 12.0), (5.0, 15.0), (9.0, 11.0), (2.0, 18.0)], [1.0, 2.0, 3.0])]
        elif name == "test1":
            runs.append(("test1", test_deck((1.0, 3.0), 2.0, 0.005), 11))
        else:
            runs.append(("twin1", cs.hybrid_twin_deck(), 13))
    for label, deck, n in runs:
        t0 = time.perf_counter()
        rec = dict(fd=label, device=device, steps=n)
        torch.use_deterministic_algorithms(device != "cpu", warn_only=True)
        try:
            _, _, obj, x0 = cs.adjoint_objective(deck)
            g = obj.gradient(x0)
            drop, errs = fd_gradient_check(obj.value, g, x0, num_steps=n)
            c = errs[3] / 1e-3
            noise = float(np.median([errs[k] * 10.0 ** -k for k in (8, 9, 10)]))
            rec.update(drop=float(drop), errors=[float(e) for e in errs], c=c, noise=noise,
                       drop_without_luck=float(np.log10(max(errs[0], errs[1])
                                                        / (2.0 * np.sqrt(noise * c)))))
        except Exception as exc:  # noqa: BLE001 - a variant whose primal stops is recorded
            rec["error"] = repr(exc)[:200]
        finally:
            torch.use_deterministic_algorithms(False)
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)


def dist_references(chip_smoke) -> None:
    """calibr8_tpu's single-device primal and adjoint on
    chip_smoke.dist_adjoint_deck() (its own Adjoint with the deck's linear
    settings, as tests/test_dist.py:154-188 holds it), then its DistPrimal
    / DistAdjoint at 8 parts on the 8 host devices; one JSON line."""
    import jax
    import numpy as np

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.parallel.dist import DistAdjoint, DistContext, DistPrimal
    from calibr8_tpu.problem import Problem
    from calibr8_tpu.solve.adjoint import Adjoint

    prob = Problem(load_deck(chip_smoke.dist_adjoint_deck()))
    t0 = time.perf_counter()
    traj = prob.solve_primal()
    primal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, prob.step_solver.cfg.linear)
    g0 = np.asarray(adj.sweep(traj, prob.params0, prob.time_grid)[0], dtype=np.float64)
    adjoint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = DistContext(prob, n_parts=8)
    traj1 = DistPrimal(ctx).run()
    g1 = np.asarray(DistAdjoint(ctx).sweep(traj1, prob.params0, prob.time_grid)[0],
                    dtype=np.float64)
    dist_s = time.perf_counter() - t0
    scale = float(np.abs(g0).max())
    print(json.dumps(dict(
        reference="J_REF_DIST / G_REF_DIST", n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs,
        J=float(traj.J), grad=g0.tolist(), names=list(prob.model.param_names),
        dist_J=float(np.sum(traj1["qoi_values"])), dist_grad=g1.tolist(),
        dist_grad_err=float(np.abs(g1 - g0).max()) / scale, primal_s=primal_s,
        adjoint_s=adjoint_s, dist_s=dist_s, jax=jax.__version__, cpus=os.cpu_count(),
    )), flush=True)


def dist_tolerance_table(names, chip_smoke) -> None:
    """The port only, on the card: the full-width decks (bench, hyper) at
    the deck's Newton tolerance and converged to an absolute 1e-9, 1e-10
    and 1e-11 (relative test off), each through the single-device
    Problem.solve_primal and through DistPrimal at 8 parts; one JSON line
    per run with J against calibr8_tpu's J_REF_*, the Newton and Krylov
    counts, each linear solve's relative residual and each step's final
    ||R||."""
    import copy as _copy

    import numpy as np
    import torch

    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.mesh import generators
    from calibr8_tpu_torch.parallel.dist import DistContext, DistPrimal
    from calibr8_tpu_torch.problem import Problem

    mesh = generators.cube(32)
    decks = {"bench": (chip_smoke.bench_deck_32(), chip_smoke.J_REF_N32),
             "hyper": (chip_smoke.hyper_deck(32), chip_smoke.J_REF_HYPER_N32)}
    for name in names:
        base, ref = decks[name]
        for abs_tol in (None, 1e-9, 1e-10, 1e-11):
            deck = _copy.deepcopy(base)
            if abs_tol is not None:
                gr = deck["residuals"]["global residual"]
                gr.update({"nonlinear absolute tol": abs_tol, "nonlinear relative tol": 1e-14,
                           "nonlinear max iters": 40})
            for parts in (None, 8):
                prob = Problem(load_deck(_copy.deepcopy(deck)), mesh=mesh, device="cuda",
                               dtype=torch.float64)
                t0 = time.perf_counter()
                if parts is None:
                    traj = prob.solve_primal()
                    J, info = traj.J, traj.newton_info
                else:
                    traj = DistPrimal(DistContext(prob, n_parts=parts)).run()
                    J, info = float(np.sum(traj["qoi_values"])), traj["newton_info"]
                torch.cuda.synchronize()
                print(json.dumps(dict(
                    deck=name, newton_abs_tol=abs_tol, parts=parts, J=J, J_ref=ref,
                    rel_err=abs(J - ref) / ref, newton=[i["iterations"] - 1 for i in info],
                    krylov=[i["krylov_iters"] for i in info],
                    relres=[i["linear_relres"] for i in info],
                    resid_norm=[i["resid_norm"] for i in info],
                    seconds=time.perf_counter() - t0)), flush=True)


def femu_reference(chip_smoke, out_dir=None) -> None:
    import tempfile

    import jax
    import numpy as np

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.io.synthetic import attach_synthetic
    from calibr8_tpu.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu.problem import Problem, build_mesh
    from calibr8_tpu.solve.adjoint import Adjoint
    from calibr8_tpu.solve.linear import LinearCfg

    rec = dict(reference="J_REF_FEMU / G_REF_FEMU", jax=jax.__version__, cpus=os.cpu_count())
    with tempfile.TemporaryDirectory() as tmp:
        load_file = os.path.join(tmp, "load.dat")
        syn_deck, cal_deck = chip_smoke.femu_full_decks(load_file)
        rec["pull"] = syn_deck["dirichlet bcs"]["expression"]["bc 3"][3]
        t0 = time.perf_counter()
        try:
            mesh = build_mesh(load_deck(copy.deepcopy(syn_deck)))
            syn = Problem(load_deck(syn_deck), mesh=mesh)
            traj = syn.solve_primal()
            rec["synthetic_s"] = time.perf_counter() - t0
            attach_synthetic(mesh, syn.disc, traj)
            with open(load_file) as f:
                rec["loads"] = [float(v) for v in f.read().split()]
            cal = Problem(load_deck(cal_deck), mesh=mesh)
            rec.update(n_elem=int(cal.disc.n_elem), n_dofs=int(cal.disc.n_dofs))
            adj = Adjoint(cal.assembler, cal.qoi, cal.dbcs, LinearCfg(),
                          mg_factory=cal.mg_factory)
            active = ActiveParams.from_inverse_spec(chip_smoke.FEMU_FULL_ACTIVE,
                                                    cal.disc.elem_set_names,
                                                    cal.model.param_names)
            obj = AdjointObjective(cal, adj, active)
            x0 = active.to_canonical(active.extract(np.asarray(cal.params0)))
            t0 = time.perf_counter()
            rec["J"] = float(obj.value(x0))
            rec["primal_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rec["grad"] = [float(v) for v in np.asarray(obj.gradient(x0), dtype=np.float64)]
            rec.update(names=active.names, adjoint_s=time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 - record the failure in the line
            rec.update(error=repr(exc), seconds=time.perf_counter() - t0)
    line = json.dumps(rec)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "femu_ref.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def jitted_reference(chip_smoke, out_dir=None) -> None:
    import tempfile

    import jax
    import numpy as np

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.io.synthetic import attach_synthetic
    from calibr8_tpu.opt.drivers import run_inverse
    from calibr8_tpu.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu.problem import Problem
    from calibr8_tpu.solve.adjoint import Adjoint
    from calibr8_tpu.solve.jit_newton import JitStepSolver
    from calibr8_tpu.solve.linear import LinearCfg

    rec = dict(reference="J_REF_JIT / J_REF_JIT_START / G_REF_JIT / CAL_REF_JIT",
               jax=jax.__version__, cpus=os.cpu_count())
    with tempfile.TemporaryDirectory() as tmp:
        load_file = os.path.join(tmp, "load.dat")
        syn_deck, cal_deck = chip_smoke.jit_bench_decks(load_file)
        t0 = time.perf_counter()
        try:
            syn = Problem(load_deck(syn_deck))
            assert isinstance(syn.step_solver, JitStepSolver)
            traj = syn.solve_primal()
            rec.update(J_synthetic=float(traj.J), J_steps=[float(v) for v in traj.qoi_values],
                       synthetic_s=time.perf_counter() - t0)
            attach_synthetic(syn.mesh, syn.disc, traj)
            cal = Problem(load_deck(cal_deck), mesh=syn.mesh)
            rec.update(n_elem=int(cal.disc.n_elem), n_dofs=int(cal.disc.n_dofs))
            adj = Adjoint(cal.assembler, cal.qoi, cal.dbcs, LinearCfg())
            active = ActiveParams.from_inverse_spec(chip_smoke.FEMU_FULL_ACTIVE,
                                                    cal.disc.elem_set_names,
                                                    cal.model.param_names)
            obj = AdjointObjective(cal, adj, active)
            x0 = active.to_canonical(active.extract(cal.params0))
            t0 = time.perf_counter()
            rec["J_start"] = float(obj.value(x0))
            rec["grad_start"] = dict(zip(active.names, (
                float(v) for v in np.asarray(obj.gradient(x0), dtype=np.float64))))
            rec["start_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = run_inverse(obj, active, x0=x0, max_iters=60, gtol=1e-12)
            rec.update(recovered={n.split("/")[-1]: float(v) for n, v in zip(res.names,
                                                                              res.params)},
                       evaluations=int(res.n_evals), failed=int(getattr(res, "n_failed", 0)),
                       J_final=float(res.J), message=str(res.message),
                       calibration_s=time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 - record the failure in the line
            rec.update(error=repr(exc), seconds=time.perf_counter() - t0)
    line = json.dumps(rec)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "jit_ref.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def jitted_host_reference(chip_smoke) -> None:
    import tempfile

    import jax

    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.problem import Problem
    from calibr8_tpu.solve.newton import StepSolver

    with tempfile.TemporaryDirectory() as tmp:
        syn_deck, _ = chip_smoke.jit_bench_decks(os.path.join(tmp, "load.dat"), solver=None)
        t0 = time.perf_counter()
        prob = Problem(load_deck(syn_deck))
        assert isinstance(prob.step_solver, StepSolver)
        traj = prob.solve_primal()
    print(json.dumps(dict(reference="J_REF_JIT_HOST", J=float(traj.J),
                          J_steps=[float(v) for v in traj.qoi_values],
                          seconds=time.perf_counter() - t0, jax=jax.__version__,
                          cpus=os.cpu_count())), flush=True)


def main(argv) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    args = argv[1:]
    if args[:1] == ["sweep"]:
        import chip_smoke

        sweep_on_references(args[2:] or list(ADJOINT_DECKS), chip_smoke, args[1])
        return 0
    if args[:1] == ["fd"]:
        import chip_smoke

        fd_tables(args[1], args[2:] or ["test", "twin"], chip_smoke)
        return 0
    if args[:1] == ["dist_tol"]:
        import chip_smoke

        dist_tolerance_table(args[1:] or ["bench", "hyper"], chip_smoke)
        return 0
    if args[:1] == ["dist"]:
        # calibr8_tpu's DistContext takes one part per JAX device
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke

    if args[:1] == ["dist"]:
        dist_references(chip_smoke)
    elif args[:1] == ["adjoint"]:
        adjoint_references(args[2:] or list(ADJOINT_DECKS), chip_smoke, args[1])
    elif args[:1] == ["mg"]:
        mg_references(args[2:] or list(MG_DECKS), chip_smoke, args[1])
    elif args[:1] == ["amg"]:
        import functools

        from calibr8_tpu.solve import amg as jax_amg
        from calibr8_tpu_torch.solve.amg import LMAX_ITERS

        # the port's power iterations for the smoothers' lmax (calibr8_tpu's
        # 10 stall GMRES on these decks: ROADMAP.md queue 3)
        jax_amg._power_lmax = functools.partial(jax_amg._power_lmax, iters=LMAX_ITERS)
        mg_references(["amg_" + a for a in args[2:] or AMG_DECKS], chip_smoke, args[1])
    elif args[:1] == ["femu"]:
        femu_reference(chip_smoke, args[1] if len(args) > 1 else None)
    elif args[:1] == ["jitted"]:
        jitted_reference(chip_smoke, args[1] if len(args) > 1 else None)
    elif args[:1] == ["jitted_host"]:
        jitted_host_reference(chip_smoke)
    else:
        primal_references(args or list(DECKS), chip_smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
