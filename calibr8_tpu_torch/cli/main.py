"""Command-line driver.

Usage: python -m calibr8_tpu_torch <command> <deck.yaml> [--device cuda|cpu] [options]

  primal     forward solve + QoI + regression check (reference
             main_primal.cpp); prints `J:` and, when the deck has a
             `regression` sublist, the regression summary, and exits 1 on
             FAIL.  With `problem: write synthetic: true` the per-step
             displacements are written as measured_<step> fields to
             <problem name>_synthetic.npz (io/synthetic.py).
  inverse    calibration over the `inverse` sublist's objective (reference
             main_inverse.cpp): with `check gradient: true` the adjoint
             gradient is held against finite differences and
             `gradient check: log10 error drop = ...` printed, with the
             `log10 drop expected` / `log10 drop tolerance` regression;
             with `iteration limit` > 0 (or no check) scipy L-BFGS-B, or
             trust-constr with --trust_region, writes the calibrated
             parameters to --out (default calibrated_params.txt).
  objective  one objective value and gradient at the deck's parameters,
             written to objective.dat and gradient.dat
             (main_objective.cpp); for the value-only FEMU objective,
             objective.dat alone.
  perturb    seeded Gaussian noise on the measured fields of an .npz
             (perturber.cpp).

A deck's `discretization: fields file` loads measured fields from such
an .npz.  The other subcommands of calibr8_tpu come with later slices.
The solves run on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load_problem(deck_path, device):
    """The deck's Problem, with the measured fields of its `fields file`
    loaded onto the mesh."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.io.synthetic import load_fields
    from calibr8_tpu_torch.problem import Problem

    spec = load_deck(deck_path)
    prob = Problem(spec, device=device)
    fields = spec.disc.get("fields file")
    if fields:
        load_fields(prob.mesh, fields)
    return spec, prob


def cmd_primal(args) -> int:
    from calibr8_tpu_torch.utils import timers

    spec, prob = _load_problem(args.deck, args.device)
    timers.reset()
    with timers.phase("primal/total", prob.device):
        traj = prob.solve_primal()
    J = traj.J
    print(f"J: {J:.16e}")
    if args.timers or spec.sub("problem").get("print timers", False):
        timers.report()
    if spec.regression:
        expected = float(spec.regression["QoI"])
        tol = float(spec.regression.get("relative error tol", 1e-6))
        err = abs(J - expected) / abs(expected)
        print("------ regression summary -----")
        print(f"J computed: {J:.17e}")
        print(f"J expected: {expected:.17e}")
        print(f"relative error: {err:.17e}")
        print(" PASS" if err < tol else " FAIL")
        print("-------------------------------")
        if err >= tol:
            return 1
    if spec.sub("problem").get("write synthetic", False):
        from calibr8_tpu_torch.io.synthetic import attach_synthetic, save_fields

        attach_synthetic(prob.mesh, prob.disc, traj)
        out = spec.problem_name + "_synthetic.npz"
        save_fields(prob.mesh, out)
        print(f"synthetic fields written: {out}")
    return 0


def _build_objective(spec, prob):
    """The objective of the `inverse` sublist on prob (calibr8_tpu
    cli/main.py:109-179, the objective types ported so far)."""
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective, FEMUObjective
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg

    inverse = spec.inverse
    active = ActiveParams.from_inverse_spec(inverse, prob.disc.elem_set_names,
                                            prob.model.param_names)
    obj_type = inverse.get("objective type", "pdeco")
    if obj_type in ("pdeco", "adjoint"):
        # the default LinearCfg with the problem's multigrid, as calibr8_tpu's
        # CLI builds it (cli/main.py:118-122)
        adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg(),
                      mg_factory=prob.mg_factory)
        return AdjointObjective(prob, adj, active), active
    if obj_type == "FEMU":
        # value only: the optimizer finite-differences it
        return FEMUObjective(prob, active), active
    raise NotImplementedError(
        f"objective type {obj_type!r} is not ported yet (the port has pdeco, adjoint and FEMU; "
        "VFM, EUCLID and the equilibrium gap are ROADMAP.md queue 1, 'VFM / EUCLID')"
    )


def _build_multi_problem(spec, device):
    """A `problems:` deck: one Problem and objective per sub-deck, summed;
    the shared `inverse:` sublist defines the common active set."""
    from calibr8_tpu_torch.deck import ProblemSpec
    from calibr8_tpu_torch.opt.objective import MultiProblemObjective
    from calibr8_tpu_torch.problem import Problem

    objs, active, prob0 = [], None, None
    for key in sorted(spec.sub("problems")):
        sub = dict(spec.sub("problems")[key])
        sub.setdefault("inverse", spec.sub("inverse"))
        subspec = ProblemSpec(sub)
        prob = Problem(subspec, device=device)
        prob0 = prob0 or prob
        obj, a = _build_objective(subspec, prob)
        active = active or a
        objs.append(obj)
    if not objs:
        raise ValueError("empty 'problems' sublist")
    return MultiProblemObjective(objs, active), active, prob0


def cmd_inverse(args) -> int:
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.opt.drivers import run_inverse
    from calibr8_tpu_torch.opt.objective import fd_gradient_check

    spec = load_deck(args.deck)
    if spec.sub("problems"):
        obj, active, prob = _build_multi_problem(spec, args.device)
    else:
        spec, prob = _load_problem(args.deck, args.device)
        obj, active = _build_objective(spec, prob)
    inverse = spec.inverse
    x0 = active.to_canonical(active.extract(prob.params0))

    if inverse.get("check gradient", False):
        g = obj.gradient(x0)
        drop, _ = fd_gradient_check(obj.value, g, x0)
        print(f"gradient check: log10 error drop = {drop:.10f}")
        # 2prob-style decks nest the regression under `inverse:`
        reg = spec.regression or inverse.get("regression", {})
        if "log10 drop expected" in reg:
            expected = float(reg["log10 drop expected"])
            tol = float(reg.get("log10 drop tolerance", 1e-1))
            ok = abs(drop - expected) < tol
            print("------ regression summary -----")
            print(f"drop computed: {drop:.10f}  expected: {expected:.10f}")
            print(" PASS" if ok else " FAIL")
            if not ok:
                return 1
        if int(inverse.get("iteration limit", 0)) == 0:
            return 0

    res = run_inverse(
        obj, active, x0=x0, method="trust-constr" if args.trust_region else "L-BFGS-B",
        gtol=float(inverse.get("gradient tolerance", 1e-8)),
        max_iters=int(inverse.get("iteration limit", 150)),
        out_file=args.out or "calibrated_params.txt",
    )
    print(f"optimization done: J = {res.J:.6e}, evals = {res.n_evals}, "
          f"failed forward solves = {res.n_failed}")
    for name, val in zip(res.names, res.params):
        print(f"  {name}: {val:.12e}")
    return 0


def cmd_objective(args) -> int:
    spec, prob = _load_problem(args.deck, args.device)
    obj, active = _build_objective(spec, prob)
    x0 = active.to_canonical(active.extract(prob.params0))
    if not hasattr(obj, "value_and_gradient"):
        # FEMU: value only, so objective.dat alone
        J = obj.value(x0)
        with open("objective.dat", "w") as f:
            f.write(f"{J:.17e}\n")
        print(f"objective: {J:.16e} (value-only objective: no gradient.dat)")
        return 0
    J, g = obj.value_and_gradient(x0)
    with open("objective.dat", "w") as f:
        f.write(f"{J:.17e}\n")
    with open("gradient.dat", "w") as f:
        f.write(" ".join(f"{v:.17e}" for v in np.asarray(g)) + "\n")
    print(f"objective: {J:.16e}")
    return 0


def cmd_perturb(args) -> int:
    from calibr8_tpu_torch.io.synthetic import perturb_fields

    with np.load(args.fields) as f:
        data = {k: f[k] for k in f.files}
    perturb_fields(data, args.sigma, args.seed)
    np.savez_compressed(args.out, **data)
    print(f"perturbed fields written: {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="calibr8_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("primal")
    sp.add_argument("deck")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.add_argument("--timers", action="store_true", help="print per-phase timers")
    sp.set_defaults(fn=cmd_primal)
    sp = sub.add_parser("inverse")
    sp.add_argument("deck")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.add_argument("--trust_region", action="store_true", help="scipy trust-constr")
    sp.add_argument("--out", help="calibrated parameters (default calibrated_params.txt)")
    sp.set_defaults(fn=cmd_inverse)
    sp = sub.add_parser("objective")
    sp.add_argument("deck")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_objective)
    sp = sub.add_parser("perturb")
    sp.add_argument("fields")
    sp.add_argument("--sigma", type=float, default=1e-5)
    sp.add_argument("--seed", type=int, default=22)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_perturb)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
