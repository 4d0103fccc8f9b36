"""Command-line driver.

Usage: python -m calibr8_tpu_torch <command> <deck.yaml> [--device cuda|cpu] [--timers]

  primal   forward solve + QoI + regression check (reference
           main_primal.cpp); prints `J:` and, when the deck has a
           `regression` sublist, the regression summary, and exits 1 on
           FAIL.
  inverse  the `inverse` sublist's objective (reference
           main_inverse.cpp): with `check gradient: true` the adjoint
           gradient is held against finite differences and
           `gradient check: log10 error drop = ...` printed, with the
           `log10 drop expected` / `log10 drop tolerance` regression.
           The optimizer (`iteration limit` > 0, calibr8_tpu's
           opt/drivers.py) is not ported yet.

The other subcommands of calibr8_tpu come with later slices.  The solves
run on the card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import sys


def cmd_primal(args) -> int:
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.utils import timers

    spec = load_deck(args.deck)
    d = spec.disc
    if d.get("fields file"):
        raise NotImplementedError("'fields file' (io/synthetic.py) is not ported yet")
    if spec.sub("problem").get("write synthetic", False):
        raise NotImplementedError("'write synthetic' output is not ported yet")
    prob = Problem(spec, device=args.device)
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
    return 0


def _build_objective(spec, prob):
    """The objective of the `inverse` sublist on prob (calibr8_tpu
    cli/main.py:109-179, the objective types ported so far)."""
    from calibr8_tpu_torch.opt.objective import ActiveParams, AdjointObjective
    from calibr8_tpu_torch.qoi.base import QoI
    from calibr8_tpu_torch.solve.adjoint import Adjoint
    from calibr8_tpu_torch.solve.linear import LinearCfg

    inverse = spec.inverse
    active = ActiveParams.from_inverse_spec(inverse, prob.disc.elem_set_names,
                                            prob.model.param_names)
    obj_type = inverse.get("objective type", "pdeco")
    if obj_type in ("pdeco", "adjoint"):
        if prob.qoi is None or type(prob.qoi).elem_value is QoI.elem_value:
            raise NotImplementedError(
                "the adjoint objective needs a QoI with an element form; the calibration "
                "and reaction-mismatch QoIs come with io/synthetic.py (ROADMAP.md queue 1, "
                "'Drivers: FEMU recovery')"
            )
        # the default LinearCfg with the problem's multigrid, as calibr8_tpu's
        # CLI builds it (cli/main.py:118-122)
        adj = Adjoint(prob.assembler, prob.qoi, prob.dbcs, LinearCfg(),
                      mg_factory=prob.mg_factory)
        return AdjointObjective(prob, adj, active), active
    if obj_type == "FEMU":
        raise NotImplementedError(
            "objective type 'FEMU' is value-only: its gradient is the optimizer's finite "
            "differences, and it comes with the optimizer (opt/drivers.py; ROADMAP.md queue 1, "
            "'Drivers: FEMU recovery')"
        )
    raise NotImplementedError(
        f"objective type {obj_type!r} is not ported yet (the port has pdeco and adjoint; "
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
    from calibr8_tpu_torch.opt.objective import fd_gradient_check
    from calibr8_tpu_torch.problem import Problem

    spec = load_deck(args.deck)
    inverse = spec.inverse
    if not inverse.get("check gradient", False) or int(inverse.get("iteration limit", 0)) > 0:
        raise NotImplementedError(
            "the optimizer of 'inverse' ('iteration limit' > 0, or no 'check gradient'; "
            "calibr8_tpu opt/drivers.py) is not ported yet: ROADMAP.md queue 1, "
            "'Drivers: FEMU recovery'"
        )
    if spec.disc.get("fields file"):
        raise NotImplementedError("'fields file' (io/synthetic.py) is not ported yet")
    if spec.sub("problems"):
        obj, active, prob = _build_multi_problem(spec, args.device)
    else:
        prob = Problem(spec, device=args.device)
        obj, active = _build_objective(spec, prob)
    x0 = active.to_canonical(active.extract(prob.params0))
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
    sp.set_defaults(fn=cmd_inverse)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
