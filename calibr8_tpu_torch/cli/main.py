"""Command-line driver.

Usage: python -m calibr8_tpu_torch primal <deck.yaml> [--device cuda|cpu] [--timers]

  primal   forward solve + QoI + regression check (reference
           main_primal.cpp); prints `J:` and, when the deck has a
           `regression` sublist, the regression summary, and exits 1 on
           FAIL.

The other subcommands of calibr8_tpu come with later slices.  The solve
runs on the card unless --device cpu is given.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="calibr8_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("primal")
    sp.add_argument("deck")
    sp.add_argument("--device", default=None, help="torch device (default: cuda)")
    sp.add_argument("--timers", action="store_true", help="print per-phase timers")
    sp.set_defaults(fn=cmd_primal)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
