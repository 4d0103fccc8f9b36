#!/usr/bin/env python3
"""calibr8_tpu's (JAX, CPU, float64) J of chip_smoke.py's full-width Hill
decks: the references phase 4 of chip_smoke.py holds the port to.

    JAX_PLATFORMS=cpu python3 chip_reference.py [plane_stress] [hill]

Runs each named deck (both by default) through calibr8_tpu's
Problem(...).solve_primal() on the CPU and prints one JSON line per deck
with J, the per-step contributions and the wall time.  Needs JAX and the
calibr8_tpu package; chip_smoke.py itself imports neither.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

DECKS = ("plane_stress", "hill")


def main(argv) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from calibr8_tpu.deck import load_deck
    from calibr8_tpu.problem import Problem

    names = argv[1:] or list(DECKS)
    decks = {"plane_stress": ("J_REF_PLANE_STRESS_H004", chip_smoke.plane_stress_deck(0.004)),
             "hill": ("J_REF_HILL_N32", chip_smoke.hill_deck(32))}
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
