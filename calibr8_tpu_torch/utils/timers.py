"""Per-phase wall-clock timers.

    from calibr8_tpu_torch.utils import timers
    with timers.phase("primal/assemble", device):
        out = assemble(...)
    timers.report()            # per-phase count/total/mean table

Timers are process-global, as in calibr8_tpu.  PyTorch returns before
the card finishes, so a phase given a CUDA device ends with
torch.cuda.synchronize() before the clock stops: the time is the
device's, not the enqueue's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

_records: dict[str, list[float]] = defaultdict(list)


def reset() -> None:
    _records.clear()


@contextlib.contextmanager
def phase(name: str, device=None):
    """Time a phase; with a CUDA `device` the card is synchronized
    before the clock stops."""
    cuda = device is not None and torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        _records[name].append(time.perf_counter() - t0)


def summary() -> dict[str, dict]:
    return {
        k: dict(count=len(v), total=sum(v), mean=sum(v) / len(v), max=max(v))
        for k, v in _records.items()
        if v
    }


def report(print_fn=print) -> None:
    s = summary()
    if not s:
        return
    print_fn("----- phase timers -----")
    width = max(len(k) for k in s)
    for k in sorted(s, key=lambda k: -s[k]["total"]):
        r = s[k]
        print_fn(
            f"{k:<{width}}  n={r['count']:<5d} total={r['total']:9.3f}s "
            f"mean={r['mean'] * 1e3:9.3f}ms max={r['max'] * 1e3:9.3f}ms"
        )
    print_fn("------------------------")
