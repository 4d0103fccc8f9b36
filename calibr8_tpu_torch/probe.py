"""Kernel 4: a probe of inverse trigonometry and float64 loop carries on
the card (csrc/probe.cu), with its plain version.

The counterpart of calibr8_tpu's two Mosaic lowering probes
(scripts/probe_mosaic_trig.py:51, scripts/probe_mosaic_f64.py:64), on
their inputs: acos, asin, atan, atan2 and acos written as atan2(sqrt(1 -
a^2), a) on a = linspace(-0.95, 0.95, 256), b = linspace(0.05, 1.0, 256),
in float32 and float64; and the float64 update x - 0.25 (x^2 - 2) over 8
iterations on an (8, 1024) block, carried through a fully unrolled loop,
a loop of a fixed trip count, and a while loop whose end depends on the
data.  It lies on no solver path: it settles what the small_hosford
twin's eigensolver may call on the card (acos, in place of calibr8_tpu's
t_acos polynomial).

    python -m calibr8_tpu_torch.probe [--device cpu]

prints one JSON line per probe with its largest error against numpy (in
float64 on the same inputs) and exits non-zero if one exceeds its limit.

  trig(a, b) / loop(x)              the wrappers: the kernel on CUDA
                                    tensors, the plain version on CPU ones
  trig_plain(a, b) / loop_plain(x)  the same functions in PyTorch
  run(device)                       the probe on `device`, its report
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from calibr8_tpu_torch import kernels

TRIG_NAMES = ("acos", "asin", "atan", "atan2", "acos_via_atan2")
LOOP_FORMS = ("unroll", "fixed", "while")
LOOP_ITERS = 8
# the largest absolute error against numpy: the results reach pi, where
# one ulp is 2.4e-7 (float32) and 4.4e-16 (float64); the loop's float64
# carries agree with numpy's to rounding
LIMITS = {"float32": 2e-6, "float64": 4e-15, "loop": 1e-12}


def trig_inputs():
    """(a, b) of scripts/probe_mosaic_trig.py, float64 numpy (256,)."""
    return np.linspace(-0.95, 0.95, 256), np.linspace(0.05, 1.0, 256)


def loop_input():
    """The loop probe's (8, 1024) float64 block: starting values spread
    over [0.5, 2.5] (scripts/probe_mosaic_f64.py fills 1.7), all of which
    the update carries towards sqrt(2)."""
    return np.linspace(0.5, 2.5, 8 * 1024).reshape(8, 1024)


def trig_plain(a, b):
    """(5, *a.shape): acos(a), asin(a), atan(a), atan2(a, b),
    atan2(sqrt(max(1 - a^2, 0)), a)."""
    return torch.stack([torch.acos(a), torch.asin(a), torch.atan(a), torch.atan2(a, b),
                        torch.atan2(torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)), a)])


def loop_plain(x, iters: int = LOOP_ITERS):
    """(3, *x.shape): x after `iters` updates x - 0.25 (x^2 - 2), once for
    each of the kernel's three loop forms (one loop here)."""
    for _ in range(iters):
        x = x - 0.25 * (x * x - 2.0)
    return torch.stack([x, x, x])


def trig(a, b):
    """trig_plain(a, b); on CUDA tensors from the kernel, which counts its
    launch under `probe`."""
    if not a.is_cuda:
        return trig_plain(a, b)
    req = kernels.require
    req(b.device == a.device and b.dtype == a.dtype and b.shape == a.shape,
        "a and b must share device, dtype and shape")
    req(a.is_contiguous() and b.is_contiguous(), "a and b must be contiguous")
    out = torch.empty((5,) + tuple(a.shape), dtype=a.dtype, device=a.device)
    fn = kernels.function("probe", "c8_probe_trig", [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    err = fn(a.device.index, kernels.dtype_code(a.dtype), a.numel(), a.data_ptr(), b.data_ptr(),
             out.data_ptr(), kernels.stream_ptr(a.device))
    kernels.check("probe", err)
    kernels.launches["probe"] += 1
    return out


def loop(x, iters: int = LOOP_ITERS):
    """loop_plain(x, iters); on a CUDA tensor (float64) from the kernel,
    which counts its launch under `probe`."""
    if not x.is_cuda:
        return loop_plain(x, iters)
    req = kernels.require
    req(x.dtype == torch.float64 and x.is_contiguous(), "x must be contiguous float64")
    req(iters == LOOP_ITERS, f"the unrolled form runs {LOOP_ITERS} iterations")
    # each element's trip count, read by the while form
    trips = torch.full(tuple(x.shape), iters, dtype=torch.int32, device=x.device)
    out = torch.empty((3,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    fn = kernels.function("probe", "c8_probe_loop",
                          [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                          + [ctypes.c_void_p] * 2)
    err = fn(x.device.index, x.numel(), x.data_ptr(), trips.data_ptr(), iters, out.data_ptr(),
             kernels.stream_ptr(x.device))
    kernels.check("probe", err)
    kernels.launches["probe"] += 1
    return out


def numpy_reference():
    """numpy's trig on the inputs rounded to each dtype, in float64, and
    numpy's loop."""
    a, b = trig_inputs()
    ref = {}
    for dn, npt in (("float32", np.float32), ("float64", np.float64)):
        a_, b_ = a.astype(npt).astype(np.float64), b.astype(npt).astype(np.float64)
        ref[dn] = np.stack([np.arccos(a_), np.arcsin(a_), np.arctan(a_), np.arctan2(a_, b_),
                            np.arctan2(np.sqrt(np.maximum(1.0 - a_ * a_, 0.0)), a_)])
    x = loop_input()
    for _ in range(LOOP_ITERS):
        x = x - 0.25 * (x * x - 2.0)
    ref["loop"] = x
    return ref


def run(device):
    """The probe on `device`: (report records, outputs by dtype and "loop").
    Each record: the probe, its dtype, its largest absolute error against
    numpy per function (or loop form), its limit, and ok."""
    ref = numpy_reference()
    a, b = trig_inputs()
    records, outs = [], {}
    for dn, dt in (("float32", torch.float32), ("float64", torch.float64)):
        out = trig(torch.tensor(a, dtype=dt, device=device), torch.tensor(b, dtype=dt, device=device))
        got = out.double().cpu().numpy()
        errs = {n: float(np.abs(got[k] - ref[dn][k]).max()) for k, n in enumerate(TRIG_NAMES)}
        records.append(dict(probe="trig", dtype=dn, max_abs_err=errs, limit=LIMITS[dn],
                            ok=max(errs.values()) <= LIMITS[dn]))
        outs[dn] = out
    out = loop(torch.tensor(loop_input(), device=device))
    got = out.cpu().numpy()
    errs = {n: float(np.abs(got[k] - ref["loop"]).max()) for k, n in enumerate(LOOP_FORMS)}
    apart = max(float(np.abs(got[k] - got[0]).max()) for k in range(1, 3))
    records.append(dict(probe="loop", dtype="float64", iters=LOOP_ITERS, max_abs_err=errs,
                        forms_apart=apart, limit=LIMITS["loop"],
                        ok=max(max(errs.values()), apart) <= LIMITS["loop"]))
    outs["loop"] = out
    return records, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m calibr8_tpu_torch.probe")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("probe: no CUDA device; pass --device cpu for the plain version", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    records, _ = run(device)
    for r in records:
        print(json.dumps(dict(r, device=str(device))))
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
