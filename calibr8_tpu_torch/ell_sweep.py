"""The ELL kernels at each number of lanes per node on the card: the
forward kernel (csrc/ell_spmv.cu) and the transposed one
(csrc/ell_spmv_T.cu), the measurement behind their launch rules
c8::ell_lanes and c8::ell_T_lanes (csrc/c8_ell.cuh), with earlier
versions of the kernels beside them.

    python -m calibr8_tpu_torch.ell_sweep [--old OLD_ell_spmv.cu]
        [--old-T OLD_ell_spmv_T.cu] [--reps 30]

Builds each source as the program builds it (G from the rule), four times
more with the lanes fixed (-DC8_ELL_LANES=G, G = 1, 2, 4, 8) and, with
--old / --old-T, an earlier file with the same C entry (c8_ell_spmv; the
scatter form of c8_ell_spmv_T, which takes no tr_T and adds into a zeroed
y); one nvcc each, all started together, into _build/ell_sweep/.  Then,
at every shape at which chip_smoke.py holds a kernel (the forward one: 3a,
the multigrid levels of 3c, 3c per part; the transposed one, 3b: the 3a
shapes and the levels), in float64 and float32, it calls each build on
random A_T and x over the ELL pattern of the deck's mesh, holds its y
against the plain version at chip_smoke.py's limits, and reads the
kernel's device time per call under torch.profiler three ways: with 256
MB read before every call ("cold": the L2 holds other, clean data and
A_T comes from device memory, as on the Krylov solver's path, where the
orthogonalisation and preconditioner kernels between two products evict
it), with 256 MB written before every call ("dirty": the same, while the
L2 writes the other data back) and back to back ("warm").  The old
transposed kernel's time is its own kernel's; its zero fill of y is a
separate launch, not counted.  `rule_G` is the fixed G whose y equals the
rule build's bit for bit; `old_equal` whether the earlier build's y does.
The aggregation AMG's levels of the bench deck's mesh (the (6, 6) and (1,
1) instances) are among the shapes; an earlier file without the (6, 6)
instance fails there with cudaErrorInvalidValue, recorded as `error`.  Prints one JSON line per kernel, shape and
dtype, then the card's name and power limit, then {"ok": ...}: whether
every build was within its limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.mesh.refine import uniform_refine
from calibr8_tpu_torch.parallel.partition import build_partition
from calibr8_tpu_torch.solve.ellpack import (
    ell_maps_from_conn, ell_spmv_plain, ell_spmv_T_plain, level_ell_spmv_plain,
)

LANES = (1, 2, 4, 8)
# chip_smoke.py's limits (of max|plain|) and the card's memory rate
LIMITS = {torch.float64: 1e-12, torch.float32: 1e-5}
PEAK_BYTES_PER_S = 3.35e12
PARTS = 8
# direction -> (source, C entry, kernel name in the profiler)
SOURCES = {"forward": ("ell_spmv", "c8_ell_spmv", "ell_spmv_kernel"),
           "transposed": ("ell_spmv_T", "c8_ell_spmv_T", "ell_spmv_T_kernel")}


def _refined(mesh, times: int):
    for _ in range(times):
        mesh = uniform_refine(mesh).fine
    return mesh


def _maps_T(mesh):
    """nbr_T and tr_T (K, N) int32 of the mesh's ELL pattern."""
    maps = ell_maps_from_conn(mesh.conn, mesh.n_nodes)
    return np.ascontiguousarray(maps["nbr"].T), np.ascontiguousarray(maps["tr"].T)


def _part_nbr_T(mesh):
    """The parts' local ELL maps laid end to end, as DistContext lays them
    (parallel/dist.py): ids offset by p * N_loc, one pad id P * N_loc."""
    part = build_partition(mesh.conn, mesh.coords, PARTS)
    P, N_loc, K = PARTS, part.N_loc, part.K_ell
    PN = P * N_loc
    p_ids = np.arange(P)[:, None, None]
    nbr = np.where(part.nbr_local >= N_loc, PN, part.nbr_local + p_ids * N_loc)
    return np.ascontiguousarray(nbr.reshape(PN, K).T)


def shapes():
    """(kernel, label, dim, ndpn, nbr_T, tr_T) of every record of the ELL
    kernels in chip_smoke.py, host arrays, `kernel` naming the forward one
    (3a, 3c, 3c per part); tr_T is None where chip_smoke.py holds only the
    forward kernel, else the transposed one (3b) is held there too: cube
    n=32 (mixed u/p and isotropic_elastic) and notch2D h=0.004 (ndpn 2 and
    3); the multigrid decks' levels (cube n=4 refined 3 times: the fine
    pressure block and level 1; notch2D h=0.032 refined 3 times: level 1);
    the parts at 8 parts (cube n=32 ndpn 4, notch2D h=0.004 ndpn 3 and 2;
    forward only)."""
    cube_m, notch_m = generators.cube(32), generators.notch2d(0.004)
    cube, notch = _maps_T(cube_m), _maps_T(notch_m)
    cube_l1 = _refined(generators.cube(4), 2)
    cube_fine = _maps_T(_refined(cube_l1, 1))
    cl1 = _maps_T(cube_l1)
    notch_l1 = _maps_T(_refined(generators.notch2d(0.032), 2))
    out = [
        ("3a", "cube n=32 mixed u/p", 3, 4, *cube),
        ("3a", "cube n=32 isotropic_elastic", 3, 3, *cube),
        ("3a", "notch2D h=0.004 ndpn 2", 2, 2, *notch),
        ("3a", "notch2D h=0.004 ndpn 3", 2, 3, *notch),
        ("3c", "cube MG fine p block", 1, 1, *cube_fine),
        ("3c", "cube MG level 1 u", 3, 3, *cl1),
        ("3c", "cube MG level 1 p", 1, 1, *cl1),
        ("3c", "notch2D MG level 1", 2, 2, *notch_l1),
    ]
    pc, pn = _part_nbr_T(cube_m), _part_nbr_T(notch_m)
    out += [("3c per part", "cube n=32 ndpn 4, 8 parts", 4, 4, pc, None),
            ("3c per part", "notch2D h=0.004 ndpn 3, 8 parts", 3, 3, pn, None),
            ("3c per part", "notch2D h=0.004 ndpn 2, 8 parts", 2, 2, pn, None)]
    for label, nbr_T in _amg_levels(cube_m):
        out += [("3c", f"{label} u", 6, 6, nbr_T, None), ("3c", f"{label} p", 1, 1, nbr_T, None)]
    return out


def _amg_levels(mesh):
    """(label, nbr_T) of the aggregation AMG's coarse levels on the bench
    deck's mesh (solve/amg.py; chip_smoke.py's phase 4d holds the (6, 6)
    instance on levels 1 and 2)."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.profile_primal import bench_deck

    deck = bench_deck(32)
    deck["linear algebra"] = {"method": "gmres", "preconditioner": "amg"}
    levels = Problem(load_deck(deck), mesh=mesh, device="cpu").mg_factory.levels
    return [(f"AMG level {i + 1} ({lv.n} nodes)", np.ascontiguousarray(lv.nbr.T))
            for i, lv in enumerate(levels)]


def build(old: dict) -> dict:
    """{direction: {tag: the C entry of that build}}: tags "rule", "G1" ..
    "G8" and, where `old[direction]` names a file, "old"."""
    out = kernels.BUILD_DIR / "ell_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.nvcc_path(), {}
    for direction, (name, *_) in SOURCES.items():
        src = kernels.CSRC / f"{name}.cu"
        todo = {"rule": (src, ())}
        todo.update({f"G{G}": (src, (f"-DC8_ELL_LANES={G}",)) for G in LANES})
        if old.get(direction):
            todo["old"] = (Path(old[direction]).resolve(), ())
        for tag, (path, extra) in todo.items():
            cmd = [nvcc, *kernels._flags(name), *extra, "-I", str(kernels.CSRC),
                   "-o", str(out / f"{name}-{tag}.so"), str(path)]
            procs[direction, tag] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {d: {} for d in SOURCES}
    for (direction, tag), proc in procs.items():
        name, symbol, _ = SOURCES[direction]
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {tag}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{name}-{tag}.so"))
        lib.c8_error_string.argtypes = [ctypes.c_int]
        lib.c8_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, symbol)
        # the transposed builds of this tree take tr_T after nbr_T
        n_maps = 2 if direction == "transposed" and tag != "old" else 1
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * (4 + n_maps)
        fn.restype = ctypes.c_int
        fns[direction][tag] = (fn, lib, n_maps)
    return fns


def device_ms(call, reps: int, kernel: str, flush=None, tries: int = 3) -> float:
    """Device time per call of the kernels whose name holds `kernel`, under
    torch.profiler over `reps` calls, each after `flush()` when one is
    given.  A session that records none of them (one of some 300 did,
    on an H100 with torch 2.11) is run again, up to `tries` sessions."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                call()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.key)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError(f"{tries} profiler sessions show no device time of {kernel}")


def sweep_shape(fns, direction, kernel, label, dim, ndpn, nbr_np, tr_np, dtype, reps, buf):
    dev = torch.device("cuda", torch.cuda.current_device())
    K, N = nbr_np.shape
    nbr_T = torch.as_tensor(nbr_np, dtype=torch.int32, device=dev)
    tr_T = None if tr_np is None else torch.as_tensor(tr_np, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    A_T = torch.randn((K, ndpn, ndpn, N), generator=gen, device=dev, dtype=torch.float64)
    x = torch.randn(N * ndpn, generator=gen, device=dev, dtype=torch.float64)
    A_T, x = A_T.to(dtype), x.to(dtype)
    if direction == "transposed":
        y_plain = ell_spmv_T_plain(A_T, nbr_T, x, dim)
    elif ndpn > dim:
        y_plain = ell_spmv_plain(A_T, nbr_T, x, dim)
    else:
        y_plain = level_ell_spmv_plain(A_T, nbr_T, x, ndpn)
    scale = y_plain.abs().max().item()
    y = torch.empty_like(x)
    name = SOURCES[direction][2]

    def call(fn, lib, n_maps):
        maps = (nbr_T.data_ptr(),) if n_maps == 1 else (nbr_T.data_ptr(), tr_T.data_ptr())
        if direction == "transposed" and n_maps == 1:
            y.zero_()  # the old scatter form adds into y
        err = fn(dev.index, kernels.dtype_code(dtype), dim, ndpn, N, K, A_T.data_ptr(), *maps,
                 x.data_ptr(), y.data_ptr(), kernels.stream_ptr(dev))
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} ({lib.c8_error_string(err).decode()})")

    w = A_T.element_size()
    filled = int((nbr_T < N).sum())
    # the filled slots' A_T blocks, nbr_T, x and y (tr_T not: the gather's
    # overhead, not the function's work)
    nbytes = filled * ndpn * ndpn * w + K * N * 4 + 2 * N * ndpn * w
    rec = dict(direction=direction, kernel=kernel, shape=label, dtype=str(dtype).split(".")[1],
               dim=dim, ndpn=ndpn, N=N, K=K, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
               builds={})
    ok, ys = True, {}
    for tag, (fn, lib, n_maps) in fns.items():
        try:
            call(fn, lib, n_maps)
        except RuntimeError as exc:
            if tag != "old":
                raise
            # an earlier file without this instance
            rec["builds"][tag] = dict(error=str(exc))
            continue
        torch.cuda.synchronize()
        ys[tag] = y.clone()
        err = (y - y_plain).abs().max().item() / scale
        ok &= err <= LIMITS[dtype]
        one = lambda: call(fn, lib, n_maps)  # noqa: E731
        rec["builds"][tag] = dict(
            rel_err=err,
            cold_ms=device_ms(one, reps, name, lambda: buf.sum()),
            dirty_ms=device_ms(one, reps, name, lambda: buf.zero_()),
            warm_ms=device_ms(one, reps, name),
        )
    rec["rule_G"] = next((G for G in LANES if torch.equal(ys[f"G{G}"], ys["rule"])), None)
    if "old" in ys:
        # the earlier build's y against this one's, bit for bit
        rec["old_equal"] = torch.equal(ys["old"], ys["rule"])
    rec["ok"] = ok
    return ok, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an earlier csrc/ell_spmv.cu to time beside this one")
    ap.add_argument("--old-T", help="an earlier csrc/ell_spmv_T.cu (the scatter form, "
                                    "without tr_T) to time beside this one")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_sweep: no CUDA device", file=sys.stderr)
        return 1
    fns = build({"forward": args.old, "transposed": args.old_T})
    # 256 MB read or written before each cold call: five times the
    # H100's 50 MB L2
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    ok = True
    for kernel, label, dim, ndpn, nbr_np, tr_np in shapes():
        runs = [("forward", kernel)] + ([] if tr_np is None else [("transposed", "3b")])
        for direction, kname in runs:
            for dtype in (torch.float64, torch.float32):
                good, rec = sweep_shape(fns[direction], direction, kname, label, dim, ndpn,
                                        nbr_np, tr_np, dtype, args.reps, buf)
                ok &= good
                print(json.dumps(rec), flush=True)
                torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
