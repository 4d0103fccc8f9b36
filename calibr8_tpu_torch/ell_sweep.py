"""The forward ELL kernel (csrc/ell_spmv.cu) at each number of lanes per
node on the card: the measurement behind the launch rule c8::ell_lanes
(csrc/c8_ell.cuh), with an earlier version of the kernel beside it.

    python -m calibr8_tpu_torch.ell_sweep [--old OLD_ell_spmv.cu] [--reps 30]

Builds csrc/ell_spmv.cu as the program builds it (G from the rule), four
times more with the lanes fixed (-DC8_ELL_LANES=G, G = 1, 2, 4, 8) and,
with --old, an earlier ell_spmv.cu with the same C entry c8_ell_spmv; one
nvcc each, all started together, into _build/ell_sweep/.  Then, at every
shape at which chip_smoke.py holds the forward kernel (3a, the multigrid
levels of 3c, 3c per part), in float64 and float32, it calls each build
on random A_T and x over the ELL pattern of the deck's mesh, holds its y
against the plain version at chip_smoke.py's limits, and reads the
kernel's device time per call under torch.profiler three ways: with 256
MB read before every call ("cold": the L2 holds other, clean data and
A_T comes from device memory, as on the Krylov solver's path, where the
orthogonalisation and preconditioner kernels between two products evict
it), with 256 MB written before every call ("dirty": the same, while the
L2 writes the other data back) and back to back ("warm").
`rule_G` is the fixed G whose y equals the rule build's bit for bit.
Prints one JSON line per shape and dtype, then the card's name and power
limit, then {"ok": ...}: whether every build was within its limit.
Needs a CUDA device.
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
    ell_maps_from_conn, ell_spmv_plain, level_ell_spmv_plain,
)

LANES = (1, 2, 4, 8)
# chip_smoke.py's limits (of max|plain|) and the card's memory rate
LIMITS = {torch.float64: 1e-12, torch.float32: 1e-5}
PEAK_BYTES_PER_S = 3.35e12
PARTS = 8
ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5


def _refined(mesh, times: int):
    for _ in range(times):
        mesh = uniform_refine(mesh).fine
    return mesh


def _nbr_T(mesh):
    maps = ell_maps_from_conn(mesh.conn, mesh.n_nodes)
    return np.ascontiguousarray(maps["nbr"].T)


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
    """(label, dim, ndpn, nbr_T (K, N) int32 on the host) of every record
    of the forward kernel in chip_smoke.py: 3a at cube n=32 (mixed u/p and
    isotropic_elastic) and notch2D h=0.004 (ndpn 2 and 3); 3c at the
    multigrid decks' levels (cube n=4 refined 3 times: the fine pressure
    block and level 1; notch2D h=0.032 refined 3 times: level 1); 3c per
    part at 8 parts (cube n=32 ndpn 4, notch2D h=0.004 ndpn 3 and 2)."""
    cube, notch = generators.cube(32), generators.notch2d(0.004)
    cube_l1 = _refined(generators.cube(4), 2)
    cube_fine = _refined(cube_l1, 1)
    notch_l1 = _refined(generators.notch2d(0.032), 2)
    c, n = _nbr_T(cube), _nbr_T(notch)
    cl1 = _nbr_T(cube_l1)
    out = [
        ("3a cube n=32 mixed u/p", 3, 4, c),
        ("3a cube n=32 isotropic_elastic", 3, 3, c),
        ("3a notch2D h=0.004 ndpn 2", 2, 2, n),
        ("3a notch2D h=0.004 ndpn 3", 2, 3, n),
        ("3c cube MG fine p block", 1, 1, _nbr_T(cube_fine)),
        ("3c cube MG level 1 u", 3, 3, cl1),
        ("3c cube MG level 1 p", 1, 1, cl1),
        ("3c notch2D MG level 1", 2, 2, _nbr_T(notch_l1)),
    ]
    pc, pn = _part_nbr_T(cube), _part_nbr_T(notch)
    out += [("3c per part cube n=32 ndpn 4", 4, 4, pc),
            ("3c per part notch2D h=0.004 ndpn 3", 3, 3, pn),
            ("3c per part notch2D h=0.004 ndpn 2", 2, 2, pn)]
    return out


def build(old: str | None) -> dict:
    """{tag: the c8_ell_spmv of that build}: "rule", "G1" .. "G8" and,
    with `old`, "old"."""
    out = kernels.BUILD_DIR / "ell_sweep"
    out.mkdir(parents=True, exist_ok=True)
    src = kernels.CSRC / "ell_spmv.cu"
    todo = {"rule": (src, ())}
    todo.update({f"G{G}": (src, (f"-DC8_ELL_LANES={G}",)) for G in LANES})
    if old:
        todo["old"] = (Path(old).resolve(), ())
    nvcc, procs = kernels.nvcc_path(), {}
    for tag, (path, extra) in todo.items():
        cmd = [nvcc, *kernels._flags("ell_spmv"), *extra, "-I", str(kernels.CSRC),
               "-o", str(out / f"{tag}.so"), str(path)]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    fns = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"{tag}.so"))
        lib.c8_error_string.argtypes = [ctypes.c_int]
        lib.c8_error_string.restype = ctypes.c_char_p
        fn = lib.c8_ell_spmv
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        fns[tag] = (fn, lib)
    return fns


def device_ms(call, reps: int, flush=None, tries: int = 3) -> float:
    """Device time per call of the kernels named ell_spmv_kernel, under
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
                 and "ell_spmv_kernel" in e.key)
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError(f"{tries} profiler sessions show no device time of ell_spmv_kernel")


def sweep_shape(fns, label, dim, ndpn, nbr_np, dtype, reps, buf):
    dev = torch.device("cuda", torch.cuda.current_device())
    K, N = nbr_np.shape
    nbr_T = torch.as_tensor(nbr_np, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    A_T = torch.randn((K, ndpn, ndpn, N), generator=gen, device=dev, dtype=torch.float64)
    x = torch.randn(N * ndpn, generator=gen, device=dev, dtype=torch.float64)
    A_T, x = A_T.to(dtype), x.to(dtype)
    y_plain = (ell_spmv_plain(A_T, nbr_T, x, dim) if ndpn > dim
               else level_ell_spmv_plain(A_T, nbr_T, x, ndpn))
    scale = y_plain.abs().max().item()
    y = torch.empty_like(x)

    def call(fn, lib):
        err = fn(dev.index, kernels.dtype_code(dtype), dim, ndpn, N, K, A_T.data_ptr(),
                 nbr_T.data_ptr(), x.data_ptr(), y.data_ptr(), kernels.stream_ptr(dev))
        if err != 0:
            raise RuntimeError(f"ell_spmv: CUDA error {err} ({lib.c8_error_string(err).decode()})")

    w = A_T.element_size()
    filled = int((nbr_T < N).sum())
    nbytes = filled * ndpn * ndpn * w + K * N * 4 + 2 * N * ndpn * w
    rec = dict(shape=label, dtype=str(dtype).split(".")[1], dim=dim, ndpn=ndpn, N=N, K=K,
               bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, builds={})
    ok, ys = True, {}
    for tag, (fn, lib) in fns.items():
        call(fn, lib)
        torch.cuda.synchronize()
        ys[tag] = y.clone()
        err = (y - y_plain).abs().max().item() / scale
        ok &= err <= LIMITS[dtype]
        rec["builds"][tag] = dict(
            rel_err=err,
            cold_ms=device_ms(lambda: call(fn, lib), reps, lambda: buf.sum()),
            dirty_ms=device_ms(lambda: call(fn, lib), reps, lambda: buf.zero_()),
            warm_ms=device_ms(lambda: call(fn, lib), reps),
        )
    rec["rule_G"] = next((G for G in LANES if torch.equal(ys[f"G{G}"], ys["rule"])), None)
    rec["ok"] = ok
    return ok, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="an earlier csrc/ell_spmv.cu to time beside this one")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_sweep: no CUDA device", file=sys.stderr)
        return 1
    fns = build(args.old)
    # 256 MB read or written before each cold call: five times the
    # H100's 50 MB L2
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    ok = True
    for label, dim, ndpn, nbr_np in shapes():
        for dtype in (torch.float64, torch.float32):
            good, rec = sweep_shape(fns, label, dim, ndpn, nbr_np, dtype, args.reps, buf)
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
