#!/usr/bin/env python3
"""Smoke run of calibr8_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            (from the root of a checkout)

Phases, in order; any failure exits non-zero without the result lines:

 1. device: the card's name and power limit (nvidia-smi), the torch and
    CUDA versions, and the build of the three CUDA kernels from
    calibr8_tpu_torch/csrc with nvcc (one process per source, in
    parallel).
 2. each kernel against its plain PyTorch version, in float32 and
    float64, at the shapes of the full-width problem (cube n=32,
    small_J2, mixed u/p: 196,608 elements, 143,748 dofs) in a plastic
    state: max error relative to max|plain|, the kernel's time per call
    (CUDA events around back-to-back calls), the plain version's, a
    one-call PyTorch yardstick where one exists, and the least time the
    card could take (bound).
 3. the notch2D_small_J2 and cube_elastic goldens (tests/decks.py) on the
    card in float64, and the notch deck once more through GMRES on the
    ELL operator.
 4. the full-width primal solve (the bench deck: cube n=32, small_J2,
    mixed u/p, 2 load steps, float64, GMRES + block Gauss-Seidel)
    through Problem(...).solve_primal(), twice: with the assembled ELL
    matrix as the Krylov operator (the default) and with the matrix-free
    EBE operator (LinearCfg.operator = "ebe").  Each run's launch counts
    are set to 0 just before it and read just after; J is held to
    calibr8_tpu's value at rel 1e-6 in both.
 5. one JSON line listing every ported kernel (launches: the sum of the
    two runs of phase 4), the card's name and power limit, and the `ok`
    line last.

The script imports nothing of JAX or of calibr8_tpu.  Kernel builds go to
calibr8_tpu_torch/_build/.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores; 67 TFLOP/s float64 on the tensor cores (34
# outside them) -- the larger rate is taken so that the bound stays a
# lower bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
DEVICE = "cuda"

# J of the full-width deck from calibr8_tpu (the JAX reference) on an
# 8-core CPU: bench.build_problem(32, "f64") then solve_primal(); the two
# step contributions were 9.090906938095302e-04 and
# 1.0606065519543038e-03.
J_REF_N32 = 1.96969724576383405e-03

LR_TOL = {
    "nonlinear max iters": 500,
    "nonlinear absolute tol": 1e-12,
    "nonlinear relative tol": 1e-12,
}


def _deck(mesh, model, materials, bcs, num_steps):
    """tests/decks.py make_deck"""
    return {
        "discretization": {"builtin mesh": mesh, "num steps": num_steps, "step size": 1.0},
        "residuals": {
            "global residual": {
                "type": "mechanics",
                "nonlinear max iters": 40,
                "nonlinear absolute tol": 1e-8,
                "nonlinear relative tol": 1e-8,
            },
            "local residual": {"type": model, **LR_TOL, "materials": {"body": materials}},
        },
        "dirichlet bcs": bcs,
        "quantity of interest": {"type": "average displacement"},
    }


# name -> (deck, golden QoI, rel tol)   (tests/decks.py PRIMAL_REGRESSIONS)
GOLDENS = {
    "cube_elastic": (
        _deck(
            {"type": "cube", "n": 2}, "elastic",
            {"E": 1000.0, "nu": 0.25, "cte": 1e-3, "delta_T": 10.0},
            {"expression": {
                "bc 1": [0, 0, "xmin", "0.0"],
                "bc 2": [0, 1, "ymin", "0.0"],
                "bc 3": [0, 2, "zmin", "0.0"],
            }},
            1,
        ),
        5.00000000000000184e-3, 1e-6,
    ),
    "notch2D_small_J2": (
        _deck(
            {"type": "notch2D", "h": 0.12}, "small_J2",
            {"E": 1000.0, "nu": 0.25, "K": 100.0, "Y": 10.0, "cte": 0.0, "delta_T": 0.0},
            {"expression": {
                "bc 1": [0, 0, "xmin", "0.0"],
                "bc 2": [0, 1, "ymin", "0.0"],
                "bc 3": [0, 1, "ymax", "0.001 * t"],
            }},
            8,
        ),
        6.51333502442964264e-03, 1e-8,
    ),
}

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_assembly": ("calibr8_tpu_torch/csrc/fused_assembly.cu",
                       "calibr8_tpu/fem/pallas_assembly.py:496"),
    "ebe_matvec": ("calibr8_tpu_torch/csrc/ebe_matvec.cu",
                   "calibr8_tpu/fem/pallas_matvec.py:49"),
    "ell_spmv": ("calibr8_tpu_torch/csrc/ell_spmv.cu",
                 "calibr8_tpu/solve/ellpack.py:491"),
}
LIMITS = {"float64": 1e-12, "float32": 1e-5}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, rounds: int = 3) -> float:
    """Time of one call: CUDA events around `reps` back-to-back calls,
    divided by `reps`; the median of `rounds` such means.  Back to back,
    the card's queue stays full, so the host's launch overhead does not
    count unless it is longer than the call itself."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        means.append(a.elapsed_time(b) / reps)
    return sorted(means)[len(means) // 2]


def bound(nbytes: float, flops: float, dtype_name: str):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rel_err(a, b):
    d = (a.double() - b.double()).abs().max().item()
    s = b.double().abs().max().item()
    return d / max(s, 1e-300), d


def representative_state(prob, seed=0):
    """bench.py:150-179's deformed state (active plasticity), with a
    random nodal pressure so the pressure terms are exercised too."""
    disc = prob.disc
    d = disc.spec.dim
    rng = np.random.default_rng(seed)
    c = disc.mesh.coords
    u = np.stack([(-0.004 if i != 1 else 0.02) * c[:, i] for i in range(d)], axis=1)
    u = u + 1e-4 * rng.standard_normal((disc.n_nodes, d))
    p = rng.standard_normal(disc.n_nodes)
    x = torch.tensor(np.concatenate([u.reshape(-1), p]), dtype=disc.dtype, device=disc.device)
    xi_prev = torch.zeros(disc.n_elem, prob.model.nxi(), dtype=disc.dtype, device=disc.device)
    return x, xi_prev


def phase_kernels(mesh, results):
    """Phase 2: every kernel against its plain version, f32 and f64."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec, ebe_matvec_plain
    from calibr8_tpu_torch.fem.fused_assembly import fused_assembly, fused_assembly_plain
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.profile_primal import bench_deck
    from calibr8_tpu_torch.solve.ellpack import (
        assemble_ell_T, build_ell_maps, ell_spmv, ell_spmv_plain,
    )

    ok = True
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[1]
        w = 4 if dtype == torch.float32 else 8
        prob = Problem(load_deck(bench_deck(32)), mesh=mesh, device=DEVICE, dtype=dtype)
        disc, bm = prob.disc, prob.assembler.bmodel
        E, nde, n_dofs, npe, d = disc.n_elem, disc.spec.ndofs_elem, disc.n_dofs, disc.spec.npe, disc.spec.dim
        nxi = bm.nxi
        x, xi_prev = representative_state(prob)
        P = prob.params0
        lim = LIMITS[dn]

        # -- kernel 1: fused assembly --
        out_k = fused_assembly(disc, bm, x, xi_prev, P)
        out_p = fused_assembly_plain(disc, bm, x, xi_prev, P)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("R", "J", "xi"), out_k[:3], out_p[:3]):
            errs[name] = rel_err(a, b)
        path_mism = int((out_k[3] != out_p[3]).sum())
        n_plastic = int(out_p[3].sum())
        worst = max(e[0] for e in errs.values())
        ms = time_ms(lambda: fused_assembly(disc, bm, x, xi_prev, P), 20)
        pms = time_ms(lambda: fused_assembly_plain(disc, bm, x, xi_prev, P), 2, rounds=1)
        nbytes = (n_dofs * w + nde * E * 4 + E * nxi * w + npe * d * E * w + 2 * E * w
                  + P.numel() * w + E * 4 + nde * E * w + nde * nde * E * w + nxi * E * w + 2 * E * 4)
        # counted operations: only the Jacobian contraction of the d*d
        # tangents with grad_N (2 flops per multiply-add), a lower bound
        flops = 2.0 * E * nde * npe * d * d
        b_ms, b_by = bound(nbytes, flops, dn)
        rec = dict(kernel="fused_assembly", dtype=dn, rel_err={k: v[0] for k, v in errs.items()},
                   max_abs_err=max(e[1] for e in errs.values()), path_mismatch=path_mism,
                   plastic=n_plastic, elements=E, ms=ms, plain_ms=pms, library_ms=None,
                   bound_ms=b_ms, bound_by=b_by, limit=lim)
        log(json.dumps(rec))
        if worst > lim or path_mism or not all(bool(torch.isfinite(t).all()) for t in out_k[:3]):
            log(f"FAIL fused_assembly {dn}: rel err {worst:.3e} (limit {lim:.0e}), "
                f"path mismatches {path_mism}")
            ok = False
        results[("fused_assembly", dn)] = rec
        J_T = out_k[1]

        # -- kernel 2: EBE matvec --
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        v = torch.randn(n_dofs, generator=gen, device=DEVICE, dtype=dtype)
        yk = ebe_matvec(J_T, v, disc.edofs_T, n_dofs)
        yp = ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs)
        torch.cuda.synchronize()
        err, aerr = rel_err(yk, yp)
        ms = time_ms(lambda: ebe_matvec(J_T, v, disc.edofs_T, n_dofs), 30)
        pms = time_ms(lambda: ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs), 10)
        J_ef = J_T.permute(2, 0, 1).contiguous()
        idx = disc.edofs

        def lib_ebe():
            ye = torch.bmm(J_ef, v[idx].unsqueeze(-1)).squeeze(-1)
            return torch.zeros(n_dofs, dtype=dtype, device=DEVICE).index_add_(
                0, idx.reshape(-1), ye.reshape(-1))

        lms = time_ms(lib_ebe, 10)
        err_lib = rel_err(lib_ebe(), yp)[0]
        del J_ef
        nbytes = nde * nde * E * w + nde * E * 4 + 2 * n_dofs * w
        b_ms, b_by = bound(nbytes, 2.0 * nde * nde * E, dn)
        rec = dict(kernel="ebe_matvec", dtype=dn, rel_err=err, max_abs_err=aerr, ms=ms,
                   plain_ms=pms, library_ms=lms, library_rel_err=err_lib,
                   bound_ms=b_ms, bound_by=b_by, limit=lim)
        log(json.dumps(rec))
        if not err <= lim:
            log(f"FAIL ebe_matvec {dn}: rel err {err:.3e} (limit {lim:.0e})")
            ok = False
        results[("ebe_matvec", dn)] = rec

        # -- kernel 3: ELL SpMV --
        A_T = assemble_ell_T(J_T, disc)
        nbr_T = build_ell_maps(disc)["nbr_T"]
        K = A_T.shape[0]
        ndpn = disc.ndpn
        N = disc.n_nodes
        yk = ell_spmv(A_T, nbr_T, v, d)
        yp = ell_spmv_plain(A_T, nbr_T, v, d)
        torch.cuda.synchronize()
        err, aerr = rel_err(yk, yp)
        err_vs_ebe = rel_err(yk, ebe_matvec_plain(J_T, v, disc.edofs_T, n_dofs))[0]
        ms = time_ms(lambda: ell_spmv(A_T, nbr_T, v, d), 30)
        pms = time_ms(lambda: ell_spmv_plain(A_T, nbr_T, v, d), 10)
        # the same matrix as torch.sparse CSR (built once, not timed)
        nb = nbr_T.long()
        valid = nb < N  # (K, N)
        node = torch.arange(N, device=DEVICE)

        def dof(nodes, j):
            return nodes * d + j if j < d else N * d + nodes

        rows, cols, vals = [], [], []
        for i in range(ndpn):
            for j in range(ndpn):
                rn = node[None, :].expand(K, N)[valid]
                cn = nb[valid]
                rows.append(dof(rn, i))
                cols.append(dof(cn, j))
                vals.append(A_T[:, i, j, :][valid])
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals), (n_dofs, n_dofs)
        ).coalesce()
        csr = coo.to_sparse_csr()
        del coo, rows, cols, vals
        nnz_slots = int(valid.sum())
        lms = time_ms(lambda: torch.mv(csr, v), 30)
        err_lib = rel_err(torch.mv(csr, v), yp)[0]
        del csr
        nbytes = K * ndpn * ndpn * N * w + K * N * 4 + 2 * n_dofs * w
        b_ms, b_by = bound(nbytes, 2.0 * ndpn * ndpn * nnz_slots, dn)
        rec = dict(kernel="ell_spmv", dtype=dn, rel_err=err, max_abs_err=aerr,
                   rel_err_vs_ebe=err_vs_ebe, K=K, filled_slots=nnz_slots, ms=ms,
                   plain_ms=pms, library_ms=lms, library_rel_err=err_lib,
                   bound_ms=b_ms, bound_by=b_by, limit=lim)
        log(json.dumps(rec))
        if not err <= lim:
            log(f"FAIL ell_spmv {dn}: rel err {err:.3e} (limit {lim:.0e})")
            ok = False
        results[("ell_spmv", dn)] = rec
        del prob, disc, J_T, A_T, out_k, out_p
        torch.cuda.empty_cache()
    return ok


def phase_goldens():
    """Phase 3: goldens on the card in float64."""
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    cases = [(n, d, g, t) for n, (d, g, t) in GOLDENS.items()]
    notch, gold, tol = GOLDENS["notch2D_small_J2"]
    gm = copy.deepcopy(notch)
    gm["linear algebra"] = {"method": "gmres", "tolerance": 1e-12, "maximum iterations": 400}
    cases.append(("notch2D_small_J2_gmres_ell", gm, gold, tol))
    ok = True
    for name, deck, gold, tol in cases:
        t0 = time.perf_counter()
        prob = Problem(load_deck(copy.deepcopy(deck)), device=DEVICE, dtype=torch.float64)
        J = prob.solve_primal().J
        rel = abs(J - gold) / abs(gold)
        good = rel <= tol
        ok &= good
        log(json.dumps(dict(golden=name, J=J, expected=gold, rel_err=rel, tol=tol,
                            seconds=time.perf_counter() - t0, ok=good)))
    return ok


def phase_full_width(mesh, operator):
    """Phase 4: the full-width primal through the port's entry points,
    with the Krylov operator `operator` ("auto": the assembled ELL
    matrix; "ebe": the matrix-free element-by-element apply).  Returns
    (ok, launch counts of this run alone)."""
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem
    from calibr8_tpu_torch.profile_primal import bench_deck
    from calibr8_tpu_torch.utils import timers

    t0 = time.perf_counter()
    prob = Problem(load_deck(bench_deck(32)), mesh=mesh, device=DEVICE,
                   dtype=torch.float64)
    cfg = prob.step_solver.cfg
    cfg.linear = dataclasses.replace(cfg.linear, operator=operator)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    timers.reset()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = prob.solve_primal()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = dict(kernels.launches)
    J = traj.J
    rel = abs(J - J_REF_N32) / J_REF_N32
    steps = [dict(step=i + 1, newton_iterations=info["iterations"] - 1,
                  krylov_iterations=info["krylov_iters"], seconds=info["seconds"],
                  J_step=traj.qoi_values[i])
             for i, info in enumerate(traj.newton_info)]
    summ = timers.summary()
    rec = dict(full_width="cube n=32 small_J2 mixed u/p, 2 steps, float64, gmres + block_gs",
               operator=operator, n_elem=prob.disc.n_elem, n_dofs=prob.disc.n_dofs, J=J,
               J_ref=J_REF_N32, rel_err=rel, steps=steps, setup_s=setup_s, solve_s=solve_s,
               phases={k: dict(count=v["count"], total_s=v["total"]) for k, v in summ.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    log(json.dumps(rec))
    needed = ["fused_assembly", "ell_spmv" if operator != "ebe" else "ebe_matvec"]
    ok = rel <= 1e-6 and all(counts[k] > 0 for k in needed)
    if not ok:
        log(f"FAIL full width ({operator}): J rel err {rel:.3e} (limit 1e-6), launches {counts}")
    return ok, counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "calibr8_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout that holds calibr8_tpu_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from calibr8_tpu_torch import kernels
    from calibr8_tpu_torch.mesh import generators

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall ({json.dumps(built)})")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.perf_counter()
    mesh = generators.cube(32)
    log(f"mesh cube n=32: {time.perf_counter() - t0:.1f} s")

    results = {}
    ok = phase_kernels(mesh, results)
    log(f"phase kernels: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    ok = phase_goldens()
    log(f"phase goldens: {'ok' if ok else 'FAILED'} ({time.perf_counter() - t_start:.0f} s)")
    if not ok:
        return 1
    counts = {}
    for operator in ("auto", "ebe"):
        ok, c = phase_full_width(mesh, operator)
        log(f"phase full width, operator {operator}: {'ok' if ok else 'FAILED'} "
            f"({time.perf_counter() - t_start:.0f} s)")
        if not ok:
            return 1
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}

    line = []
    for name, (src, repl) in KERNELS.items():
        r = results[(name, "float64")]
        line.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=counts[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         library_ms=r["library_ms"]))
    print(json.dumps({"kernels": line}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
