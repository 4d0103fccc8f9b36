"""Kernel 1b's team kernel (c8::implicit_team_kernel, csrc/c8_implicit.cuh)
at each number of lanes per element on the card: the measurement behind
c8::implicit_team_lanes.

    python -m calibr8_tpu_torch.implicit_sweep [--lanes 1 2 4 8 16]
        [--cases LABEL ...] [--alt DIR] [--reps 5]

Run it from the repository's root: it takes chip_smoke.py's implicit
cases (its decks, states and float32 local tolerances).  Builds each of
the four sources whose instances implicit_cost.FLOPS counts,
implicit_assembly.cu, implicit_eig.cu, implicit_barlat.cu and
implicit_hybrid.cu, as the program builds it (G from the rule, tag "rule"), once more per G with the
lanes fixed (-DC8_IMPLICIT_TEAM=G, tag "G<n>"; G = 1, one thread per
element running c8::implicit_element, is always built and is the
reference), and, with --alt, the same sources of another csrc/ directory
(an earlier tree's kernel, `git archive` of its commit; tag "alt"); one
nvcc each, all started together, into _build/implicit_sweep/ (each
build's ptxas report beside it).  Then, at each case of chip_smoke.py's
phase 2 whose twin one of the four libraries holds (cube n=32
small_hill, hyper_J2, hypo_hill, small_hosford, hypo_hosford (their pull
tilted, chip_smoke.eig_deck), hypo_barlat; notch2D h=0.004 the six plane
twins and the hybrid, chip_smoke.HYBRID_TIMED), in float64 and float32, it calls every build on the same inputs,
holds each one's outputs (R, J, xi, path, fail, local counts) against the
G = 1 build's bit for bit (and records whether they are torch.equal, which
takes -0 for 0), and reads the kernel's device time per launch
(chip_smoke.device_ms) back to back ("warm") and with 256 MB read before
every call ("cold").  An alt build whose outputs are not the G = 1
build's bit for bit (an earlier tree may round otherwise) is held instead
to chip_smoke.py's limits for the kernel against its plain version
(chip_smoke.compare_implicit), and its record says so ("within_limits").
Prints one JSON line per case and dtype (with each build's registers and
stack frame and spill bytes), then the card's name and power limit, then {"ok": ...}:
whether every build passed.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from calibr8_tpu_torch import kernels
from calibr8_tpu_torch.fem.fused_assembly import (
    _HYBRID_ARGTYPES, _IMPLICIT_ARGTYPES, IMPLICIT_LIB, _outputs, hybrid_net_args, implicit_args,
)
from calibr8_tpu_torch.implicit_cost import FLOPS, ptxas_usage

# the libraries of the team kernel: source -> C entry
SOURCES = {"implicit_assembly": "c8_implicit_assembly",
           "implicit_eig": "c8_implicit_eig_assembly",
           "implicit_barlat": "c8_implicit_barlat_assembly",
           "implicit_hybrid": "c8_implicit_hybrid_assembly"}
LANES = (1, 2, 4, 8, 16)


def build(lanes, alt=None, sources=tuple(SOURCES)) -> tuple[dict, dict]:
    """({source: {tag: C entry}}, {source: {tag: ptxas usage}}) of the
    named sources: tags "rule", "G<n>" per lane count and, with `alt` a
    csrc/ directory, "alt"."""
    out = kernels.BUILD_DIR / "implicit_sweep"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = kernels.nvcc_path(), {}
    for name in sources:
        src = kernels.CSRC / f"{name}.cu"
        # tag -> (source, its headers' directory, extra flags)
        todo = {"rule": (src, kernels.CSRC, ())}
        todo.update({f"G{G}": (src, kernels.CSRC, (f"-DC8_IMPLICIT_TEAM={G}",))
                     for G in lanes})
        if alt:
            todo["alt"] = (Path(alt).resolve() / f"{name}.cu", Path(alt).resolve(), ())
        for tag, (path, inc, extra) in todo.items():
            cmd = [nvcc, *kernels._flags(name), *extra, "-I", str(inc),
                   "-o", str(out / f"{name}-{tag}.so"), str(path)]
            log = open(out / f"{name}-{tag}.log", "w")
            procs[name, tag] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log)
    fns = {n: {} for n in sources}
    usage = {n: {} for n in sources}
    for (name, tag), (proc, log) in procs.items():
        proc.wait()
        log.close()
        text = (out / f"{name}-{tag}.log").read_text()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {tag}:\n{text[-4000:]}")
        usage[name][tag] = ptxas_usage(text)
        lib = ctypes.CDLL(str(out / f"{name}-{tag}.so"))
        lib.c8_error_string.argtypes = [ctypes.c_int]
        lib.c8_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, SOURCES[name])
        # the hybrid's entry takes its network's description after the rest
        fn.argtypes = list(_IMPLICIT_ARGTYPES) + (
            _HYBRID_ARGTYPES if name == "implicit_hybrid" else [])
        fn.restype = ctypes.c_int
        fns[name][tag] = (fn, lib)
    return fns, usage


def _bits(t):
    """t's bits as integers (NaN lanes compare equal when their bits do)."""
    return t.view({torch.float64: torch.int64, torch.float32: torch.int32}.get(t.dtype, t.dtype))


def sweep_case(fns, usage, label, deck, mesh, scale, dtype, reps, buf):
    import chip_smoke as cs
    from calibr8_tpu_torch.deck import load_deck
    from calibr8_tpu_torch.problem import Problem

    prob = Problem(load_deck(cs.deck_in(deck, dtype)), mesh=mesh, device="cuda", dtype=dtype)
    disc, bm = prob.disc, prob.assembler.bmodel
    lib = IMPLICIT_LIB.get(bm.name, ("implicit_assembly",))[0]
    x, x_prev, xi_prev = cs.implicit_inputs(prob, scale)
    E = disc.n_elem
    P = prob.params0
    dn = str(dtype).split(".")[1]

    net = hybrid_net_args(bm, P) if lib == "implicit_hybrid" else ()

    def run(fn, lib_obj, outs, iters):
        err = fn(*implicit_args(disc.spec, bm, E, x, x_prev, disc.edofs_T, xi_prev, disc.gN_T,
                                disc.detJ, disc.h, P, disc.es_ids32, outs, iters), *net)
        if err != 0:
            raise RuntimeError(f"{lib}: CUDA error {err} ({lib_obj.c8_error_string(err).decode()})")

    results = {}
    for tag, (fn, lib_obj) in fns[lib].items():
        outs = _outputs(disc.spec, bm, E, dtype, x.device)
        iters = torch.zeros(E, dtype=torch.int32, device=x.device)
        run(fn, lib_obj, outs, iters)
        torch.cuda.synchronize()
        results[tag] = (*outs, iters)
    ref = results["G1"]
    el = cs.elem_inputs(prob, x, x_prev, xi_prev)
    hist = torch.bincount(ref[5].long(), minlength=bm.newton_iters + 1).tolist()
    rec = dict(case=label, library=lib, model=bm.name, dtype=dn, elements=E,
               newton_iters_hist=hist, builds={})
    ok = True
    for tag, (fn, lib_obj) in fns[lib].items():
        outs = results[tag]
        equal = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(outs, ref))
        # equal as values (a zero's sign aside)
        same = all(torch.equal(a, b) for a, b in zip(outs, ref))
        diff = {name: float((a.double() - b.double()).abs().max())
                for name, a, b in zip(("R", "J", "xi"), outs[:3], ref[:3])}
        limits = None
        if tag == "alt" and not equal:
            good, limits = cs.compare_implicit(disc.spec, bm, outs[:5], ref[:5], outs[5], ref[5],
                                               el)
            limits["ok"] = good
            ok &= good
        else:
            ok &= equal
        scratch = _outputs(disc.spec, bm, E, dtype, x.device)

        def one():
            run(fn, lib_obj, scratch, None)

        # the kernel's name: implicit_team_kernel, or an earlier tree's
        # implicit_assembly_kernel
        rec["builds"][tag] = dict(
            equal_to_G1=equal, torch_equal_to_G1=same, max_abs_diff=diff, within_limits=limits,
            cold_ms=cs.device_ms(one, reps, "implicit_", flush=lambda: buf.sum()),
            warm_ms=cs.device_ms(one, reps, "implicit_"),
            ptxas=usage[lib][tag].get(f"{dn} {bm.name}"))
        del scratch
    del results
    torch.cuda.empty_cache()
    return ok, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, nargs="*", default=list(LANES))
    ap.add_argument("--cases", nargs="*", help="labels of chip_smoke.py's implicit cases "
                                               "(default: every one of the four libraries)")
    ap.add_argument("--alt", help="another csrc/ directory whose sources build beside these")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("implicit_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from calibr8_tpu_torch.mesh import generators

    meshes = {"cube32": generators.cube(32), "notch004": generators.notch2d(0.004)}
    cases = [(label, deck, mesh, scale) for label, deck, mesh, scale in cs.IMPLICIT_CASES(meshes)
             if deck["residuals"]["local residual"]["type"] in FLOPS
             and (not args.cases or label in args.cases)]
    # only the libraries of the cases asked for
    libs = {IMPLICIT_LIB.get(deck["residuals"]["local residual"]["type"],
                             ("implicit_assembly",))[0] for _, deck, _, _ in cases}
    fns, usage = build(sorted({1, *args.lanes}), args.alt, [n for n in SOURCES if n in libs])
    print(json.dumps({"ptxas": usage}), flush=True)
    # 256 MB read before each cold call: five times the H100's 50 MB L2
    buf = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    ok = True
    for label, deck, mesh, scale in cases:
        for dtype in (torch.float64, torch.float32):
            good, rec = sweep_case(fns, usage, label, deck, mesh, scale, dtype, args.reps, buf)
            ok &= good
            print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
