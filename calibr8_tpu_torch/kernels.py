"""Build, load and count the CUDA kernels of csrc/.

Route: `nvcc` compiles each `csrc/<name>.cu` on its own into a shared
library with a plain C interface, `_build/<name>-<hash>.so`, which
ctypes loads.  The hash covers the sources, the headers and the flags,
so an edited source builds anew and an unchanged one is loaded as it
is.  Nothing is built when this module is imported: `build()` runs at
the first launch (or up front, from chip_smoke.py), with one `nvcc`
per source, all started together.

Every wrapper that launches a kernel adds one to `launches[name]` where
it launches, and nowhere else; `reset_launches()` sets the counts to 0.
A counter is named after its kernel's source, except three that count
entries apart: `ell_spmv_level`, the multigrid level apply (calibr8_tpu's
kernel 3c, LevelEllOperator), and `ell_spmv_part`, the per-part local
apply of the domain-decomposed solver (3c per part, parallel/dist.py),
which launch the kernels of `ell_spmv.cu` on level or part shapes; and
`assembly_elems`, the element-level entry of the assembly (kernel 1c),
which launches the assembly libraries on pre-gathered element columns.
The assembly libraries' launches are also counted by model, in
`model_launches`.
Under a CUDA graph (solve/jit_newton.py) a wrapper called during the
capture launches nothing: `recording()` takes the counts it made out of
`launches` and `model_launches` and keeps them, and `replayed()` adds
them back at each replay of the graph, when the kernels do launch.
Kernel 1b, the implicit assembly, is four sources: `implicit_assembly.cu`
(the Hill, hyper_J2 and hypo_hill families), `implicit_eig.cu` (the
Hosford twins), `implicit_barlat.cu` (hypo_barlat) and
`implicit_hybrid.cu` (the hybrid with its embedded network), so that they
build in parallel.
`probe` (kernel 4, probe.py) lies on no solver path.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("fused_assembly", "implicit_assembly", "implicit_eig", "implicit_barlat",
           "implicit_hybrid", "ebe_matvec", "ell_spmv", "ell_spmv_T", "probe")
HEADERS = ("c8_dual.cuh", "c8_element.cuh", "c8_hill.cuh", "c8_hyper.cuh", "c8_hypo.cuh",
           "c8_implicit.cuh", "c8_eig.cuh", "c8_hosford.cuh", "c8_hybrid.cuh", "c8_ell.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)
# per-source flags.  The implicit kernel's local Newton stops a lane once
# ||C|| < abs_tol; without contraction into FMAs each of its operations
# rounds as the plain version's PyTorch operations do, so the two stop at
# the same iteration on more lanes (the hypo_hill plane-strain residual,
# in stress units, lands within rounding of abs_tol often enough for it to
# matter; PERF.md has the runs).
EXTRA_FLAGS = {name: ("-fmad=false",)
               for name in ("implicit_assembly", "implicit_eig", "implicit_barlat",
                            "implicit_hybrid")}

COUNTERS = KERNELS + ("ell_spmv_level", "ell_spmv_part", "assembly_elems")

launches = {name: 0 for name in COUNTERS}
# the assembly libraries' launches split by model: (counter, model name) ->
# count, added to beside `launches` where the wrapper launches
model_launches: dict[tuple[str, str], int] = {}

_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[str, object] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    model_launches.clear()


class Recorded:
    """The wrapper counts made while a CUDA graph was captured: what each
    replay of it launches."""

    def __init__(self):
        self.launches: dict[str, int] = {}
        self.model_launches: dict[tuple[str, str], int] = {}


@contextlib.contextmanager
def recording():
    """Around a CUDA graph's capture: yields a Recorded that holds, on
    exit, the counts the wrappers added inside, which are taken back out
    of `launches` and `model_launches` (a capture launches nothing)."""
    rec = Recorded()
    before, before_m = dict(launches), dict(model_launches)
    try:
        yield rec
    finally:
        rec.launches = {k: v - before[k] for k, v in launches.items() if v != before[k]}
        rec.model_launches = {k: v - before_m.get(k, 0) for k, v in model_launches.items()
                              if v != before_m.get(k, 0)}
        launches.update(before)
        model_launches.clear()
        model_launches.update(before_m)


def replayed(rec: Recorded, times: int = 1) -> None:
    """Count `times` replays of a graph whose capture recorded `rec`."""
    for k, v in rec.launches.items():
        launches[k] += v * times
    for k, v in rec.model_launches.items():
        model_launches[k] = model_launches.get(k, 0) + v * times


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named sources that have no up-to-date library, all in
    parallel.  Returns {name: seconds} for the ones built; raises with
    the compiler's output if any fails.  Each build's output (ptxas
    register and spill report included) is kept in _build/<name>.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{n}.log", "w")
        cmd = [nvcc, *_flags(n), "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    secs, failed = {}, []
    for n, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[n] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(n)
    if failed:
        msgs = "\n".join(
            f"--- {n} ---\n{(BUILD_DIR / f'{n}.log').read_text()[-4000:]}" for n in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return secs


def build_log(name: str) -> str:
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def function(lib_name: str, symbol: str, argtypes):
    """The C function `symbol` of library `lib_name` (built and loaded at
    first use), with its argtypes set and an int return (cudaError_t)."""
    key = f"{lib_name}:{symbol}"
    fn = _funcs.get(key)
    if fn is None:
        lib = _libs.get(lib_name)
        if lib is None:
            build((lib_name,))
            lib = ctypes.CDLL(str(_lib_path(lib_name)))
            lib.c8_error_string.argtypes = [ctypes.c_int]
            lib.c8_error_string.restype = ctypes.c_char_p
            _libs[lib_name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return fn


def check(lib_name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = _libs[lib_name].c8_error_string(err).decode()
        raise RuntimeError(f"{lib_name}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device` (a
    torch.device with its index).  Read without building a
    torch.cuda.Stream, which costs several microseconds of host time a
    launch on the card's machine."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def dtype_code(dtype) -> int:
    """0 for float32, 1 for float64 (the kernels' `dtype` argument)."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"the kernels take float32 or float64, got {dtype}")


def require(cond: bool, msg: str) -> None:
    """Validate a wrapper's inputs before pointers reach native code."""
    if not cond:
        raise ValueError(msg)
