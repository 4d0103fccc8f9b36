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
A counter is named after its kernel's source, except `ell_spmv_level`:
the multigrid level apply (calibr8_tpu's kernel 3c, LevelEllOperator)
launches the kernels of `ell_spmv.cu` on level shapes and counts apart.
"""

from __future__ import annotations

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
KERNELS = ("fused_assembly", "implicit_assembly", "ebe_matvec", "ell_spmv", "ell_spmv_T")
HEADERS = ("c8_dual.cuh", "c8_element.cuh", "c8_hill.cuh", "c8_hyper.cuh", "c8_implicit.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

COUNTERS = KERNELS + ("ell_spmv_level",)

launches = {name: 0 for name in COUNTERS}

_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[str, object] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
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
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


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
