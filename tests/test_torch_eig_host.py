"""The CUDA eigensolver code (csrc/c8_eig.cuh, with c8_dual.cuh) built for
the host with g++ and held against the port's plain versions on this
CPU: eig_sym33, hosford_phi_n and barlat_phi_n, values and Dual<double,
1> tangents, on tests/test_torch_eig.py's seeded batches.  The element
code is __host__ __device__ (C8_HD is `inline` off nvcc), so the same
source the kernel runs is compiled for the host, without FMA contraction
(-ffp-contract=off), as the kernel library is built (-fmad=false).
Compared: eigenvalues, eigenvectors, phi and the normal on the lanes with
distinct eigenvalues or an equal lower pair, to 1e-13 of their max, and
their tangents to 1e-12 (1e-7 for the vectors' and normal's tangents at
an equal pair, tests/test_torch_eig.py says why); Barlat, which reads the
transformed stresses' spectra, on every lane but the hydrostatic ones.
Skips where no g++ is found."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import calibr8_tpu_torch.models.batched as TB
from tests.test_torch_eig import A_EXP, DP, SP, sym_batches

CSRC = Path(__file__).resolve().parents[1] / "calibr8_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include <vector>
#include "c8_eig.cuh"

typedef c8::Dual<double, 1> D1;

static void put(FILE* o, const D1& x) { fwrite(&x.v, 8, 1, o); fwrite(&x.d[0], 8, 1, o); }

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int n;
  if (fread(&n, 4, 1, f) != 1) return 1;
  std::vector<double> A(9 * n), dA(9 * n);
  double a, sp[9], dp[9];
  if (fread(A.data(), 8, 9 * n, f) != size_t(9 * n) || fread(dA.data(), 8, 9 * n, f) != size_t(9 * n)
      || fread(&a, 8, 1, f) != 1 || fread(sp, 8, 9, f) != 9 || fread(dp, 8, 9, f) != 9)
    return 1;
  fclose(f);
  FILE* o = fopen(argv[2], "wb");
  for (int e = 0; e < n; ++e) {
    D1 M[3][3], lam[3], V[3][3], dv[3][3], nn[6];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        M[i][j] = D1(A[9 * e + 3 * i + j]);
        M[i][j].d[0] = dA[9 * e + 3 * i + j];
      }
    c8::eig_sym33(M, lam, V);
    for (int i = 0; i < 3; ++i) put(o, lam[i]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) put(o, V[i][j]);
    c8::dev3(M, dv);
    put(o, c8::hosford_phi_n(M, dv, a, nn));
    for (int k = 0; k < 6; ++k) put(o, nn[k]);
    put(o, c8::barlat_phi_n(M, sp, dp, a, nn));
    for (int k = 0; k < 6; ++k) put(o, nn[k]);
  }
  fclose(o);
  return 0;
}
"""

VOIGT = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _plain(A, dA):
    """The plain versions' [value, tangent] pairs, in the harness's order:
    lam (3), V (3, 3), hosford phi, n (6), barlat phi, n (6); each (n,)."""
    E = A.shape[-1]
    full = [torch.full((E,), c, dtype=A.dtype) for c in SP + DP]
    a = torch.full((E,), A_EXP, dtype=A.dtype)

    def fn(A):
        lam, V = TB.t_eig_sym33(A)
        ph, nh = TB.t_hosford_phi_n(A, TB.t_dev3(A), a)
        pb, nb = TB.t_barlat_phi_n(A, tuple(full[:9]), tuple(full[9:]), a)
        return torch.stack([*lam, *(V[i][j] for i in range(3) for j in range(3)), ph,
                            *(nh[i, j] for i, j in VOIGT), pb, *(nb[i, j] for i, j in VOIGT)])

    return torch.func.jvp(fn, (A,), (dA,))


def test_cuda_eig_code_on_host_matches_plain(tmp_path):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harness of csrc/c8_eig.cuh")
    src = tmp_path / "eig_harness.cpp"
    src.write_text(HARNESS)
    exe = tmp_path / "eig_harness"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(CSRC), str(src),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)
    rng = np.random.default_rng(1)
    seen = 0
    for kind, A in sym_batches().items():
        n = A.shape[-1]
        dA = rng.standard_normal(A.shape)
        dA = 0.5 * (dA + dA.transpose(1, 0, 2))
        inp = tmp_path / f"{kind}.in"
        with open(inp, "wb") as f:
            f.write(np.int32(n).tobytes())
            f.write(np.ascontiguousarray(np.moveaxis(A, -1, 0)).tobytes())
            f.write(np.ascontiguousarray(np.moveaxis(dA, -1, 0)).tobytes())
            f.write(np.array((A_EXP,) + SP + DP).tobytes())
        out = tmp_path / f"{kind}.out"
        subprocess.run([str(exe), str(inp), str(out)], check=True, timeout=60)
        got = np.fromfile(out).reshape(n, 26, 2).transpose(1, 2, 0)  # (26, value/tangent, n)
        val, tan = (v.numpy() for v in _plain(torch.tensor(A), torch.tensor(dA)))
        lam = np.sort(np.linalg.eigvalsh(np.moveaxis(A, -1, 0)), axis=-1)[:, ::-1].T
        gap = np.abs(np.diff(lam, axis=0)) <= 1e-9 * np.abs(lam).max()
        lower = gap[1] & ~gap[0]
        ok = ~gap[0]  # distinct, or an equal lower pair
        barlat = np.full(n, kind != "three_equal")
        # (rows, lanes, whether the rows are vectors or the normal): lam,
        # V, Hosford's phi and n, Barlat's phi and n
        for lo, hi, lanes, vec in ((0, 3, ok, False), (3, 12, ok, True), (12, 13, ok, False),
                                   (13, 19, ok, True), (19, 20, barlat, False),
                                   (20, 26, barlat, False)):
            if not lanes.any():
                continue
            seen += 1
            g, v, t = got[lo:hi][..., lanes], val[lo:hi][:, lanes], tan[lo:hi][:, lanes]
            assert np.abs(g[:, 0] - v).max() <= 1e-13 * np.abs(v).max(), (kind, lo)
            tol = np.where(vec & lower[lanes], 1e-7, 1e-12)
            assert (np.abs(g[:, 1] - t) <= tol * np.abs(t).max()).all(), (kind, lo)
    assert seen >= 6
