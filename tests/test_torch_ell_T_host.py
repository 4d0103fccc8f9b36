"""The transposed ELL kernel's arithmetic (csrc/ell_spmv_T.cu) built for
the host with g++ (-ffp-contract=off) from csrc/c8_ell.cuh: G lanes per
output node emulated, each lane's c8::ell_T_lane_partial (a gather over
the node's own row through the transposed slot map tr_T) over the slots
g, g + G, ... < K, then the kernel's fixed xor tree (at each step, for
off = G/2, ..., 1, lane g adds lane g ^ off's partial), then lane 0's
sums written.

 - all five instances (D, NDPN) = (1, 1), (2, 2), (2, 3), (3, 3), (3, 4),
   each at G = 1, 2, 4, 8, on the ELL maps of cube n=2 tets (K = 15: pad
   slots, and K not a multiple of G) and notch2D h=0.3 (K = 8), against
   ell_spmv_T_plain (the scatter form, which does not read tr_T) at 1e-14
   of max|plain| in float64; A_T holds random values in the pad slots
   too, which no filled slot's tr_T points at and the kernel must not
   read;
 - c8::ell_T_lanes, the transposed kernel's launch rule, against its
   statement over a grid of (N, K, ndpn, word size) and at the node
   counts, widths and block sizes of the decks chip_smoke.py runs.

Skips where no g++ is found."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.solve.ellpack import ell_maps_from_conn, ell_spmv_T_plain

CSRC = Path(__file__).resolve().parents[1] / "calibr8_tpu_torch" / "csrc"

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "c8_ell.cuh"

template <typename T>
static std::vector<T> rd(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(2);
  return v;
}

template <int D, int NDPN>
static std::vector<double> spmv_T(int N, int K, int G, const double* A, const int* nbr,
                                  const int* tr, const double* x) {
  std::vector<double> y((size_t)N * NDPN), part((size_t)G * NDPN), next(part.size());
  for (int c = 0; c < N; ++c) {
    for (int g = 0; g < G; ++g)
      c8::ell_T_lane_partial<double, D, NDPN>(N, K, c, g, G, A, nbr, tr, x,
                                              &part[(size_t)g * NDPN]);
    for (int off = G / 2; off >= 1; off /= 2) {
      for (int g = 0; g < G; ++g)
        for (int j = 0; j < NDPN; ++j)
          next[g * NDPN + j] = part[g * NDPN + j] + part[(g ^ off) * NDPN + j];
      part.swap(next);
    }
    for (int j = 0; j < D; ++j) y[(size_t)c * D + j] = part[j];
    if (NDPN > D) y[(size_t)N * D + c] = part[NDPN - 1];
  }
  return y;
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  std::vector<int> hdr = rd<int>(f, 1);
  if (hdr[0] == 0) {  // the launch rule: (N, K, ndpn, word bytes) -> G
    const int n = rd<int>(f, 1)[0];
    std::vector<int> q = rd<int>(f, 4 * (size_t)n), g(n);
    for (int i = 0; i < n; ++i)
      g[i] = c8::ell_T_lanes(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
    fwrite(g.data(), sizeof(int), n, o);
  }
  for (int c = 0, n_cases = hdr[0]; c < n_cases; ++c) {
    std::vector<int> h = rd<int>(f, 5);  // D NDPN N K G
    const int D = h[0], P = h[1], N = h[2], K = h[3], G = h[4];
    std::vector<double> A = rd<double>(f, (size_t)K * P * P * N);
    std::vector<int> nbr = rd<int>(f, (size_t)K * N), tr = rd<int>(f, (size_t)K * N);
    std::vector<double> x = rd<double>(f, (size_t)N * P), y;
    const double *a = A.data(), *xp = x.data();
    const int *nb = nbr.data(), *t = tr.data();
    if (D == 1 && P == 1) y = spmv_T<1, 1>(N, K, G, a, nb, t, xp);
    else if (D == 2 && P == 2) y = spmv_T<2, 2>(N, K, G, a, nb, t, xp);
    else if (D == 2 && P == 3) y = spmv_T<2, 3>(N, K, G, a, nb, t, xp);
    else if (D == 3 && P == 3) y = spmv_T<3, 3>(N, K, G, a, nb, t, xp);
    else if (D == 3 && P == 4) y = spmv_T<3, 4>(N, K, G, a, nb, t, xp);
    else exit(3);
    fwrite(y.data(), sizeof(double), y.size(), o);
  }
  fclose(o);
  return 0;
}
"""

# (mesh, its transposed-ELL instances (D, NDPN))
MESHES = {
    "cube n=2": (lambda: generators.cube(2), ((3, 3), (3, 4), (1, 1))),
    "notch2D h=0.3": (lambda: generators.notch2d(0.3), ((2, 2), (2, 3), (1, 1))),
}
LANES = (1, 2, 4, 8)


def _maps(make):
    mesh = make()
    maps = ell_maps_from_conn(mesh.conn, mesh.n_nodes)
    return mesh.n_nodes, maps["K"], np.ascontiguousarray(maps["nbr"].T), \
        np.ascontiguousarray(maps["tr"].T)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harness of csrc/c8_ell.cuh")
    d = tmp_path_factory.mktemp("ell_T_host")
    src, exe = d / "harness.cpp", d / "harness"
    src.write_text(HARNESS)
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(CSRC), str(src),
                    "-o", str(exe)], check=True, capture_output=True, timeout=300)

    def run(arrays):
        inp, out = d / "in.bin", d / "out.bin"
        with open(inp, "wb") as fh:
            for a in arrays:
                fh.write(np.ascontiguousarray(a).tobytes())
        subprocess.run([str(exe), str(inp), str(out)], check=True, timeout=120)
        return out.read_bytes()

    return run


def test_gather_lanes_and_xor_tree_match_plain(harness):
    rng = np.random.default_rng(0)
    cases, arrays = [], []
    for name, (make, instances) in MESHES.items():
        N, K, nbr_T, tr_T = _maps(make)
        assert (nbr_T == N).any(), "no pad slots"
        for D, P in instances:
            A_T = rng.standard_normal((K, P, P, N))
            x = rng.standard_normal(N * P)
            for G in LANES:
                cases.append((name, D, P, G, A_T, nbr_T, x))
                arrays += [np.asarray([D, P, N, K, G], np.int32), A_T, nbr_T, tr_T, x]
    assert {(D, P) for _, D, P, *_ in cases} == {(1, 1), (2, 2), (2, 3), (3, 3), (3, 4)}
    assert any(nbr.shape[0] % G for *_, G, _, nbr, _ in cases)
    got_all = np.frombuffer(harness([np.asarray([len(cases)], np.int32)] + arrays), np.float64)
    at = 0
    for name, D, P, G, A_T, nbr_T, x in cases:
        got = got_all[at:at + x.size]
        at += x.size
        want = ell_spmv_T_plain(torch.tensor(A_T), torch.tensor(nbr_T), torch.tensor(x),
                                D).numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-14, (name, D, P, G, err)
    assert at == got_all.size


def rule(N, K, ndpn, word):
    """The transposed kernel's launch rule as its note states it: the
    forward rule's largest power of two G <= min(8, next_pow2(K)) with
    N * G <= 2^18 (2^17 for ndpn <= 2), with N * G * ndpn^2 <= 2^20 words
    in float64 (the forward rule's 2^21 halved) and 2^19 in float32, else
    1."""
    threads = 2 ** 17 if ndpn <= 2 else 2 ** 18
    words = 2 ** 20 if word == 8 else 2 ** 19
    G = 1
    while G < min(8, K):
        G *= 2
    while G > 1 and (N * G > threads or N * G * ndpn ** 2 > words):
        G //= 2
    return G


# (N, K, ndpn, word bytes) of the decks chip_smoke.py runs through the
# transposed kernel, with the lanes the rule gives them
DECKS = {
    "cube n=32 mixed u/p, float64": ((35937, 15, 4, 8), 1),
    "cube n=32 mixed u/p, float32": ((35937, 15, 4, 4), 1),
    "cube n=32 isotropic_elastic, float64": ((35937, 15, 3, 8), 2),
    "cube n=32 isotropic_elastic, float32": ((35937, 15, 3, 4), 1),
    "cube MG fine level, mixed u/p": ((35937, 21, 4, 8), 1),
    "cube MG fine p block": ((35937, 21, 1, 8), 2),
    "cube MG level 1 u": ((4913, 19, 3, 8), 8),
    "cube MG level 1 p": ((4913, 19, 1, 8), 8),
    "notch2D h=0.004 mixed u/p": ((70429, 8, 3, 8), 1),
    "notch2D h=0.004 displacement only": ((70429, 8, 2, 8), 1),
    "notch2D MG level 1": ((17621, 8, 2, 8), 4),
}


def test_launch_rule(harness):
    grid = [(N, K, P, w) for N in (1, 27, 125, 4913, 16384, 16385, 32768, 32769, 65536, 65537,
                                   131072, 131073, 262144, 262145, 10 ** 6)
            for K in (1, 2, 3, 5, 8, 9, 15, 21) for P in (1, 2, 3, 4) for w in (4, 8)]
    quads = grid + [q for q, _ in DECKS.values()]
    buf = harness([np.asarray([0, len(quads)], np.int32), np.asarray(quads, np.int32)])
    got = dict(zip(quads, np.frombuffer(buf, np.int32).tolist()))
    for q in grid:
        assert got[q] == rule(*q), q
    for label, (q, G) in DECKS.items():
        assert got[q] == G, label
