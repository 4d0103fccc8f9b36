"""The forward ELL kernel's arithmetic (csrc/ell_spmv.cu) built for the
host with g++ (-ffp-contract=off) from csrc/c8_ell.cuh: G lanes per node
emulated, each lane's c8::ell_lane_partial over the slots g, g + G, ...
< K, then the kernel's fixed xor tree (at each step, for off = G/2, ...,
1, lane g adds lane g ^ off's partial), then lane 0's sums written.

 - all seven instances (D, NDPN) = (1, 1), (2, 2), (2, 3), (3, 3), (3, 4),
   (4, 4), (6, 6), each at G = 1, 2, 4, 8, on the ELL maps of cube n=2 tets
   (K = 15: pad slots, and K not a multiple of G) and notch2D h=0.3
   (K = 8), and the (6, 6) instance of the 3D rigid-mode AMG levels (2
   slots a batch, c8::ell_batch) on the level-1 and level-2 patterns of
   the aggregation AMG of cube n=8 (solve/amg.py), against ell_spmv_plain
   (u block, then p block) and
   level_ell_spmv_plain (node-interleaved) at 1e-14 of max|plain| in
   float64; A_T holds random values in the pad slots too, which the plain
   version's zero row of x cancels and the kernel must not read;
 - c8::ell_lanes, the launch rule, against its statement over a grid of
   (N, K, ndpn, word size) and at the node counts, widths and block sizes
   of the decks chip_smoke.py runs.

Skips where no g++ is found."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.mesh import generators
from calibr8_tpu_torch.problem import Problem
from calibr8_tpu_torch.solve.amg import AMGPrecondFactory
from calibr8_tpu_torch.solve.ellpack import (
    ell_maps_from_conn, ell_spmv_plain, level_ell_spmv_plain,
)
from tests.decks import BCS_3D, J2_MAT, make_deck

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
static std::vector<double> spmv(int N, int K, int G, const double* A, const int* nbr,
                                const double* x) {
  std::vector<double> y((size_t)N * NDPN), part((size_t)G * NDPN), next(part.size());
  for (int n = 0; n < N; ++n) {
    for (int g = 0; g < G; ++g) c8::ell_lane_partial<double, D, NDPN>(N, K, n, g, G, A, nbr, x,
                                                                       &part[(size_t)g * NDPN]);
    for (int off = G / 2; off >= 1; off /= 2) {
      for (int g = 0; g < G; ++g)
        for (int i = 0; i < NDPN; ++i)
          next[g * NDPN + i] = part[g * NDPN + i] + part[(g ^ off) * NDPN + i];
      part.swap(next);
    }
    for (int i = 0; i < D; ++i) y[(size_t)n * D + i] = part[i];
    if (NDPN > D) y[(size_t)N * D + n] = part[NDPN - 1];
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
      g[i] = c8::ell_lanes(q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]);
    fwrite(g.data(), sizeof(int), n, o);
  }
  for (int c = 0, n_cases = hdr[0]; c < n_cases; ++c) {
    std::vector<int> h = rd<int>(f, 5);  // D NDPN N K G
    const int D = h[0], P = h[1], N = h[2], K = h[3], G = h[4];
    std::vector<double> A = rd<double>(f, (size_t)K * P * P * N);
    std::vector<int> nbr = rd<int>(f, (size_t)K * N);
    std::vector<double> x = rd<double>(f, (size_t)N * P), y;
    if (D == 1 && P == 1) y = spmv<1, 1>(N, K, G, A.data(), nbr.data(), x.data());
    else if (D == 2 && P == 2) y = spmv<2, 2>(N, K, G, A.data(), nbr.data(), x.data());
    else if (D == 2 && P == 3) y = spmv<2, 3>(N, K, G, A.data(), nbr.data(), x.data());
    else if (D == 3 && P == 3) y = spmv<3, 3>(N, K, G, A.data(), nbr.data(), x.data());
    else if (D == 3 && P == 4) y = spmv<3, 4>(N, K, G, A.data(), nbr.data(), x.data());
    else if (D == 4 && P == 4) y = spmv<4, 4>(N, K, G, A.data(), nbr.data(), x.data());
    else if (D == 6 && P == 6) y = spmv<6, 6>(N, K, G, A.data(), nbr.data(), x.data());
    else exit(3);
    fwrite(y.data(), sizeof(double), y.size(), o);
  }
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host harness of csrc/c8_ell.cuh")
    d = tmp_path_factory.mktemp("ell_host")
    src = d / "harness.cpp"
    src.write_text(HARNESS)
    exe = d / "harness"
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


def mesh_pattern(mesh):
    """(N, K, nbr_T) of a mesh's node-block ELL maps."""
    maps = ell_maps_from_conn(mesh.conn, mesh.n_nodes)
    return mesh.n_nodes, maps["K"], np.ascontiguousarray(maps["nbr"].T)


def amg_patterns():
    """(N, K, nbr_T) of the aggregation AMG's levels 1 and 2 on cube n=8
    (coarse_cutoff 20, so that there are two)."""
    deck = make_deck({"type": "cube", "n": 8}, "small_J2", J2_MAT, BCS_3D(0.001), 1)
    disc = Problem(load_deck(deck), device="cpu").disc
    levels = AMGPrecondFactory(disc, coarse_cutoff=20).levels
    return [(lv.n, lv.K, np.ascontiguousarray(lv.nbr.T)) for lv in levels[:2]]


# (pattern(s), the ELL instances (D, NDPN) run on them)
MESHES = {
    "cube n=2": (lambda: [mesh_pattern(generators.cube(2))], ((3, 3), (3, 4), (1, 1), (4, 4))),
    "notch2D h=0.3": (lambda: [mesh_pattern(generators.notch2d(0.3))], ((2, 2), (2, 3), (1, 1))),
    # after the others, so that their seeded inputs stay as they were
    "cube n=2, rigid modes": (lambda: [mesh_pattern(generators.cube(2))], ((6, 6),)),
    "cube n=8 AMG levels 1, 2": (amg_patterns, ((6, 6),)),
}
LANES = (1, 2, 4, 8)


def test_lane_partials_and_xor_tree_match_plain(harness):
    rng = np.random.default_rng(0)
    cases, arrays = [], []
    patterns = [(name, pat, instances) for name, (make, instances) in MESHES.items()
                for pat in make()]
    # pad slots in every pattern but the last, the small level 2
    assert all((nbr_T == N).any() for _, (N, K, nbr_T), _ in patterns[:-1]), "no pad slots"
    for name, (N, K, nbr_T), instances in patterns:
        for D, P in instances:
            A_T = rng.standard_normal((K, P, P, N))
            x = rng.standard_normal(N * P)
            for G in LANES:
                cases.append((name, D, P, G, A_T, nbr_T, x))
                arrays += [np.asarray([D, P, N, K, G], np.int32), A_T, nbr_T.astype(np.int32), x]
    assert {(D, P) for _, D, P, *_ in cases} == {(1, 1), (2, 2), (2, 3), (3, 3), (3, 4), (4, 4),
                                                  (6, 6)}
    assert any(nbr.shape[0] % G for *_, G, _, nbr, _ in cases)
    out = np.frombuffer(harness([np.asarray([len(cases)], np.int32)] + arrays), np.float64)
    at = 0
    for name, D, P, G, A_T, nbr_T, x in cases:
        got = out[at:at + x.size]
        at += x.size
        args = (torch.tensor(A_T), torch.tensor(nbr_T), torch.tensor(x))
        want = (ell_spmv_plain(*args, D) if P > D else level_ell_spmv_plain(*args, P)).numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-14, (name, D, P, G, err)
    assert at == out.size


def rule(N, K, ndpn, word):
    """The launch rule as the kernel's note states it: the largest power of
    two G <= min(8, next_pow2(K)) with N * G <= 2^18 (2^17 for ndpn <= 2)
    and N * G * ndpn^2 <= 2^21 words in float64 (2^19 in float32), else
    1."""
    threads = 2 ** 17 if ndpn <= 2 else 2 ** 18
    words = 2 ** 21 if word == 8 else 2 ** 19
    G = 1
    while G < min(8, K):
        G *= 2
    while G > 1 and (N * G > threads or N * G * ndpn ** 2 > words):
        G //= 2
    return G


# (N, K, ndpn, word bytes) of the decks chip_smoke.py runs, with the lanes
# the rule gives them
DECKS = {
    "cube n=32 mixed u/p (3a), float64": ((35937, 15, 4, 8), 2),
    "cube n=32 mixed u/p (3a), float32": ((35937, 15, 4, 4), 1),
    "cube n=32 isotropic_elastic (3a)": ((35937, 15, 3, 8), 4),
    "cube MG fine level, mixed u/p (3a)": ((35937, 21, 4, 8), 2),
    "cube MG fine p block (3c)": ((35937, 21, 1, 8), 2),
    "cube MG level 1 u (3c)": ((4913, 19, 3, 8), 8),
    "cube MG level 1 p (3c)": ((4913, 19, 1, 8), 8),
    "cube MG level 2 u (3c)": ((729, 17, 3, 8), 8),
    "notch2D h=0.004 mixed u/p (3a)": ((70429, 8, 3, 8), 2),
    "notch2D h=0.004 displacement only (3a)": ((70429, 8, 2, 8), 1),
    "notch2D MG level 1 (3c)": ((17621, 8, 2, 8), 4),
    "notch2D MG level 2 (3c)": ((4467, 8, 2, 8), 8),
    "cube n=32, 8 parts (3c per part)": ((45952, 15, 4, 8), 2),
    "notch2D h=0.004, 8 parts (3c per part)": ((74496, 8, 3, 8), 2),
    "bench deck AMG level 1 u (3c, (6, 6))": ((1331, 25, 6, 8), 8),
    "bench deck AMG level 1 u (3c, (6, 6)), float32": ((1331, 25, 6, 4), 8),
    "bench deck AMG level 2 u (3c, (6, 6))": ((59, 22, 6, 8), 8),
    "bench deck AMG level 1 p (3c)": ((1331, 25, 1, 8), 8),
    "notch2D h=0.004 AMG level 1 (3c, (3, 3))": ((8106, 9, 3, 8), 8),
    "notch2D h=0.004 AMG level 2 (3c, (3, 3))": ((1032, 9, 3, 8), 8),
}


def test_launch_rule(harness):
    grid = [(N, K, P, w) for N in (1, 27, 125, 4913, 32768, 32769, 65536, 65537, 131072,
                                   131073, 262144, 262145, 10 ** 6)
            for K in (1, 2, 3, 5, 8, 9, 15, 21) for P in (1, 2, 3, 4, 6) for w in (4, 8)]
    quads = grid + [q for q, _ in DECKS.values()]
    buf = harness([np.asarray([0, len(quads)], np.int32), np.asarray(quads, np.int32)])
    got = dict(zip(quads, np.frombuffer(buf, np.int32).tolist()))
    for q in grid:
        assert got[q] == rule(*q), q
    for label, (q, G) in DECKS.items():
        assert got[q] == G, label
