// One lane's share of the node-block ELLPACK product y = A x, and the rule
// that sets how many lanes share a node (csrc/ell_spmv.cu); below it, one
// lane's share of the transposed product y = A^T x (csrc/ell_spmv_T.cu).
//
//   y[i, n] = sum_{s, j} A_T[s, i, j, n] * x[nbr_T[s, n], j]
//
// with A_T (K, NDPN, NDPN, N) node last, nbr_T (K, N) int32 slot-major,
// pad id N; x and y flat: the u block x[c * D + j] and, when NDPN == D + 1,
// the p block x[N * D + c] (NDPN == D: node-interleaved).
//
// G lanes share node n: lane g of them takes the slots g, g + G, g + 2G,
// ... < K, U at a time (ell_batch: 4 for ndpn <= 4, 2 for the 6 x 6
// blocks of the 3D rigid-mode levels).  For each batch it loads the
// neighbour ids first, then their x values and A blocks, then does the
// multiply-adds, so the loads of U slots are in flight together and not
// one slot's after another's.  A pad slot (id N) is predicated, not
// skipped: its x values are 0 and its A block is not read (taken as 0),
// which is the plain version's zero row for x whatever A_T holds there.
// Each lane adds its slots in slot order; the kernel then sums the G
// partials with a fixed xor tree (ell_spmv.cu), so y is the same bit for
// bit from run to run.
//
// Everything here is __host__ __device__ (C8_HD), so a host C++ compiler
// builds it for checking without a card (tests/test_torch_ell_host.py,
// tests/test_torch_ell_T_host.py).
#pragma once

#include "c8_dual.cuh"

namespace c8 {

// Largest lanes per node: a node has at most K slots to share out.
constexpr int ELL_MAX_LANES = 8;

// The largest power of two G <= min(ELL_MAX_LANES, next_pow2(K)) with
// N * G <= threads and N * G * ndpn^2 <= words (A words in flight); 1
// where N alone passes them.
C8_HD int ell_lanes_within(int N, int K, int ndpn, long long threads, long long words) {
  int G = 1;
  while (G < K && G < ELL_MAX_LANES) G *= 2;
  while (G > 1 && ((long long)N * G > threads || (long long)N * G * ndpn * ndpn > words)) G /= 2;
  return G;
}

// Lanes per node of the forward kernel, for N nodes of K slots, ndpn x
// ndpn blocks of `word` bytes: the largest power of two G <=
// min(ELL_MAX_LANES, next_pow2(K)) with N * G <= 2^18 threads (2^17 for
// ndpn <= 2) and N * G * ndpn^2 <= 2^21 words in float64 (2^19 in
// float32); 1 where N alone passes them.  Set from the sweep of G = 1,
// 2, 4, 8 at the decks' shapes on an H100 (calibr8_tpu_torch/ell_sweep.py,
// PERF.md), on device times with the L2 flushed before each call, as on
// the Krylov path, where the other kernels evict A_T between two
// products, and back to back.  Few nodes (the multigrid levels of 125 to
// 4,913 nodes) want many lanes, so that the card has warps enough to keep
// loads in flight (~2 MB: 3.35 TB/s x ~0.6 us, Little's law).  Many
// nodes want few: a lane's batch of 4 slots already has 4 ndpn^2 loads of
// A in flight, and more lanes cut each warp-wide read of A_T into shorter
// runs (32 / G nodes).  2^18 threads is about one wave of resident
// threads (132 SMs x 2048); thin blocks (ndpn <= 2, 1-4 words a slot) did
// best with half that; float64 cube n=32 (35,937 nodes) at G = 2 for
// ndpn 4 and G = 4 for ndpn 3, float32 there at G = 1.
C8_HD int ell_lanes(int N, int K, int ndpn, int word) {
#ifdef C8_ELL_LANES
  // a build with the lanes fixed, for the sweep of ell_sweep.py
  return C8_ELL_LANES;
#else
  return ell_lanes_within(N, K, ndpn, ndpn <= 2 ? 1LL << 17 : 1LL << 18,
                          word >= 8 ? 1LL << 21 : 1LL << 19);
#endif
}

// Lanes per node of the transposed kernel (csrc/ell_spmv_T.cu): the same
// rule with the float64 cap on A words in flight halved, N * G * ndpn^2
// <= 2^20 (float32 keeps 2^19).  Set from the sweep of G = 1, 2, 4, 8 at
// the transposed kernel's shapes on an H100 (ell_sweep.py, PERF.md), with
// the L2 flushed before each call: the gather's reads of A_T at (tr, i, j,
// m) are already scattered across the warp, and more lanes per node cut
// them into still shorter runs, so float64 cube n=32 did best at G = 2
// for ndpn 3 (the forward rule's 4 read ~1.16x) and within 4% at G = 1
// for ndpn 4; the small levels still want 8.
C8_HD int ell_T_lanes(int N, int K, int ndpn, int word) {
#ifdef C8_ELL_LANES
  return C8_ELL_LANES;
#else
  return ell_lanes_within(N, K, ndpn, ndpn <= 2 ? 1LL << 17 : 1LL << 18,
                          word >= 8 ? 1LL << 20 : 1LL << 19);
#endif
}

// A read through the read-only path on the card.
template <typename T>
C8_HD T ell_ld(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Where x holds dof j of node c.
template <int D>
C8_HD size_t ell_xdof(size_t N, int c, int j) {
  return j < D ? (size_t)c * D + j : N * D + c;
}

// The slots s0, s0 + G, ..., s0 + (U - 1) G of node n added into acc, in
// that order; FULL: all U are < K (else the ones >= K count as pads).
template <typename T, int D, int NDPN, int U, bool FULL>
C8_HD void ell_slot_batch(int N, int K, int n, int s0, int G, const T* __restrict__ A_T,
                          const int* __restrict__ nbr_T, const T* __restrict__ x,
                          T acc[NDPN]) {
  const size_t NN = (size_t)N;
  int c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = s0 + u * G;
    c[u] = (FULL || s < K) ? ell_ld(nbr_T + (size_t)s * NN + n) : N;
  }
  T xv[U][NDPN];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < NDPN; ++j) xv[u][j] = c[u] < N ? ell_ld(x + ell_xdof<D>(NN, c[u], j)) : T(0);
  T a[U][NDPN * NDPN];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* As = A_T + (size_t)(s0 + u * G) * NDPN * NDPN * NN + n;
#pragma unroll
    for (int k = 0; k < NDPN * NDPN; ++k) a[u][k] = c[u] < N ? ell_ld(As + (size_t)k * NN) : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < NDPN; ++i)
#pragma unroll
      for (int j = 0; j < NDPN; ++j) acc[i] = acc[i] + a[u][i * NDPN + j] * xv[u][j];
}

// Slots a lane takes per batch, U: U * NDPN^2 words of A loaded together.
// 4 up to NDPN = 4 (64 words); the 6 x 6 blocks of the 3D rigid-mode AMG
// levels take 2 (72 words): at 4, the 144 doubles of A alone would pass
// the 255-register cap.  At 2, ptxas for sm_90a gives the (6, 6) instance
// 80 registers in float64 and 126-128 in float32, no spill (PERF.md).
template <int NDPN>
C8_HD constexpr int ell_batch() {
  return NDPN <= 4 ? 4 : 2;
}

// Lane g's partial sums of node n over the slots g, g + G, ... < K.
template <typename T, int D, int NDPN>
C8_HD void ell_lane_partial(int N, int K, int n, int g, int G, const T* __restrict__ A_T,
                            const int* __restrict__ nbr_T, const T* __restrict__ x,
                            T acc[NDPN]) {
  constexpr int U = ell_batch<NDPN>();
#pragma unroll
  for (int i = 0; i < NDPN; ++i) acc[i] = T(0);
  int s = g;
  for (; s + (U - 1) * G < K; s += U * G)
    ell_slot_batch<T, D, NDPN, U, true>(N, K, n, s, G, A_T, nbr_T, x, acc);
  if (s < K) ell_slot_batch<T, D, NDPN, U, false>(N, K, n, s, G, A_T, nbr_T, x, acc);
}

// The transposed product y = A^T x as a gather over output node c's own
// row.  The pattern is structurally symmetric (m is in row c exactly
// when c is in row m), so with tr_T (K, N) int32 the slot of c in row
// m = nbr_T[t, c] (solve/ellpack.py transposed_slots; 0 in the pads):
//
//   y[j, c] = sum_{t, i} A_T[tr_T[t, c], i, j, m] * x[m, i]
//
// Every A_T block of a filled slot is read by exactly one (c, t), and
// each output node is summed by its own lanes in a fixed order, then
// stored once.  The lanes and batches are the forward kernel's: lane g
// of G takes the slots g, g + G, ... < K, U = 4 at a time, the ids
// (nbr_T, tr_T) first, then x at m and the ndpn^2 words of A_T at (tr, .,
// ., m), then the multiply-adds.  A pad slot (id N) is predicated: x is 0
// there and A is not read, so A_T may hold anything in its pad slots.

// The slots t0, t0 + G, ..., t0 + (U - 1) G of output node c added into
// acc, in that order; FULL: all U are < K (else the ones >= K count as
// pads).
template <typename T, int D, int NDPN, int U, bool FULL>
C8_HD void ell_T_slot_batch(int N, int K, int c, int t0, int G, const T* __restrict__ A_T,
                            const int* __restrict__ nbr_T, const int* __restrict__ tr_T,
                            const T* __restrict__ x, T acc[NDPN]) {
  const size_t NN = (size_t)N;
  int m[U], r[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = t0 + u * G;
    const bool in = FULL || t < K;
    m[u] = in ? ell_ld(nbr_T + (size_t)t * NN + c) : N;
    r[u] = in ? ell_ld(tr_T + (size_t)t * NN + c) : 0;
  }
  T xv[U][NDPN];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < NDPN; ++i) xv[u][i] = m[u] < N ? ell_ld(x + ell_xdof<D>(NN, m[u], i)) : T(0);
  T a[U][NDPN * NDPN];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const size_t at = m[u] < N ? (size_t)r[u] * NDPN * NDPN * NN + m[u] : 0;
#pragma unroll
    for (int k = 0; k < NDPN * NDPN; ++k)
      a[u][k] = m[u] < N ? ell_ld(A_T + at + (size_t)k * NN) : T(0);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < NDPN; ++j)
#pragma unroll
      for (int i = 0; i < NDPN; ++i) acc[j] = acc[j] + a[u][i * NDPN + j] * xv[u][i];
}

// Lane g's partial sums of output node c of y = A^T x over the slots g,
// g + G, ... < K.
template <typename T, int D, int NDPN>
C8_HD void ell_T_lane_partial(int N, int K, int c, int g, int G, const T* __restrict__ A_T,
                              const int* __restrict__ nbr_T, const int* __restrict__ tr_T,
                              const T* __restrict__ x, T acc[NDPN]) {
  constexpr int U = 4;
#pragma unroll
  for (int j = 0; j < NDPN; ++j) acc[j] = T(0);
  int t = g;
  for (; t + (U - 1) * G < K; t += U * G)
    ell_T_slot_batch<T, D, NDPN, U, true>(N, K, c, t, G, A_T, nbr_T, tr_T, x, acc);
  if (t < K) ell_T_slot_batch<T, D, NDPN, U, false>(N, K, c, t, G, A_T, nbr_T, tr_T, x, acc);
}

}  // namespace c8
