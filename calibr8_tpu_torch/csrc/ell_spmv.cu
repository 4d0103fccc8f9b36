// Node-block ELLPACK sparse matrix-vector product, forward.
//
// Replaces calibr8_tpu's Pallas kernel _make_kernel
// (solve/ellpack.py:437, forward body :442-454, pallas_call at :491):
//   y[i, n] = sum_{s, j} A_T[s, i, j, n] * x[nbr[n, s], j]
// over the K neighbour slots of node n, with i, j the ndpn dofs of a
// node (u_0..u_{d-1}, p).  The TPU version gathered the neighbour values
// into a (K, ndpn, N) array first (gather_T, :149-177); here the lanes
// of a node read its neighbours' values straight from the flat dof
// vector (u block then p block) and write its ndpn results straight into
// the flat y, so there is no gathered copy and no scatter.
//
// What bounds it on an H100: reading A_T once (K * ndpn^2 words per
// node; 69 MB at K = 15, 35,937 nodes, float64, >= 0.02 ms at
// 3.35 TB/s); 2 flops per entry, 0.25 flop/byte in float64.  No entry
// of A_T is used twice and x (at most ~1.2 MB) stays in the 50 MB L2, so
// tensor cores (wgmma), shared-memory staging and a TMA ring have nothing
// to reuse: the lever is memory-level parallelism, enough loads in
// flight (~2 MB over the card, 3.35 TB/s x ~0.6 us) to cover the
// latency of each slot's chain (the neighbour id, then x at that id).
//
// The design (c8_ell.cuh): G lanes per node, G in {1, 2, 4, 8} from
// c8::ell_lanes (N, K, ndpn and the word size), blocks of 128.  Inside
// a warp the node index is fastest: lane l takes node warp_base + l mod
// (32 / G) and the slots l div (32 / G), + G, ...; each warp-wide read
// of A_T and nbr_T is then G runs of 32 / G consecutive addresses, whole
// 32-byte sectors.  Each lane takes its slots 4 at a time, ids first,
// then x and A, then the multiply-adds, so 4 slots' loads are in flight
// at once.  Pad slots (neighbour id N, the pad sentinel, :113 there) are
// predicated: x is 0 there and A is not read.  A_T, nbr_T and x go
// through the read-only path (__ldg).  The G partials of a node are
// summed across its lanes with __shfl_xor_sync in a fixed order, no
// atomics, so y is the same bit for bit from run to run.  A node's lanes
// sit 32 / G apart in the warp, so the tree's steps exchange over
// distances 32 / G * (G / 2, ..., 1).
//
// The same kernel is calibr8_tpu's kernel 3c, the multigrid level apply
// (LevelEllOperator, solve/ellpack.py:322-409, called from solve/mg.py):
// a level vector is node-interleaved, x[n * m + j], which is this
// kernel's layout with NDPN == D == m, so the level instances are
// (m, m) = (1, 1) for the pressure chain and the fine pressure block and
// (2, 2), (3, 3) for the displacement chains.  The aggregation AMG's
// levels (solve/amg.py) carry d(d+1)/2 rigid-body modes per aggregate:
// (3, 3) in 2D and (6, 6) in 3D, whose lanes take 2 slots per batch
// (c8::ell_batch) so that the 72 words of A in flight stay in registers.
// The levels are small (125 to 35,937 nodes on the cube MG deck), so the
// small ones are bound by the launch, not by bytes.
//
// And it is kernel 3c per part, the local apply of the domain-decomposed
// solver (parallel/dist.py:445-471 there, calibr8_tpu_torch/parallel/
// dist.py here): every part's local node space [owned | ghost] is laid
// end to end into one node space of P * N_loc nodes, the neighbour ids
// offset by p * N_loc and one pad sentinel shared, so one launch of the
// (m, m) instance with m = ndpn applies every part's matrix to the
// node-interleaved local vectors.  3D mixed u/p gives m = 4: the (4, 4)
// instance.
//
// C interface, bound with ctypes (calibr8_tpu_torch/solve/ellpack.py).

#include <cuda_runtime.h>

#include "c8_ell.cuh"

namespace {

constexpr int BLOCK = 128;

template <typename T, int D, int NDPN, int G>
__global__ void __launch_bounds__(BLOCK) ell_spmv_kernel(
    int N, int K, const T* __restrict__ A_T, const int* __restrict__ nbr_T,
    const T* __restrict__ x, T* __restrict__ y) {
  constexpr int NPW = 32 / G;  // nodes per warp
  const int lane = threadIdx.x & 31;
  const int g = lane / NPW;
  const int n = (blockIdx.x * (BLOCK / 32) + threadIdx.x / 32) * NPW + lane % NPW;
  T acc[NDPN];
  if (n < N) {
    c8::ell_lane_partial<T, D, NDPN>(N, K, n, g, G, A_T, nbr_T, x, acc);
  } else {
#pragma unroll
    for (int i = 0; i < NDPN; ++i) acc[i] = T(0);
  }
  // every lane of the warp takes part in the exchange (full mask)
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2)
#pragma unroll
    for (int i = 0; i < NDPN; ++i) acc[i] = acc[i] + __shfl_xor_sync(0xffffffffu, acc[i], off * NPW);
  if (g != 0 || n >= N) return;
#pragma unroll
  for (int i = 0; i < D; ++i) y[(size_t)n * D + i] = acc[i];
  if (NDPN > D) y[(size_t)N * D + n] = acc[NDPN - 1];
}

template <typename T, int D, int NDPN>
int launch_g(int G, int N, int K, const void* A_T, const void* nbr_T, const void* x, void* y,
             cudaStream_t s) {
  const int grid = (int)(((long long)N * G + BLOCK - 1) / BLOCK);
#define C8_LAUNCH(GG)                                                                  \
  ell_spmv_kernel<T, D, NDPN, GG><<<grid, BLOCK, 0, s>>>(N, K, (const T*)A_T,          \
                                                         (const int*)nbr_T, (const T*)x, \
                                                         (T*)y)
  if (G == 1) C8_LAUNCH(1);
  else if (G == 2) C8_LAUNCH(2);
  else if (G == 4) C8_LAUNCH(4);
  else if (G == 8) C8_LAUNCH(8);
  else return (int)cudaErrorInvalidValue;
#undef C8_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int dim, int ndpn, int N, int K, const void* A_T, const void* nbr_T, const void* x,
           void* y, cudaStream_t s) {
  if (N == 0) return (int)cudaGetLastError();
  const int G = c8::ell_lanes(N, K, ndpn, (int)sizeof(T));
  if (dim == 1 && ndpn == 1) return launch_g<T, 1, 1>(G, N, K, A_T, nbr_T, x, y, s);
  if (dim == 2 && ndpn == 2) return launch_g<T, 2, 2>(G, N, K, A_T, nbr_T, x, y, s);
  if (dim == 2 && ndpn == 3) return launch_g<T, 2, 3>(G, N, K, A_T, nbr_T, x, y, s);
  if (dim == 3 && ndpn == 3) return launch_g<T, 3, 3>(G, N, K, A_T, nbr_T, x, y, s);
  if (dim == 3 && ndpn == 4) return launch_g<T, 3, 4>(G, N, K, A_T, nbr_T, x, y, s);
  if (dim == 4 && ndpn == 4) return launch_g<T, 4, 4>(G, N, K, A_T, nbr_T, x, y, s);
  if (dim == 6 && ndpn == 6) return launch_g<T, 6, 6>(G, N, K, A_T, nbr_T, x, y, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64; ndpn = dim
// (displacement-only, a multigrid level's m = dim = ndpn: 1 to 3 on the
// geometric levels, 1, 3 or 6 on the aggregation AMG's; or the per-part
// apply's m = dim = ndpn, 2 to 4) or dim + 1 (mixed u/p).  The
// lanes per node are c8::ell_lanes'.  Returns the cudaError_t of the
// launch (0 on success).
int c8_ell_spmv(int device, int dtype, int dim, int ndpn, int N, int K, const void* A_T,
                const void* nbr_T, const void* x, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(dim, ndpn, N, K, A_T, nbr_T, x, y, s);
  if (dtype == 1) return launch<double>(dim, ndpn, N, K, A_T, nbr_T, x, y, s);
  return (int)cudaErrorInvalidValue;
}

const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
