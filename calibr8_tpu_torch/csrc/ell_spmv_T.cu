// Node-block ELLPACK sparse matrix-vector product, transposed: y = A^T x.
//
// Replaces calibr8_tpu's Pallas kernel _make_kernel with transpose=True
// (solve/ellpack.py:437, transposed body `bwd` :456-468, pallas_call at
// :491), the linear_call transpose rule of its EllOperator (:598-610):
//   Gt[s, j, n] = sum_i A_T[s, i, j, n] * x[n, i]
// for the K neighbour slots s of node n, followed there by the transpose
// of the neighbour gather (a scatter-add of Gt[s, :, n] into node
// nbr[n, s]).  Here the scatter becomes a gather: the ELL pattern of a
// finite-element mesh is structurally symmetric (c is in row n exactly
// when n is in row c), so output node c sums over its own row,
//   y[j, c] = sum_{t, i} A_T[tr_T[t, c], i, j, m] * x[m, i],  m = nbr_T[t, c],
// with tr_T (K, N) int32 the slot of c in row m, built once per mesh on
// the host beside nbr_T (solve/ellpack.py transposed_slots).  So the same
// assembled A_T serves A x (csrc/ell_spmv.cu) and A^T x, no transposed
// copy of the element Jacobians is made, and each output node is written
// once, by its own lanes, in a fixed order: y needs no zero fill and is
// the same bit for bit from run to run.
//
// What bounds it on an H100: reading the filled slots' blocks of A_T
// once (ndpn^2 words per filled slot, 66 MB at 513,313 slots, ndpn 4,
// float64, >= 0.02 ms at 3.35 TB/s), the same bytes as the forward
// product; 2 flops per entry.  tr_T (4 bytes a slot) is the design's
// overhead.  The price of the gather: a warp's reads of A_T at (tr, i, j,
// m) are no longer consecutive addresses, since neighbouring output nodes
// have scattered neighbours m; the lines they touch are mostly read by a
// nearby warp too, and then come from the 50 MB L2 (PERF.md).  As for the
// forward kernel the lever is memory-level parallelism: enough loads in
// flight to cover each slot's chain (the ids, then x and A at them).
//
// The design (c8_ell.cuh ell_T_lane_partial): the forward kernel's
// layout, G lanes per node (c8::ell_T_lanes, which gives the float64
// gather fewer lanes than c8::ell_lanes at cube n=32), blocks of 128, the
// node index fastest in the warp; each lane takes its slots 4 at a time, ids first, then x
// and A, then the multiply-adds; pad slots (neighbour id N) are
// predicated (x is 0 and A is not read, whatever A_T holds there); the G
// partials of a node are summed with __shfl_xor_sync in a fixed order and
// lane 0 of the node stores its ndpn values.
//
// Kernel 3c's TPU pair held both directions (_kernel_pair, ellpack.py:
// 513-524), so this kernel also takes the level shapes (NDPN == D == m,
// node-interleaved, with the (1, 1) instance for the pressure chain).
// The multigrid cycle itself applies only the forward level operator:
// its transposed cycle is built from swapped element blocks.
//
// C interface, bound with ctypes (calibr8_tpu_torch/solve/ellpack.py).

#include <cuda_runtime.h>

#include "c8_ell.cuh"

namespace {

constexpr int BLOCK = 128;

template <typename T, int D, int NDPN, int G>
__global__ void __launch_bounds__(BLOCK) ell_spmv_T_kernel(
    int N, int K, const T* __restrict__ A_T, const int* __restrict__ nbr_T,
    const int* __restrict__ tr_T, const T* __restrict__ x, T* __restrict__ y) {
  constexpr int NPW = 32 / G;  // nodes per warp
  const int lane = threadIdx.x & 31;
  const int g = lane / NPW;
  const int c = (blockIdx.x * (BLOCK / 32) + threadIdx.x / 32) * NPW + lane % NPW;
  T acc[NDPN];
  if (c < N) {
    c8::ell_T_lane_partial<T, D, NDPN>(N, K, c, g, G, A_T, nbr_T, tr_T, x, acc);
  } else {
#pragma unroll
    for (int j = 0; j < NDPN; ++j) acc[j] = T(0);
  }
  // every lane of the warp takes part in the exchange (full mask)
#pragma unroll
  for (int off = G / 2; off >= 1; off /= 2)
#pragma unroll
    for (int j = 0; j < NDPN; ++j) acc[j] = acc[j] + __shfl_xor_sync(0xffffffffu, acc[j], off * NPW);
  if (g != 0 || c >= N) return;
#pragma unroll
  for (int j = 0; j < D; ++j) y[(size_t)c * D + j] = acc[j];
  if (NDPN > D) y[(size_t)N * D + c] = acc[NDPN - 1];
}

template <typename T, int D, int NDPN>
int launch_g(int G, int N, int K, const void* A_T, const void* nbr_T, const void* tr_T,
             const void* x, void* y, cudaStream_t s) {
  const int grid = (int)(((long long)N * G + BLOCK - 1) / BLOCK);
#define C8_LAUNCH(GG)                                                                   \
  ell_spmv_T_kernel<T, D, NDPN, GG><<<grid, BLOCK, 0, s>>>(                              \
      N, K, (const T*)A_T, (const int*)nbr_T, (const int*)tr_T, (const T*)x, (T*)y)
  if (G == 1) C8_LAUNCH(1);
  else if (G == 2) C8_LAUNCH(2);
  else if (G == 4) C8_LAUNCH(4);
  else if (G == 8) C8_LAUNCH(8);
  else return (int)cudaErrorInvalidValue;
#undef C8_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int dim, int ndpn, int N, int K, const void* A_T, const void* nbr_T,
           const void* tr_T, const void* x, void* y, cudaStream_t s) {
  if (N == 0) return (int)cudaGetLastError();
  const int G = c8::ell_T_lanes(N, K, ndpn, (int)sizeof(T));
  if (dim == 1 && ndpn == 1) return launch_g<T, 1, 1>(G, N, K, A_T, nbr_T, tr_T, x, y, s);
  if (dim == 2 && ndpn == 2) return launch_g<T, 2, 2>(G, N, K, A_T, nbr_T, tr_T, x, y, s);
  if (dim == 2 && ndpn == 3) return launch_g<T, 2, 3>(G, N, K, A_T, nbr_T, tr_T, x, y, s);
  if (dim == 3 && ndpn == 3) return launch_g<T, 3, 3>(G, N, K, A_T, nbr_T, tr_T, x, y, s);
  if (dim == 3 && ndpn == 4) return launch_g<T, 3, 4>(G, N, K, A_T, nbr_T, tr_T, x, y, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64; ndpn = dim
// (displacement-only, or a multigrid level's m = dim = ndpn, 1 to 3) or
// dim + 1 (mixed u/p); tr_T (K, N) int32, the slot of each output node
// in its neighbour's row.  Every entry of y is written.  The lanes per
// node are c8::ell_T_lanes'.  Returns the cudaError_t of the launch (0 on
// success).
int c8_ell_spmv_T(int device, int dtype, int dim, int ndpn, int N, int K, const void* A_T,
                  const void* nbr_T, const void* tr_T, const void* x, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(dim, ndpn, N, K, A_T, nbr_T, tr_T, x, y, s);
  if (dtype == 1) return launch<double>(dim, ndpn, N, K, A_T, nbr_T, tr_T, x, y, s);
  return (int)cudaErrorInvalidValue;
}

const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
