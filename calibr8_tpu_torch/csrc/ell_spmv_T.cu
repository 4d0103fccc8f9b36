// Node-block ELLPACK sparse matrix-vector product, transposed: y = A^T x.
//
// Replaces calibr8_tpu's Pallas kernel _make_kernel with transpose=True
// (solve/ellpack.py:437, transposed body `bwd` :456-468, pallas_call at
// :491), the linear_call transpose rule of its EllOperator (:598-610):
//   Gt[s, j, n] = sum_i A_T[s, i, j, n] * x[n, i]
// for the K neighbour slots s of node n, followed there by the transpose
// of the neighbour gather (a scatter-add of Gt[s, :, n] into node
// nbr[n, s]).  Here the two are fused: one thread per node n reads its
// ndpn values of x once from the flat dof vector (u block, then the p
// block at offset N * D), forms g_j for each filled slot and adds it into
// y at node nbr_T[s, n] with atomicAdd (native for float64 on sm_90).  So
// the same assembled A_T serves A x (csrc/ell_spmv.cu) and A^T x, and no
// transposed copy of the element Jacobians is made.  Pad slots (neighbour
// id N) are skipped, so row N is never written.  y must hold zeros.  Up
// to K atomics land on one output node, in an order that changes from run
// to run: results match the plain version to rounding, not bitwise.
//
// What bounds it on an H100: reading the filled slots of A_T once (ndpn^2
// words per filled slot, 66 MB at 513,313 slots, ndpn 4, float64), coalesced across the warp in
// the trailing layout (K, ndpn, ndpn, N), as is the slot-major neighbour
// table (K, N); the atomics into y (~1 MB, L2-resident) are the scattered
// part.
//
// Kernel 3c's TPU pair held both directions (_kernel_pair, ellpack.py:
// 513-524), so this kernel also takes the level shapes (NDPN == D == m,
// node-interleaved, with the (1, 1) instance for the pressure chain).
// The multigrid cycle itself applies only the forward level operator:
// its transposed cycle is built from swapped element blocks.
//
// C interface, bound with ctypes (calibr8_tpu_torch/solve/ellpack.py).

#include <cuda_runtime.h>

namespace {

template <typename T, int D, int NDPN>
__global__ void __launch_bounds__(256) ell_spmv_T_kernel(
    int N, int K, const T* __restrict__ A_T, const int* __restrict__ nbr_T,
    const T* __restrict__ x, T* __restrict__ y) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t NN = (size_t)N;
  const size_t nu = NN * D;  // start of the p block
  T xv[NDPN];
#pragma unroll
  for (int i = 0; i < D; ++i) xv[i] = x[(size_t)n * D + i];
  if (NDPN > D) xv[NDPN - 1] = x[nu + n];
  for (int s = 0; s < K; ++s) {
    const int c = nbr_T[(size_t)s * NN + n];
    if (c >= N) continue;  // pad slot
    const T* As = A_T + (size_t)s * NDPN * NDPN * NN + n;
#pragma unroll
    for (int j = 0; j < NDPN; ++j) {
      T g = As[(size_t)j * NN] * xv[0];
#pragma unroll
      for (int i = 1; i < NDPN; ++i) g = g + As[(size_t)(i * NDPN + j) * NN] * xv[i];
      atomicAdd(j < D ? y + (size_t)c * D + j : y + nu + c, g);
    }
  }
}

template <typename T>
int launch(int dim, int ndpn, int N, int K, const void* A_T, const void* nbr_T,
           const void* x, void* y, cudaStream_t s) {
  const int block = 256;
  const int grid = (N + block - 1) / block;
  if (N == 0) return (int)cudaGetLastError();
#define C8_LAUNCH(D, P)                                                       \
  ell_spmv_T_kernel<T, D, P><<<grid, block, 0, s>>>(N, K, (const T*)A_T,      \
                                                    (const int*)nbr_T,        \
                                                    (const T*)x, (T*)y)
  if (dim == 1 && ndpn == 1) C8_LAUNCH(1, 1);
  else if (dim == 2 && ndpn == 2) C8_LAUNCH(2, 2);
  else if (dim == 2 && ndpn == 3) C8_LAUNCH(2, 3);
  else if (dim == 3 && ndpn == 3) C8_LAUNCH(3, 3);
  else if (dim == 3 && ndpn == 4) C8_LAUNCH(3, 4);
  else return (int)cudaErrorInvalidValue;
#undef C8_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64; ndpn = dim
// (displacement-only, or a multigrid level's m = dim = ndpn, 1 to 3) or
// dim + 1 (mixed u/p).  y must hold zeros.
// Returns the cudaError_t of the launch (0 on success).
int c8_ell_spmv_T(int device, int dtype, int dim, int ndpn, int N, int K, const void* A_T,
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
