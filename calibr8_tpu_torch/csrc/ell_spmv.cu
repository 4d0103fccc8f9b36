// Node-block ELLPACK sparse matrix-vector product, forward.
//
// Replaces calibr8_tpu's Pallas kernel _make_kernel
// (solve/ellpack.py:437, forward body :442-454, pallas_call at :491):
//   y[i, n] = sum_{s, j} A_T[s, i, j, n] * x[nbr[n, s], j]
// over the K neighbour slots of node n, with i, j the ndpn dofs of a
// node (u_0..u_{d-1}, p).  The TPU version gathered the neighbour values
// into a (K, ndpn, N) array first (gather_T, :149-177); here each thread
// owns one node, reads its neighbours' values straight from the flat
// dof vector (u block then p block) and writes its ndpn results straight
// into the flat y, so there is no gathered copy and no scatter.  Slots
// whose neighbour id is N (the pad sentinel, :113) are skipped.
//
// What bounds it on an H100: reading A_T once (K * ndpn^2 words per
// node; 69 MB at K = 15, 35,937 nodes, float64, >= 0.02 ms at
// 3.35 TB/s); 2 flops per entry.  A_T keeps the trailing layout
// (K, ndpn, ndpn, N) and the neighbour table is slot-major (K, N), so
// every read of A and nbr is coalesced across the warp; only the reads
// of x at neighbour ids are scattered, and they hit L2 (x is ~1 MB).
//
// The same kernel is calibr8_tpu's kernel 3c, the multigrid level apply
// (LevelEllOperator, solve/ellpack.py:322-409, called from solve/mg.py):
// a level vector is node-interleaved, x[n * m + j], which is this
// kernel's layout with NDPN == D == m, so the level instances are
// (m, m) = (1, 1) for the pressure chain and the fine pressure block and
// (2, 2), (3, 3) for the displacement chains.  The levels are small
// (125 to 35,937 nodes on the cube MG deck), so the small ones are bound
// by the launch, not by bytes.
//
// C interface, bound with ctypes (calibr8_tpu_torch/solve/ellpack.py).

#include <cuda_runtime.h>

namespace {

template <typename T, int D, int NDPN>
__global__ void __launch_bounds__(256) ell_spmv_kernel(
    int N, int K, const T* __restrict__ A_T, const int* __restrict__ nbr_T,
    const T* __restrict__ x, T* __restrict__ y) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t NN = (size_t)N;
  const size_t nu = NN * D;  // start of the p block
  T acc[NDPN];
#pragma unroll
  for (int i = 0; i < NDPN; ++i) acc[i] = T(0);
  for (int s = 0; s < K; ++s) {
    const int c = nbr_T[(size_t)s * NN + n];
    if (c >= N) continue;  // pad slot
    T xv[NDPN];
#pragma unroll
    for (int j = 0; j < D; ++j) xv[j] = x[(size_t)c * D + j];
    if (NDPN > D) xv[NDPN - 1] = x[nu + c];
    const T* As = A_T + (size_t)s * NDPN * NDPN * NN + n;
#pragma unroll
    for (int i = 0; i < NDPN; ++i)
#pragma unroll
      for (int j = 0; j < NDPN; ++j) acc[i] = acc[i] + As[(size_t)(i * NDPN + j) * NN] * xv[j];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) y[(size_t)n * D + i] = acc[i];
  if (NDPN > D) y[nu + n] = acc[NDPN - 1];
}

template <typename T>
int launch(int dim, int ndpn, int N, int K, const void* A_T, const void* nbr_T,
           const void* x, void* y, cudaStream_t s) {
  const int block = 256;
  const int grid = (N + block - 1) / block;
  if (N == 0) return (int)cudaGetLastError();
#define C8_LAUNCH(D, P)                                                     \
  ell_spmv_kernel<T, D, P><<<grid, block, 0, s>>>(N, K, (const T*)A_T,      \
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
// dim + 1 (mixed u/p).  Returns the cudaError_t of the launch (0 on
// success).
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
