// Element-by-element matvec y = sum_e P_e^T J_e P_e v.
//
// Replaces calibr8_tpu's Pallas kernel make_ebe_matvec_T
// (fem/pallas_matvec.py:31, pallas_call at :49), which computed only
// y_eT[i, e] = sum_j J_T[i, j, e] v_eT[j, e] and left the element gather
// and the scatter-add to XLA.  Here the gather v_e = v[edofs] and the
// scatter-add into y are fused in: one thread per element reads its nde
// dof ids, its nde values of v and its nde^2 Jacobian entries, and adds
// each row sum into y with atomicAdd (native for float64 on sm_90).  The
// order of those adds changes from run to run, so results agree with
// the plain version to rounding, not bitwise.
//
// What bounds it on an H100: reading J once (nde^2 words per element,
// 403 MB at 196,608 3D elements in float64, >= 0.12 ms at 3.35 TB/s);
// the flops are 2 per J entry.  The trailing layout (nde, nde, E) makes
// each J entry a coalesced read across the warp.  The transpose of the
// operator is the same kernel on the axis-swapped J (not on this path).
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/ebe_matvec.py).

#include <cuda_runtime.h>

namespace {

template <typename T, int NDE>
__global__ void __launch_bounds__(256) ebe_matvec_kernel(
    int E, const T* __restrict__ J_T, const T* __restrict__ v,
    const int* __restrict__ edofs_T, T* __restrict__ y) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int dof[NDE];
  T ve[NDE];
#pragma unroll
  for (int j = 0; j < NDE; ++j) {
    dof[j] = edofs_T[j * E + e];
    ve[j] = v[dof[j]];
  }
#pragma unroll
  for (int i = 0; i < NDE; ++i) {
    const T* Ji = J_T + (size_t)i * NDE * E + e;
    T acc = Ji[0] * ve[0];
#pragma unroll
    for (int j = 1; j < NDE; ++j) acc = acc + Ji[(size_t)j * E] * ve[j];
    atomicAdd(y + dof[i], acc);
  }
}

template <typename T>
int launch(int nde, int E, const void* J_T, const void* v, const void* edofs_T,
           void* y, cudaStream_t s) {
  const int block = 256;
  const int grid = (E + block - 1) / block;
  if (E == 0) return (int)cudaGetLastError();
#define C8_LAUNCH(N)                                                              \
  ebe_matvec_kernel<T, N><<<grid, block, 0, s>>>(E, (const T*)J_T, (const T*)v, \
                                                 (const int*)edofs_T, (T*)y)
  switch (nde) {
    case 6: C8_LAUNCH(6); break;    // 2D displacement-only
    case 9: C8_LAUNCH(9); break;    // 2D mixed u/p
    case 12: C8_LAUNCH(12); break;  // 3D displacement-only
    case 16: C8_LAUNCH(16); break;  // 3D mixed u/p
    default: return (int)cudaErrorInvalidValue;
  }
#undef C8_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64.  y must hold
// zeros (the kernel adds into it).  Returns the cudaError_t of the
// launch (0 on success).
int c8_ebe_matvec(int device, int dtype, int nde, int E, const void* J_T, const void* v,
                  const void* edofs_T, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(nde, E, J_T, v, edofs_T, y, s);
  if (dtype == 1) return launch<double>(nde, E, J_T, v, edofs_T, y, s);
  return (int)cudaErrorInvalidValue;
}

const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
