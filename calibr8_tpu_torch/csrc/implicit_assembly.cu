// Fused element assembly in the implicit mode: in-element local Newton,
// residual rows, and the implicitly condensed Jacobian.
//
// Replaces calibr8_tpu's Pallas kernel make_pallas_assemble
// (fem/pallas_assembly.py:157, pallas_call at :496) in its implicit mode
// (:363-400, local Newton models/batched.py:561-671) for the small-strain
// Hill family, and its displacement-only plane-stress rows (:299-314,
// :402-421).  The element code is c8_implicit.cuh, the models
// c8_hill.cuh.
//
// What bounds it on an H100: the stores, as in the analytic kernel.  J_T
// is nde^2 words per element (16*16*8 = 2 KB for 3D small_hill in
// float64) against ~0.4 KB of inputs, so at 196,608 elements the kernel
// must move ~0.5 GB (0.15 ms at 3.35 TB/s); the arithmetic, a few local
// Newton iterations with 7 dual tangents and one condensation pass with
// 16, is ~10^4 operations per element, well under that in time on the
// card's float64 rate.  The design writes every output once, in the
// trailing layout (a warp's stores of one J entry are consecutive), and
// reads the dofs straight from the flat x through edofs_T.  One thread
// per element keeps the element's state in registers; the duals of the
// 3D model exceed the 255 registers a thread may hold, so they spill to
// local memory (ptxas reports the spill).  Shared-memory staging, fewer
// live tangents and a warp per element are later work.
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py).

#include <cuda_runtime.h>

#include "c8_implicit.cuh"

namespace {

template <typename T, template <typename> class Model>
__global__ void __launch_bounds__(128) implicit_assembly_kernel(
    int E, const T* __restrict__ x, const int* __restrict__ edofs_T,
    const T* __restrict__ xi_prev, const T* __restrict__ gN_T,
    const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids,
    const c8::Quad<T> q, T meas0, T stab_half, T thick, T abs_tol, T fail_tol,
    T* __restrict__ R_T, T* __restrict__ J_T, T* __restrict__ xi_T,
    int* __restrict__ path, int* __restrict__ fail, int* __restrict__ iters) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  c8::implicit_element<T, Model>(e, E, x, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids,
                                 q, meas0, stab_half, thick, abs_tol, fail_tol, R_T, J_T,
                                 xi_T, path, fail, iters);
}

template <typename T, template <typename> class Model>
int launch(int E, const void* x, const void* edofs_T, const void* xi_prev,
           const void* gN_T, const void* detJ, const void* h, const void* params,
           const void* es_ids, const double* quad, int npts, double stab_half,
           double thick, double abs_tol, double fail_tol, void* R_T, void* J_T, void* xi_T,
           void* path, void* fail, void* iters, cudaStream_t stream) {
  constexpr int D = Model<T>::D, NPE = D + 1;
  c8::Quad<T> q;
  for (int a = 0; a < 4; ++a) {
    q.w1[a] = T(0);
    for (int b = 0; b < 4; ++b) q.N1[a][b] = q.mass[a][b] = T(0);
  }
  // quad = [N1 (npts, npe) | w1 (npts) | mass (npe, npe)], row-major doubles
  for (int a = 0; a < npts; ++a)
    for (int n = 0; n < NPE; ++n) q.N1[a][n] = T(quad[a * NPE + n]);
  for (int a = 0; a < npts; ++a) q.w1[a] = T(quad[npts * NPE + a]);
  for (int n = 0; n < NPE; ++n)
    for (int m = 0; m < NPE; ++m) q.mass[n][m] = T(quad[npts * NPE + npts + n * NPE + m]);
  q.npts = npts;
  const T meas0 = T(D == 2 ? 0.5 : 1.0 / 6.0);
  const int block = 128;
  const int grid = (E + block - 1) / block;
  if (E > 0)
    implicit_assembly_kernel<T, Model><<<grid, block, 0, stream>>>(
        E, (const T*)x, (const int*)edofs_T, (const T*)xi_prev, (const T*)gN_T,
        (const T*)detJ, (const T*)h, (const T*)params, (const int*)es_ids, q, meas0,
        T(stab_half), T(thick), T(abs_tol), T(fail_tol), (T*)R_T, (T*)J_T, (T*)xi_T,
        (int*)path, (int*)fail, (int*)iters);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int model, int E, const void* x, const void* edofs_T, const void* xi_prev,
             const void* gN_T, const void* detJ, const void* h, const void* params,
             const void* es_ids, const double* quad, int npts, double stab_half, double thick,
             double abs_tol, double fail_tol, void* R_T, void* J_T, void* xi_T, void* path,
             void* fail, void* iters, cudaStream_t s) {
#define C8_ARGS E, x, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad, npts, \
                stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail, iters, s
  if (model == 0) return launch<T, c8::SmallHill>(C8_ARGS);
  if (model == 1) return launch<T, c8::SmallHillPlaneStrain>(C8_ARGS);
  if (model == 2) return launch<T, c8::SmallHillPlaneStress>(C8_ARGS);
#undef C8_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64; model: 0
// small_hill (3D, mixed), 1 small_hill_plane_strain (2D, mixed), 2
// small_hill_plane_stress (2D, displacement only); fail_tol =
// max(10 abs_tol, 1e-30); iters may be null.  Returns the cudaError_t of
// the launch (0 on success).
int c8_implicit_assembly(int device, int dtype, int model, int E, const void* x,
                         const void* edofs_T, const void* xi_prev, const void* gN_T,
                         const void* detJ, const void* h, const void* params,
                         const void* es_ids, const double* quad, int npts, double stab_half,
                         double thick, double abs_tol, double fail_tol, void* R_T, void* J_T,
                         void* xi_T, void* path, void* fail, void* iters, void* stream) {
  if (npts < 1 || npts > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(model, E, x, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad,
                           npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path,
                           fail, iters, s);
  if (dtype == 1)
    return dispatch<double>(model, E, x, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad,
                            npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path,
                            fail, iters, s);
  return (int)cudaErrorInvalidValue;
}

const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
