// Fused element assembly: local solve + residual + condensed Jacobian.
//
// Replaces calibr8_tpu's Pallas kernel make_pallas_assemble
// (fem/pallas_assembly.py:157, pallas_call at :496) in its analytic
// mode: for each element, the grad_u kinematics, the closed-form local
// solve, the residual rows, and the element Jacobian as the d*d grad_u
// tangents of the rows (carried by dual numbers, c8_dual.cuh) contracted
// with the shape-function gradients.  elastic and small_J2 take the rows
// of the mixed u/p mechanics residual with GLS stabilization and the
// analytic pressure columns; isotropic_elastic the displacement-only
// momentum rows (:299-314, :402-421), times the thickness under plane
// stress only, as calibr8_tpu's generic path does (its Pallas kernel
// multiplies by it always, :313; the two agree at thickness 1).
//
// What bounds it on an H100: the stores.  J_T alone is nde^2 words per
// element (16*16*8 = 2 KB in 3D float64) against ~0.3 KB of inputs and a
// few thousand flops, so at 196,608 elements the kernel moves ~0.49 GB
// in float64 and is bound by memory bandwidth, not by the float64 rate.
// The design answers that by writing every output exactly once, in the
// trailing layout (element index fastest) so that a warp's stores of one
// J entry land on consecutive addresses, and by reading each element's
// dofs straight from the flat x through edofs_T (no gathered copy).
// One thread per element keeps the whole element in registers (ptxas:
// 254 a thread and no spills for the 3D float64 small_J2 instance, so
// occupancy is low); tensor cores, shared-memory staging and TMA are
// later work.  The displacement-only instance moves 12^2 words of J per
// 3D element, not 16^2, and carries no pressure data.
//
// C interface, bound with ctypes (calibr8_tpu_torch/fem/fused_assembly.py).

#include <cuda_runtime.h>

#include "c8_element.cuh"

namespace {

template <typename T, int D, template <typename, int> class Model>
__global__ void __launch_bounds__(128) fused_assembly_kernel(
    int E, const T* __restrict__ x, const int* __restrict__ edofs_T,
    const T* __restrict__ xi_prev, const T* __restrict__ gN_T,
    const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids,
    const c8::Quad<T> q, T meas0, T stab_half, T abs_tol, T thick,
    T* __restrict__ R_T, T* __restrict__ J_T, T* __restrict__ xi_T,
    int* __restrict__ path, int* __restrict__ fail) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  c8::assemble_element<T, D, Model>(e, E, x, edofs_T, xi_prev, gN_T, detJ, h,
                                    params, es_ids, q, meas0, stab_half, abs_tol, thick,
                                    R_T, J_T, xi_T, path, fail);
}

template <typename T, int D, template <typename, int> class Model>
int launch(int E, const void* x, const void* edofs_T, const void* xi_prev,
           const void* gN_T, const void* detJ, const void* h, const void* params,
           const void* es_ids, const double* quad, int npts, double stab_half,
           double abs_tol, double thick, void* R_T, void* J_T, void* xi_T, void* path,
           void* fail, cudaStream_t stream) {
  constexpr int NPE = D + 1;
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
    fused_assembly_kernel<T, D, Model><<<grid, block, 0, stream>>>(
        E, (const T*)x, (const int*)edofs_T, (const T*)xi_prev, (const T*)gN_T,
        (const T*)detJ, (const T*)h, (const T*)params, (const int*)es_ids, q,
        meas0, T(stab_half), T(abs_tol), T(thick), (T*)R_T, (T*)J_T, (T*)xi_T,
        (int*)path, (int*)fail);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int model, int dim, int E, const void* x, const void* edofs_T,
             const void* xi_prev, const void* gN_T, const void* detJ, const void* h,
             const void* params, const void* es_ids, const double* quad, int npts,
             double stab_half, double abs_tol, double thick, void* R_T, void* J_T,
             void* xi_T, void* path, void* fail, cudaStream_t s) {
#define C8_ARGS E, x, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad, npts, \
                stab_half, abs_tol, thick, R_T, J_T, xi_T, path, fail, s
  if (model == 0 && dim == 2) return launch<T, 2, c8::Elastic>(C8_ARGS);
  if (model == 0 && dim == 3) return launch<T, 3, c8::Elastic>(C8_ARGS);
  if (model == 1 && dim == 2) return launch<T, 2, c8::SmallJ2>(C8_ARGS);
  if (model == 1 && dim == 3) return launch<T, 3, c8::SmallJ2>(C8_ARGS);
  if (model == 2 && dim == 2) return launch<T, 2, c8::IsotropicElastic>(C8_ARGS);
  if (model == 2 && dim == 3) return launch<T, 3, c8::IsotropicElastic>(C8_ARGS);
#undef C8_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// device: the CUDA ordinal of the tensors (this library's runtime keeps
// its own current device); dtype: 0 float32, 1 float64; model: 0
// elastic, 1 small_J2 (mixed u/p), 2 isotropic_elastic (displacement
// only); dim: 2 or 3; thick: the displacement-only rows' factor.  Returns
// the cudaError_t of the launch (0 on success).
int c8_fused_assembly(int device, int dtype, int model, int dim, int E, const void* x,
                      const void* edofs_T, const void* xi_prev, const void* gN_T,
                      const void* detJ, const void* h, const void* params,
                      const void* es_ids, const double* quad, int npts,
                      double stab_half, double abs_tol, double thick, void* R_T, void* J_T,
                      void* xi_T, void* path, void* fail, void* stream) {
  if (npts < 1 || npts > 4) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(model, dim, E, x, edofs_T, xi_prev, gN_T, detJ, h, params,
                           es_ids, quad, npts, stab_half, abs_tol, thick, R_T, J_T, xi_T,
                           path, fail, s);
  if (dtype == 1)
    return dispatch<double>(model, dim, E, x, edofs_T, xi_prev, gN_T, detJ, h, params,
                            es_ids, quad, npts, stab_half, abs_tol, thick, R_T, J_T, xi_T,
                            path, fail, s);
  return (int)cudaErrorInvalidValue;
}

const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
