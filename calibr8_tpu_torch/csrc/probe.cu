// Kernel 4: a probe of what the card's compiler and math library give the
// port's element code -- inverse trigonometry in float32 and float64, and
// float64 values carried through loops of three forms.
//
// Replaces calibr8_tpu's two Mosaic lowering probes, each a pallas_call
// on a small block: scripts/probe_mosaic_trig.py:51 (acos, asin, atan,
// atan2 and acos written as atan2(sqrt(1 - a^2), a), on (2, 128) float32)
// and scripts/probe_mosaic_f64.py:64 (x - 0.25 (x^2 - 2) over 8 iterations
// on an (8, 1024) float64 block, fully unrolled, as a fori_loop and as a
// while_loop).  On the TPU they settled what Mosaic lowers; here they
// settle, against numpy, what the eigensolver of the small_hosford twin
// (calibr8_tpu/models/batched.py:1618 t_eig_sym33) may call: acos itself,
// in place of calibr8_tpu's t_acos polynomial.
//
// What bounds it: nothing on this card -- a few hundred to a few thousand
// elements, one thread each, so a call is one launch (~microseconds)
// against well under a microsecond of bytes and operations.  It lies on no
// solver path.
//
// C interface, bound with ctypes (calibr8_tpu_torch/probe.py).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

template <typename T>
__device__ __forceinline__ T c8_acos(T x) {
  if constexpr (std::is_same<T, float>::value) return acosf(x);
  else return acos(x);
}
template <typename T>
__device__ __forceinline__ T c8_asin(T x) {
  if constexpr (std::is_same<T, float>::value) return asinf(x);
  else return asin(x);
}
template <typename T>
__device__ __forceinline__ T c8_atan(T x) {
  if constexpr (std::is_same<T, float>::value) return atanf(x);
  else return atan(x);
}
template <typename T>
__device__ __forceinline__ T c8_atan2(T y, T x) {
  if constexpr (std::is_same<T, float>::value) return atan2f(y, x);
  else return atan2(y, x);
}
template <typename T>
__device__ __forceinline__ T c8_sqrt(T x) {
  if constexpr (std::is_same<T, float>::value) return sqrtf(x);
  else return sqrt(x);
}

// out (5, n): acos(a), asin(a), atan(a), atan2(a, b),
// atan2(sqrt(max(1 - a^2, 0)), a)
template <typename T>
__global__ void trig_kernel(int n, const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T x = a[i], y = b[i];
  out[i] = c8_acos(x);
  out[n + i] = c8_asin(x);
  out[2 * n + i] = c8_atan(x);
  out[3 * n + i] = c8_atan2(x, y);
  const T s = T(1) - x * x;
  out[4 * n + i] = c8_atan2(c8_sqrt(s > T(0) ? s : T(0)), x);
}

__device__ __forceinline__ double step(double x) { return x - 0.25 * (x * x - 2.0); }

// out (3, n): x after ITERS updates, carried (a) through a fully unrolled
// loop, (b) through a loop whose trip count `iters` is known only at run
// time, (c) through a while loop whose end depends on the data: each
// element's own trip count, read from memory, and a finite carry
template <int ITERS>
__global__ void loop_kernel(int n, const double* __restrict__ x, const int* __restrict__ trips,
                            int iters, double* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double z = x[i];
  double u = z;
#pragma unroll
  for (int k = 0; k < ITERS; ++k) u = step(u);
  double f = z;
#pragma unroll 1
  for (int k = 0; k < iters; ++k) f = step(f);
  double w = z;
  int k = 0;
  const int t = trips[i];
  while (k < t && isfinite(w)) {
    w = step(w);
    ++k;
  }
  out[i] = u;
  out[n + i] = f;
  out[2 * n + i] = w;
}

constexpr int kBlock = 256;
constexpr int kLoopIters = 8;

}  // namespace

// dtype: 0 float32, 1 float64; a, b, (n,); out (5, n).  Returns the
// launch's cudaError_t.
extern "C" int c8_probe_trig(int device, int dtype, int n, const void* a, const void* b,
                             void* out, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kBlock - 1) / kBlock;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (dtype == 0)
      trig_kernel<float><<<grid, kBlock, 0, s>>>(n, (const float*)a, (const float*)b, (float*)out);
    else
      trig_kernel<double><<<grid, kBlock, 0, s>>>(n, (const double*)a, (const double*)b,
                                                  (double*)out);
  }
  return (int)cudaGetLastError();
}

// x (n,) float64, trips (n,) int32, iters == 8 (the unrolled form's count);
// out (3, n) float64.  Returns the launch's cudaError_t.
extern "C" int c8_probe_loop(int device, int n, const void* x, const void* trips, int iters,
                             void* out, void* stream) {
  if (iters != kLoopIters) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kBlock - 1) / kBlock;
  if (n > 0)
    loop_kernel<kLoopIters><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        n, (const double*)x, (const int*)trips, iters, (double*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* c8_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
