// Forward-mode dual numbers with a fixed number of tangent directions.
//
// Dual<T, N> carries a value and N directional derivatives, the static
// analog of Sacado's SLFad that the reference uses to seed its element
// kernels.  The fused assembly kernel (fused_assembly.cu) seeds the d*d
// entries of grad_u with it, in place of calibr8_tpu's jax.linearize
// over those seeds (fem/pallas_assembly.py:357-362).
//
// Everything here is __host__ __device__ (C8_HD), so the element code
// also builds with a host C++ compiler for checking without a card.
//
// Tangent rules follow JAX's, which the reference port was checked
// against: sqrt' = g * (0.5 / sqrt(x)); exp' = g * exp(x); log' = g / x;
// pow(x, n)' = g * (n x^(n-1)) for a constant float n; |x|' = g sign(x)
// (0 at x == 0); cos' = -g sin(x); sin' = g cos(x); acos' = -g /
// sqrt(1 - x^2); tanh' = g (1 - tanh(x)^2); log1p' = g / (1 + x);
// (a/b)' = a'/b - a b'/b^2; max0(f) = max(f, 0), maxc(f, c),
// minc(f, c) and c8_clip(f, lo, hi) give each side half the tangent at a
// tie.
#pragma once

#include <cmath>
#include <type_traits>

#ifdef __CUDACC__
#define C8_HD __host__ __device__ __forceinline__
#else
#define C8_HD inline
#endif

namespace c8 {

// the zero of a tangent slot that no seed reaches: T(0), which a host
// harness's operation-counting scalar marks so that the operations on it,
// which the function does not need, go uncounted
template <typename T>
C8_HD T tangent_zero() { return T(0); }
// the same zero where a slot is zeroed in place of x's: marked as x is
template <typename T>
C8_HD T zero_like(const T&) { return T(0); }

template <typename T, int N>
struct Dual {
  T v;
  T d[N];
  C8_HD Dual() {}
  C8_HD Dual(T x) : v(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = tangent_zero<T>();
  }
};

// the constant c in place of f: Dual<T, N>(c) (c for a plain f), its zero
// tangent slots zero_like f's
template <typename T>
C8_HD T constant_like(T, T c) { return c; }
template <typename T, int N>
C8_HD Dual<T, N> constant_like(const Dual<T, N>& f, T c) {
  Dual<T, N> r;
  r.v = c;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = zero_like(f.d[k]);
  return r;
}

// the plain scalars that mix with duals as constants: the arithmetic
// types, and a type that specializes scalar_like (a host harness's
// operation-counting scalar)
template <typename U>
struct scalar_like : std::is_arithmetic<U> {};
template <typename U>
using if_arith = typename std::enable_if<scalar_like<U>::value, int>::type;

// value of a plain scalar or a dual
template <typename T>
C8_HD T val(T x) { return x; }
template <typename T, int N>
C8_HD T val(const Dual<T, N>& x) { return x.v; }

template <typename T, int N>
C8_HD Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}

template <typename T, int N>
C8_HD Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <typename T, int N>
C8_HD Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <typename T, int N>
C8_HD Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

template <typename T, int N>
C8_HD Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  const T ib2 = T(1) / (b.v * b.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / b.v + (-b.d[k] * a.v) * ib2;
  return r;
}

// mixed dual / plain-scalar arithmetic (the scalar is a constant)
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator+(const Dual<T, N>& a, U b) {
  Dual<T, N> r = a;
  r.v = a.v + T(b);
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator+(U a, const Dual<T, N>& b) {
  Dual<T, N> r = b;
  r.v = T(a) + b.v;
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator-(const Dual<T, N>& a, U b) {
  Dual<T, N> r = a;
  r.v = a.v - T(b);
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator-(U a, const Dual<T, N>& b) {
  Dual<T, N> r = -b;
  r.v = T(a) - b.v;
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator*(const Dual<T, N>& a, U b) {
  Dual<T, N> r;
  r.v = a.v * T(b);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * T(b);
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator*(U a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = T(a) * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = T(a) * b.d[k];
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator/(const Dual<T, N>& a, U b) {
  Dual<T, N> r;
  r.v = a.v / T(b);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / T(b);
  return r;
}
template <typename T, int N, typename U, if_arith<U> = 0>
C8_HD Dual<T, N> operator/(U a, const Dual<T, N>& b) {
  return Dual<T, N>(T(a)) / b;
}

C8_HD float c8_sqrt(float x) { return sqrtf(x); }
C8_HD double c8_sqrt(double x) { return sqrt(x); }

template <typename T, int N>
C8_HD Dual<T, N> c8_sqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_sqrt(a.v);
  const T s = T(0.5) / r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * s;
  return r;
}

C8_HD float c8_exp(float x) { return expf(x); }
C8_HD double c8_exp(double x) { return exp(x); }

template <typename T, int N>
C8_HD Dual<T, N> c8_exp(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_exp(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * r.v;
  return r;
}

C8_HD float c8_log(float x) { return logf(x); }
C8_HD double c8_log(double x) { return log(x); }

template <typename T, int N>
C8_HD Dual<T, N> c8_log(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_log(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / a.v;
  return r;
}

C8_HD float c8_pow(float x, float n) { return powf(x, n); }
C8_HD double c8_pow(double x, double n) { return pow(x, n); }

// x^n with a constant exponent n (a material parameter): the tangent is
// x's times n x^(n-1), JAX's rule for a float exponent
template <typename T, int N>
C8_HD Dual<T, N> c8_pow(const Dual<T, N>& a, T n) {
  Dual<T, N> r;
  r.v = c8_pow(a.v, n);
  const T jac = n * c8_pow(a.v, n - T(1));
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * jac;
  return r;
}

C8_HD float c8_abs(float x) { return fabsf(x); }
C8_HD double c8_abs(double x) { return fabs(x); }

template <typename T, int N>
C8_HD Dual<T, N> c8_abs(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_abs(a.v);
  const T sg = a.v > T(0) ? T(1) : (a.v < T(0) ? T(-1) : T(0));
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * sg;
  return r;
}

C8_HD float c8_cos(float x) { return cosf(x); }
C8_HD double c8_cos(double x) { return cos(x); }
C8_HD float c8_sin(float x) { return sinf(x); }
C8_HD double c8_sin(double x) { return sin(x); }

// cos' = g * -sin(x); sin' = g * cos(x)
template <typename T, int N>
C8_HD Dual<T, N> c8_cos(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_cos(a.v);
  const T jac = -c8_sin(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * jac;
  return r;
}

template <typename T, int N>
C8_HD Dual<T, N> c8_sin(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_sin(a.v);
  const T jac = c8_cos(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * jac;
  return r;
}

C8_HD float c8_acos(float x) { return acosf(x); }
C8_HD double c8_acos(double x) { return acos(x); }

// 1 / sqrt(x): the device's rsqrt, as PyTorch's CUDA rsqrt computes it
C8_HD float c8_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
C8_HD double c8_rsqrt(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}

// acos' = g * -rsqrt(1 - x^2) (JAX's and PyTorch's rule; -inf at |x| = 1)
template <typename T, int N>
C8_HD Dual<T, N> c8_acos(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_acos(a.v);
  const T jac = -c8_rsqrt(T(1) - a.v * a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * jac;
  return r;
}

C8_HD float c8_tanh(float x) { return tanhf(x); }
C8_HD double c8_tanh(double x) { return tanh(x); }

// tanh' = g * (1 - tanh(x)^2), PyTorch's tanh_backward at the result
template <typename T, int N>
C8_HD Dual<T, N> c8_tanh(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_tanh(a.v);
  const T jac = T(1) - r.v * r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * jac;
  return r;
}

C8_HD float c8_log1p(float x) { return log1pf(x); }
C8_HD double c8_log1p(double x) { return log1p(x); }

// log1p' = g / (1 + x)
template <typename T, int N>
C8_HD Dual<T, N> c8_log1p(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = c8_log1p(a.v);
  const T den = T(1) + a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / den;
  return r;
}

template <typename T>
C8_HD bool finite(T x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

// max(f, c) for a constant c (jnp.maximum(f, c)): at a tie f keeps half
// its tangent; a NaN f stays NaN, as XLA's max propagates it
template <typename T>
C8_HD T maxc(T f, T c) { return f < c ? c : f; }

template <typename T, int N>
C8_HD Dual<T, N> maxc(const Dual<T, N>& f, T c) {
  if (f.v < c) return constant_like(f, c);
  Dual<T, N> r = f;
  if (f.v == c) {
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = r.d[k] * T(0.5);
  }
  return r;
}

// min(f, c) for a constant c, the mirror of maxc
template <typename T>
C8_HD T minc(T f, T c) { return f > c ? c : f; }

template <typename T, int N>
C8_HD Dual<T, N> minc(const Dual<T, N>& f, T c) {
  if (f.v > c) return constant_like(f, c);
  Dual<T, N> r = f;
  if (f.v == c) {
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = r.d[k] * T(0.5);
  }
  return r;
}

// jnp.clip(f, lo, hi) = min(max(f, lo), hi): half the tangent at a tie
template <typename S, typename T>
C8_HD S c8_clip(const S& f, T lo, T hi) { return minc(maxc(f, lo), hi); }

// The lanes that split a function's own seeds (c8_eig.cuh yield_inner):
// G lanes, lane `lane` carrying the seeds c with c mod G = lane.  SoloLane
// is one thread with all of them; TeamLane a lane of kernel 1b's team
// (c8_implicit.cuh implicit_team_element), whose lanes meet in the team's
// scratch `sh` at tm.sync().
struct SoloLane {
  static constexpr int G = 1;
  int lane = 0;
  C8_HD void sync() const {}
};

template <int G_, typename Team, typename T>
struct TeamLane {
  static constexpr int G = G_;
  const Team& tm;
  T* sh;
  int lane;
  C8_HD void sync() const { tm.sync(); }
};

// max(f, 0) with JAX's tie rule: at f == 0 each side gets half the tangent
template <typename S>
C8_HD S max0(const S& f) {
  typedef decltype(val(f)) T;
  const T v = val(f);
  if (v > T(0)) return f;
  if (v < T(0)) return constant_like(f, T(0));
  return f * T(0.5);
}

}  // namespace c8
