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
// against: sqrt' = g * (0.5 / sqrt(x)); exp' = g * exp(x);
// (a/b)' = a'/b - a b'/b^2; max0(f) = max(f, 0) and maxc(f, c) give each
// side half the tangent at a tie.
#pragma once

#include <cmath>
#include <type_traits>

#ifdef __CUDACC__
#define C8_HD __host__ __device__ __forceinline__
#else
#define C8_HD inline
#endif

namespace c8 {

template <typename T, int N>
struct Dual {
  T v;
  T d[N];
  C8_HD Dual() {}
  C8_HD Dual(T x) : v(x) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = T(0);
  }
};

template <typename U>
using if_arith = typename std::enable_if<std::is_arithmetic<U>::value, int>::type;

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

// max(f, c) for a constant c (jnp.maximum(f, c)): at a tie f keeps half
// its tangent; a NaN f stays NaN, as XLA's max propagates it
template <typename T>
C8_HD T maxc(T f, T c) { return f < c ? c : f; }

template <typename T, int N>
C8_HD Dual<T, N> maxc(const Dual<T, N>& f, T c) {
  if (f.v < c) return Dual<T, N>(c);
  Dual<T, N> r = f;
  if (f.v == c) {
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = r.d[k] * T(0.5);
  }
  return r;
}

// max(f, 0) with JAX's tie rule: at f == 0 each side gets half the tangent
template <typename S>
C8_HD S max0(const S& f) {
  typedef decltype(val(f)) T;
  const T v = val(f);
  if (v > T(0)) return f;
  if (v < T(0)) return S(T(0));
  return f * T(0.5);
}

}  // namespace c8
