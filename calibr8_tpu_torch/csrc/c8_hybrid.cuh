// hybrid_hyper_J2_plane_stress, the implicit-mode twin with an embedded
// network: hyper_J2_plane_stress (c8_hyper.cuh) with its hardening curve
// replaced by a feed-forward network,
//
//     sigma_yield(alpha) = Y + out_scale (NN(in_scale alpha) - NN(0))
//
// (calibr8_tpu models/batched.py:1956-2011, models/nn.py FFNN; the port's
// plain version calibr8_tpu_torch/models/batched.py
// BatchedHybridHyperJ2PlaneStress and models/nn.py).  Everything else is
// HyperJ2PlaneStress's: the struct below inherits it and replaces only
// sigma_yield.
//
// The network's size is the deck's, so it reaches the kernel at run time:
//  - its description (Net: activation, widths, in / out scales, and the
//    parameter row's stride 3 + n_nn) sits in constant memory, written by
//    the library's entry (implicit_hybrid.cu) on the launch's stream just
//    before the launch: every thread reads the same words, which the
//    constant cache broadcasts.  One description per library at a time:
//    launches of two networks on two streams at once would race.
//  - the weights are read in place from the element set's parameter row
//    (RUNTIME_PAR; c8_implicit.cuh): the same row for every element of a
//    set, so they stay in L1, and none is copied into registers.
// The cap: a scalar input, at most NN_MAX_HIDDEN hidden layers of at most
// NN_MAX_WIDTH units each (the activations of a layer live in two
// NN_MAX_WIDTH arrays of duals); the entry refuses a larger network, and
// the Python wrapper raises NotImplementedError before that.  Only the
// output unit 0 is formed, the one the model reads.
//
// The forward pass repeats the plain version's operations in its order:
// per unit acc = W[i][0] h[0] + b[i], then + W[i][j] h[j] for j = 1..,
// the activation on hidden layers, the output layer affine.  The
// activations and their tangents follow PyTorch's (and so JAX's up to
// rounding): relu max(x, 0) with half the tangent at 0; sigmoid 1 / (1 +
// exp(-x)) as PyTorch forms 1.0 / y, reciprocal(y) * 1, tangent -y' (r
// r); tanh, tangent (1 - tanh^2); softplus logaddexp(x, 0) = max(x, 0) +
// log1p(exp(-|x|)), tangent x' / (1 + exp(-x)).  NN(0) is formed on plain
// T: its value rounds as the plain version's, whose tangent it lacks no
// seed of (the weights are constants of the element's seeds).
#pragma once

#include "c8_hyper.cuh"

namespace c8 {

constexpr int NN_MAX_WIDTH = 16;
constexpr int NN_MAX_HIDDEN = 4;

// activation codes (calibr8_tpu_torch/models/nn.py ACTIVATION_CODE)
enum { NN_RELU = 0, NN_SIGMOID = 1, NN_TANH = 2, NN_SOFTPLUS = 3 };

struct Net {
  int act;       // NN_RELU .. NN_SOFTPLUS
  int n_layers;  // weight layers: hidden layers + 1
  int width[NN_MAX_HIDDEN + 2];  // the topology, width[0] = 1
  int stride;    // the parameter row: E, nu, Y, then the weights
  double in_scale, out_scale;
};

#ifdef __CUDACC__
__constant__ Net c8_net_dev;
#endif
// the host build's description (a harness sets it before its calls)
inline Net c8_net_host;

C8_HD const Net& net() {
#ifdef __CUDA_ARCH__
  return c8_net_dev;
#else
  return c8_net_host;
#endif
}

// 1 / (1 + exp(-x)), as PyTorch computes 1.0 / y: reciprocal(y) * 1
template <typename T>
C8_HD T nn_sigmoid(T x) { return T(1) / (T(1) + c8_exp(-x)); }

template <typename T, int N>
C8_HD Dual<T, N> nn_sigmoid(const Dual<T, N>& x) {
  const Dual<T, N> y = c8_exp(-x) + T(1);
  Dual<T, N> r;
  r.v = T(1) / y.v;
  const T rr = r.v * r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (-y.d[k]) * rr;
  return r;
}

// logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)); the tangent x' / (1 +
// exp(0 - x)), PyTorch's rule
template <typename T>
C8_HD T nn_softplus(T x) { return maxc(x, T(0)) + c8_log1p(c8_exp(-c8_abs(x))); }

template <typename T, int N>
C8_HD Dual<T, N> nn_softplus(const Dual<T, N>& x) {
  Dual<T, N> r;
  r.v = nn_softplus(x.v);
  const T den = T(1) + c8_exp(T(0) - x.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = x.d[k] / den;
  return r;
}

template <typename S>
C8_HD S nn_act(int act, const S& x) {
  typedef decltype(val(x)) T;
  if (act == NN_RELU) return maxc(x, T(0));
  if (act == NN_SIGMOID) return nn_sigmoid(x);
  if (act == NN_TANH) return c8_tanh(x);
  return nn_softplus(x);
}

// NN(x)'s output unit 0, the weights w in FFNN's flat packing (per layer W
// row-major (out, in), then b)
template <typename T, typename S>
C8_HD S nn_eval(const S& x, const T* __restrict__ w, const Net& nt) {
  S buf[2][NN_MAX_WIDTH];
  S* h = buf[0];
  S* g = buf[1];
  h[0] = x;
  int idx = 0;
  for (int l = 0; l < nt.n_layers; ++l) {
    const int c = nt.width[l], r = nt.width[l + 1];
    const bool last = l == nt.n_layers - 1;
    const T* W = w + idx;
    const T* b = w + idx + r * c;
    for (int i = 0; i < (last ? 1 : r); ++i) {
      S acc = W[i * c] * h[0] + b[i];
      for (int j = 1; j < c; ++j) acc = acc + W[i * c + j] * h[j];
      g[i] = last ? acc : nn_act(nt.act, acc);
    }
    idx += r * c + r;
    S* t = h;
    h = g;
    g = t;
  }
  return h[0];
}

// hybrid_hyper_J2_plane_stress, 2D displacement only: xi as
// HyperJ2PlaneStress's; params [E, nu, Y, network weights]
template <typename T>
struct HybridHyperJ2PlaneStress : HyperJ2PlaneStress<T> {
  typedef HyperJ2PlaneStress<T> Base;
  // the physical parameters; the weights follow them in the row
  static constexpr int NPAR = 3;
  static constexpr bool RUNTIME_PAR = true;

  C8_HD static int par_stride() { return net().stride; }

  template <typename S>
  C8_HD static S sigma_yield(const S& alpha, const T* par) {
    const Net& nt = net();
    const T* w = par + NPAR;
    const T n0 = nn_eval<T, T>(T(0), w, nt);
    const S dnn = nn_eval<T, S>(T(nt.in_scale) * alpha, w, nt) - n0;
    return par[2] + T(nt.out_scale) * dnn;
  }

  template <typename S>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[2][2], const T gup[2][2],
                            const T* par, T abs_tol, S* C) {
    return Base::template residual<S, HybridHyperJ2PlaneStress>(xi, xip, gu, gup, par,
                                                                abs_tol, C);
  }
};

}  // namespace c8
