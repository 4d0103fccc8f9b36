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
//  - its description (Net: activation, widths, in / out scales, the
//    parameter row's stride 3 + n_nn, and where a deeper network's slab
//    lies) sits in constant memory, written by the library's entry
//    (implicit_hybrid.cu) on the launch's stream when it differs from the
//    one written last: every thread reads the same words, which the
//    constant cache broadcasts.  One description per library and card at a
//    time: launches of two networks on two streams at once would race.
//  - the weights are read in place from the element set's parameter row
//    (RUNTIME_PAR; c8_implicit.cuh): the same row for every element of a
//    set, so they stay in L1, and none is copied into registers.
// The cap: a scalar input, at most NN_MAX_HIDDEN hidden layers of at most
// NN_MAX_WIDTH units each; the entry refuses a larger network, and the
// Python wrapper raises NotImplementedError before that.  Only the output
// unit 0 is formed, the one the model reads.
//
// What the network runs on, and where its activations live:
//  - alpha = xi[ALPHA] carries one seed of its own, so of its tangent
//    slots one at most is not zero: slot ALPHA of the local Newton's
//    Dual<T, NXI> and of the condensation's Dual<T, NXI + D*D>, or, in a
//    team of G > 1 lanes, slot ALPHA / G on lane ALPHA mod G and none on
//    the others.  sigma_yield finds that slot and runs the network on a
//    value and that one tangent (Dual<T, 1>); the result goes back into
//    the slot, and every other slot is zero.  Each tangent slot is formed
//    by its own formulas (c8_dual.cuh), so the live slot's bits are those
//    of the network on the whole dual, and a dead slot, a computed zero
//    there, is an exact zero here (also where the network's value
//    overflows, which made 0 * inf = NaN of it).  A lane with no live slot
//    runs the same pass on a zero tangent, so that the team's lanes stay
//    together.  A host build aborts if alpha has two live slots: the
//    design would be wrong for that caller.
//  - one hidden layer (the decks' [1, w, 1]): each hidden unit is formed
//    and added into the output unit at once, in the plain version's order
//    (acc = W[0] h[0] + b, then + W[j] h[j]), so no activation is stored;
//  - deeper: each layer's activations go to a slab of shared memory of the
//    thread's own, two buffers of NN_MAX_WIDTH (value, tangent) pairs,
//    word (b, u, w) of thread t at ((b NN_MAX_WIDTH + u) 2 + w) THREADS + t
//    (a warp's threads at consecutive words, no bank conflict); the entry
//    asks the launch for it only for such a network.
// Nothing is indexed at run time in registers, so the network uses no
// local memory.
//
// The forward pass repeats the plain version's operations in its order:
// per unit acc = W[i][0] h[0] + b[i], then + W[i][j] h[j] for j = 1..,
// the activation on hidden layers, the output layer affine.  The
// activations and their tangents follow PyTorch's (and so JAX's up to
// rounding): relu max(x, 0) with half the tangent at 0; sigmoid 1 / (1 +
// exp(-x)) as PyTorch forms 1.0 / y, reciprocal(y) * 1, tangent -y' (r
// r); tanh, tangent (1 - tanh^2); softplus logaddexp(x, 0) = max(x, 0) +
// log1p(exp(-|x|)), tangent x' / (1 + exp(-x)).  NN(0) is formed on plain
// T once per element, after the gather (ElemConst, c8_implicit.cuh): its
// value rounds as the plain version's, whose tangent it lacks no seed of
// (the weights are constants of the element's seeds).
#pragma once

#include <cstdio>
#include <cstdlib>

#include "c8_hyper.cuh"

namespace c8 {

constexpr int NN_MAX_WIDTH = 16;
constexpr int NN_MAX_HIDDEN = 4;
// words per thread of a deeper network's slab: two buffers of
// NN_MAX_WIDTH (value, tangent) pairs
constexpr int NN_SLAB_WORDS = 2 * NN_MAX_WIDTH * 2;

// activation codes (calibr8_tpu_torch/models/nn.py ACTIVATION_CODE)
enum { NN_RELU = 0, NN_SIGMOID = 1, NN_TANH = 2, NN_SOFTPLUS = 3 };

struct Net {
  int act;       // NN_RELU .. NN_SOFTPLUS
  int n_layers;  // weight layers: hidden layers + 1
  int width[NN_MAX_HIDDEN + 2];  // the topology, width[0] = 1
  int stride;    // the parameter row: E, nu, Y, then the weights
  int slab_at;   // bytes of the block's dynamic shared memory before the slab
  double in_scale, out_scale;
};

#ifdef __CUDACC__
__constant__ Net c8_net_dev;
// the block's dynamic shared memory (the team's scratch, then the slab)
extern __shared__ double c8_nn_smem[];
#endif
// the host build's description (a harness sets it before its calls)
inline Net c8_net_host;
#ifndef __CUDA_ARCH__
// the host build's slab: one per thread (a host team's lanes are threads)
template <typename T>
inline thread_local T c8_nn_slab_host[NN_SLAB_WORDS];
#endif

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

// the thread's slab: word w (0 value, 1 tangent) of unit u of buffer b
template <typename T>
struct NNSlab {
  T* p;
  int stride;
  C8_HD T& at(int b, int u, int w) const { return p[((b * NN_MAX_WIDTH + u) * 2 + w) * stride]; }
  C8_HD void put(int b, int u, const T& x) const { at(b, u, 0) = x; }
  C8_HD void put(int b, int u, const Dual<T, 1>& x) const {
    at(b, u, 0) = x.v;
    at(b, u, 1) = x.d[0];
  }
  C8_HD void get(int b, int u, T& x) const { x = at(b, u, 0); }
  C8_HD void get(int b, int u, Dual<T, 1>& x) const {
    x.v = at(b, u, 0);
    x.d[0] = at(b, u, 1);
  }
};

template <typename T>
C8_HD NNSlab<T> nn_slab(const Net& nt) {
#ifdef __CUDA_ARCH__
  T* base = reinterpret_cast<T*>(reinterpret_cast<char*>(c8_nn_smem) + nt.slab_at);
  return NNSlab<T>{base + threadIdx.x, (int)blockDim.x};
#else
  return NNSlab<T>{c8_nn_slab_host<T>, 1};
#endif
}

// NN(x)'s output unit 0 on a plain T or a Dual<T, 1>, the weights w in
// FFNN's flat packing (per layer W row-major (out, in), then b)
template <typename T, typename S>
C8_HD S nn_eval(const S& x, const T* __restrict__ w, const Net& nt) {
  const int r1 = nt.width[1];
  const T* W = w;
  const T* b = w + r1;
  if (nt.n_layers == 2) {
    // one hidden layer: unit j is formed and added into the output unit
    const T* Wo = w + 2 * r1;
    const T* bo = Wo + r1;
    S acc = Wo[0] * nn_act(nt.act, W[0] * x + b[0]) + bo[0];
    for (int j = 1; j < r1; ++j) acc = acc + Wo[j] * nn_act(nt.act, W[j] * x + b[j]);
    return acc;
  }
  // deeper: the layers in the slab's two buffers in turn
  const NNSlab<T> sl = nn_slab<T>(nt);
  for (int i = 0; i < r1; ++i) sl.put(0, i, nn_act(nt.act, W[i] * x + b[i]));
  int idx = 2 * r1, cur = 0;
  for (int l = 1;; ++l) {
    const int c = nt.width[l], r = nt.width[l + 1];
    const bool last = l == nt.n_layers - 1;
    W = w + idx;
    b = w + idx + r * c;
    for (int i = 0; i < (last ? 1 : r); ++i) {
      S h;
      sl.get(cur, 0, h);
      S acc = W[i * c] * h + b[i];
      for (int j = 1; j < c; ++j) {
        sl.get(cur, j, h);
        acc = acc + W[i * c + j] * h;
      }
      if (last) return acc;
      sl.put(1 - cur, i, nn_act(nt.act, acc));
    }
    idx += r * c + r;
    cur = 1 - cur;
  }
}

// hybrid_hyper_J2_plane_stress, 2D displacement only: xi as
// HyperJ2PlaneStress's; params [E, nu, Y, network weights]
template <typename T>
struct HybridHyperJ2PlaneStress : HyperJ2PlaneStress<T> {
  typedef HyperJ2PlaneStress<T> Base;
  // the physical parameters; the weights follow them in the row
  static constexpr int NPAR = 3;
  static constexpr bool RUNTIME_PAR = true;
  // one lane per element in both dtypes: at notch2D h=0.004 each G > 1
  // took 1.9-5.5x G = 1's device time (implicit_sweep.py, PERF.md)
  static constexpr int TEAM_LANES = 1;

  C8_HD static int par_stride() { return net().stride; }

  // the element's constant: NN(0)
  struct ElemConst {
    T n0;
  };
  C8_HD static void elem_const(const T* par, ElemConst& kc) {
    kc.n0 = nn_eval<T, T>(T(0), par + NPAR, net());
  }

  // Y + out_scale (NN(in_scale alpha) - NN(0)) on a plain T or Dual<T, 1>
  template <typename S>
  C8_HD static S yield_one(const S& alpha, const T* par, const ElemConst& kc) {
    const Net& nt = net();
    const S dnn = nn_eval<T, S>(T(nt.in_scale) * alpha, par + NPAR, nt) - kc.n0;
    return par[2] + T(nt.out_scale) * dnn;
  }

  C8_HD static T sigma_yield(const T& alpha, const T* par, const ElemConst& kc) {
    return yield_one(alpha, par, kc);
  }

  // on a dual alpha: the network on its one live slot
  template <int N>
  C8_HD static Dual<T, N> sigma_yield(const Dual<T, N>& alpha, const T* par,
                                      const ElemConst& kc) {
    int s = -1, live = 0;
    Dual<T, 1> a;
    a.v = alpha.v;
    a.d[0] = tangent_zero<T>();
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (alpha.d[k] != T(0)) {
        s = k;
        a.d[0] = alpha.d[k];
        ++live;
      }
#ifndef __CUDA_ARCH__
    if (live > 1) {
      std::fprintf(stderr, "c8_hybrid.cuh: alpha has %d live tangent slots, not one\n", live);
      std::abort();
    }
#endif
    const Dual<T, 1> y = yield_one(a, par, kc);
    Dual<T, N> r;
    r.v = y.v;
#pragma unroll
    for (int k = 0; k < N; ++k) r.d[k] = k == s ? y.d[0] : tangent_zero<T>();
    return r;
  }

  template <typename S>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[2][2], const T gup[2][2],
                            const T* par, T abs_tol, S* C, const ElemConst& kc) {
    return Base::template residual<S, HybridHyperJ2PlaneStress>(xi, xip, gu, gup, par,
                                                                abs_tol, C, kc);
  }
};

}  // namespace c8
