"""Kernel 1b's team body (c8::implicit_team_element, csrc/c8_implicit.cuh)
built for the host with g++ and checked on this CPU, float64, without FMA
contraction (-ffp-contract=off, as the kernel libraries are built with
-fmad=false):

 - the team body at G = 1, at G = 4 and at each G that the kernels use
   for the instance (c8::implicit_team_lanes, float64 and float32), its
   lanes G std::threads that meet at a C++20 std::barrier (the team
   type's sync() and ballot(), __syncwarp and __ballot_sync on the card,
   its put_* stores straight into the trailing layout), against
   c8::implicit_element, the thread-per-element body, bit for bit (xi, R,
   J, path, fail, iters), and against fused_assembly_plain: path, fail and
   local counts equal, xi, R and J to 1e-13 of their max.  Cases:
   hypo_barlat on tests/test_torch_barlat.py's state (cube n=2, its line
   search cutting some steps), small_hill, hyper_J2 and hypo_hill at cube
   n=2 and hyper_J2_plane_stress at notch2D h=0.3, each with plastic
   elements;
 - for hypo_barlat, the team body's ballots at G = 1 (one a trial) against
   the plain local Newton's count of the line-search trials that the
   sequential search needs (implicit_newton's `trials`);
 - the operations per element of every instance of implicit_assembly.cu
   and implicit_barlat.cu (the Hosford twins of implicit_eig.cu:
   tests/test_torch_implicit_eig_host.py, which builds HARNESS with
   -DC8_HOSFORD_TWINS), counted by c8::implicit_element on a counting
   scalar (Flop: one per add, subtract, multiply, divide, square root and
   function call, none on a tangent slot that no seed reaches or on what
   such zeros alone make) on the twin cases' states: they are A + (B + 4 T) iters
   for the element's local Newton count iters (implicit_element runs all
   four trials), and one trial (c8::line_search_trial) is T, with the (A,
   B, T) of calibr8_tpu_torch/implicit_cost.py FLOPS, which chip_smoke.py
   turns into the kernels' operations bound.

Skips where no g++ is found."""

import copy
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from calibr8_tpu.models.twin_cases import CASES as TWIN_CASES
from calibr8_tpu.models.twin_cases import case_deck
from calibr8_tpu_torch.deck import load_deck
from calibr8_tpu_torch.fem.fused_assembly import _quad_array, fused_assembly_plain, row_thickness
from calibr8_tpu_torch.implicit_cost import FLOPS
from calibr8_tpu_torch.mechanics.global_residual import elem_kinematics
from calibr8_tpu_torch.models.batched import KERNEL_MODEL_ID, implicit_newton
from calibr8_tpu_torch.problem import Problem
from tests.test_torch_hyper_assembly import hyper_state

CSRC = Path(__file__).resolve().parents[1] / "calibr8_tpu_torch" / "csrc"
TWINS = {c[0]: c for c in TWIN_CASES}
CUBE2 = {"type": "cube", "n": 2}
NOTCH = {"type": "notch2D", "h": 0.3}

HARNESS = r"""
#include <barrier>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
#include "c8_dual.cuh"

namespace c8 {
// a double that counts the operations done on it: add / subtract,
// multiply, divide, square root (and rsqrt), other functions.  A tangent
// slot that no seed reaches (c8::tangent_zero, c8::zero_like) is a known
// zero (z), and so is what these operations make of known zeros: the
// operations that the function does not need, x + 0, x - 0, 0 - x,
// x * 0, 0 / x, sqrt(0), -0 and |0| on a known zero, are free.  Every
// value is computed all the same, so the control flow is the double's.
struct Flop {
  double v;
  bool z;
  static inline thread_local long long ops[5];
  Flop() = default;
  Flop(double x) : v(x), z(false) {}
  static Flop of(double x, bool zero) {
    Flop f(x);
    f.z = zero;
    return f;
  }
  friend Flop operator+(Flop a, Flop b) {
    if (!a.z && !b.z) ++ops[0];
    return of(a.v + b.v, a.z && b.z);
  }
  friend Flop operator-(Flop a, Flop b) {
    if (!a.z && !b.z) ++ops[0];
    return of(a.v - b.v, a.z && b.z);
  }
  friend Flop operator*(Flop a, Flop b) {
    if (!a.z && !b.z) ++ops[1];
    return of(a.v * b.v, a.z || b.z);
  }
  friend Flop operator/(Flop a, Flop b) {
    if (!a.z) ++ops[2];
    return of(a.v / b.v, a.z);
  }
  friend Flop operator-(Flop a) { return of(-a.v, a.z); }
  friend bool operator<(Flop a, Flop b) { return a.v < b.v; }
  friend bool operator<=(Flop a, Flop b) { return a.v <= b.v; }
  friend bool operator>(Flop a, Flop b) { return a.v > b.v; }
  friend bool operator>=(Flop a, Flop b) { return a.v >= b.v; }
  friend bool operator==(Flop a, Flop b) { return a.v == b.v; }
  friend bool operator!=(Flop a, Flop b) { return a.v != b.v; }
};
template <>
struct scalar_like<Flop> : std::true_type {};
template <>
inline Flop tangent_zero<Flop>() { return Flop::of(0.0, true); }
inline Flop zero_like(const Flop& x) { return Flop::of(0.0, x.z); }
inline Flop c8_sqrt(Flop a) {
  if (!a.z) ++Flop::ops[3];
  return Flop::of(std::sqrt(a.v), a.z);
}
inline Flop c8_rsqrt(Flop a) { ++Flop::ops[3]; return 1.0 / std::sqrt(a.v); }
inline Flop c8_exp(Flop a) { ++Flop::ops[4]; return std::exp(a.v); }
inline Flop c8_log(Flop a) { ++Flop::ops[4]; return std::log(a.v); }
inline Flop c8_pow(Flop a, Flop n) { ++Flop::ops[4]; return std::pow(a.v, n.v); }
inline Flop c8_cos(Flop a) { ++Flop::ops[4]; return std::cos(a.v); }
inline Flop c8_sin(Flop a) { ++Flop::ops[4]; return std::sin(a.v); }
inline Flop c8_acos(Flop a) { ++Flop::ops[4]; return std::acos(a.v); }
inline Flop c8_tanh(Flop a) { ++Flop::ops[4]; return std::tanh(a.v); }
inline Flop c8_log1p(Flop a) { ++Flop::ops[4]; return std::log1p(a.v); }
inline Flop c8_abs(Flop a) { return Flop::of(std::fabs(a.v), a.z); }
inline bool finite(Flop a) { return std::isfinite(a.v); }
}  // namespace c8

#include "c8_hosford.cuh"
#include "c8_implicit.cuh"

struct Out;

// the team's exchange on the host: G threads at a std::barrier, storing
// their outputs straight into the trailing layout.  Counts the ballots
// (at G = 1 one per line-search trial the sequential search needs), and
// those in which lane 0 (trial alpha = 1, or a later trial of a round
// reached only after it failed) rejected its trial.
struct HostTeam {
  int lane, G;
  std::barrier<>* bar;
  int* flags;
  long long *shortened, *ballots;
  const int* e;  // the element the team is on
  Out* out;
  int E, nde;
  void sync() const { bar->arrive_and_wait(); }
  void put_J(int i, int col, double v) const;
  void put_R(int i, double v) const;
  void put_xi(int k, double v) const;
  void put_ints(int p, int f, int it) const;
  void row_done(int) const { sync(); }
  void done() const { sync(); }
  unsigned ballot(bool p) const {
    flags[lane] = p;
    sync();
    unsigned b = 0;
    for (int i = 0; i < G; ++i) b |= unsigned(flags[i] != 0) << i;
    if (lane == 0) {
      ++*ballots;
      if (!(b & 1u)) ++*shortened;
    }
    sync();
    return b;
  }
};

template <typename T>
static std::vector<T> rd(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) exit(2);
  return v;
}

template <typename T>
static void wr(FILE* o, const std::vector<T>& v) { fwrite(v.data(), sizeof(T), v.size(), o); }

struct In {
  int E, npts, nxi, nde, D;
  std::vector<double> sc, params, x, xp, xip, gN, detJ, h, quad;
  std::vector<int> edofs, es;
};

struct Out {
  std::vector<double> R, J, xi;
  std::vector<int> path, fail, iters;
  Out(const In& in)
      : R((size_t)in.nde * in.E), J((size_t)in.nde * in.nde * in.E), xi((size_t)in.nxi * in.E),
        path(in.E), fail(in.E), iters(in.E) {}
  void write(FILE* o) const {
    wr(o, R);
    wr(o, J);
    wr(o, xi);
    wr(o, path);
    wr(o, fail);
    wr(o, iters);
  }
};

void HostTeam::put_J(int i, int col, double v) const {
  out->J[((size_t)i * nde + col) * E + *e] = v;
}
void HostTeam::put_R(int i, double v) const { out->R[(size_t)i * E + *e] = v; }
void HostTeam::put_xi(int k, double v) const { out->xi[(size_t)k * E + *e] = v; }
void HostTeam::put_ints(int p, int f, int it) const {
  out->path[*e] = p;
  out->fail[*e] = f;
  out->iters[*e] = it;
}

template <typename T>
static c8::Quad<T> quad_of(const In& in) {
  const int npe = in.D + 1, npts = in.npts;
  const std::vector<double>& quad = in.quad;
  c8::Quad<T> q;
  for (int a = 0; a < 4; ++a) {
    q.w1[a] = T(0);
    for (int b = 0; b < 4; ++b) q.N1[a][b] = q.mass[a][b] = T(0);
  }
  for (int a = 0; a < npts; ++a)
    for (int n = 0; n < npe; ++n) q.N1[a][n] = T(quad[a * npe + n]);
  for (int a = 0; a < npts; ++a) q.w1[a] = T(quad[npts * npe + a]);
  for (int n = 0; n < npe; ++n)
    for (int m = 0; m < npe; ++m) q.mass[n][m] = T(quad[npts * npe + npts + n * npe + m]);
  q.npts = npts;
  return q;
}

#ifndef C8_COUNT
template <template <typename> class Model>
static void run_element(const In& in, Out& out) {
  const c8::Quad<double> q = quad_of<double>(in);
  const double meas0 = in.D == 2 ? 0.5 : 1.0 / 6.0;
  for (int e = 0; e < in.E; ++e)
    c8::implicit_element<double, Model>(
        e, in.E, in.x.data(), in.xp.data(), in.edofs.data(), in.xip.data(), in.gN.data(),
        in.detJ.data(), in.h.data(), in.params.data(), in.es.data(), q, meas0, in.sc[0],
        in.sc[1], in.sc[2], in.sc[3], out.R.data(), out.J.data(), out.xi.data(),
        out.path.data(), out.fail.data(), out.iters.data());
}

// the team body on every element; returns the ballots and the shortened
// ones (HostTeam)
template <template <typename> class Model, int G>
static std::pair<long long, long long> run_team(const In& in, Out& out) {
  typedef Model<double> M;
  constexpr int NS = c8::implicit_team_scratch<M>();
  const c8::Quad<double> q = quad_of<double>(in);
  const double meas0 = in.D == 2 ? 0.5 : 1.0 / 6.0;
  const int E = in.E;
  std::vector<double> sh(NS);
  int flags[32], e = 0;
  long long shortened = 0, ballots = 0;
  std::barrier<> bar(G);
  auto lane_body = [&](int lane) {
    const HostTeam tm{lane, G, &bar, flags, &shortened, &ballots, &e, &out, E, in.nde};
    for (int k = 0; k < E; ++k) {
      if (lane == 0) e = k;
      tm.sync();
      c8::implicit_team_element<double, Model, G>(
          tm, k, E, in.x.data(), in.xp.data(), in.edofs.data(), in.xip.data(), in.gN.data(),
          in.detJ.data(), in.h.data(), in.params.data(), in.es.data(), q, meas0, in.sc[0],
          in.sc[1], in.sc[2], in.sc[3], sh.data());
    }
  };
  std::vector<std::thread> lanes;
  for (int l = 0; l < G; ++l) lanes.emplace_back(lane_body, l);
  for (auto& t : lanes) t.join();
  return {ballots, shortened};
}

// the thread-per-element body, then the team body at G = 1, 4 and at the
// kernels' G in float64 and float32 (a repeated G is marked negative)
template <template <typename> class Model>
static void run(const In& in, FILE* o) {
  Out ref(in);
  run_element<Model>(in, ref);
  ref.write(o);
  constexpr int G64 = c8::implicit_team_lanes<Model<double>>();
  constexpr int G32 = c8::implicit_team_lanes<Model<float>>();
  const int gs[4] = {1, 4, G64, G32};
  for (int k = 0; k < 4; ++k) {
    bool seen = false;
    for (int j = 0; j < k; ++j) seen = seen || gs[j] == gs[k];
    Out out(in);
    const std::pair<long long, long long> b = k == 0   ? run_team<Model, 1>(in, out)
                                              : k == 1 ? run_team<Model, 4>(in, out)
                                              : k == 2 ? run_team<Model, G64>(in, out)
                                                       : run_team<Model, G32>(in, out);
    const int g = seen ? -gs[k] : gs[k];
    fwrite(&g, sizeof(int), 1, o);
    fwrite(&b.first, sizeof(long long), 1, o);
    fwrite(&b.second, sizeof(long long), 1, o);
    out.write(o);
  }
}
#else
// operations per element of c8::implicit_element on Flop: (E, 5) counts,
// each element's local Newton count, then the operations of one
// line-search trial at its first guess (FREEZE_PATH models; else 0)
template <template <typename> class Model>
static void run(const In& in, FILE* o) {
  typedef c8::Flop F;
  typedef Model<F> M;
  auto cv = [](const std::vector<double>& v) { return std::vector<F>(v.begin(), v.end()); };
  const std::vector<F> x = cv(in.x), xp = cv(in.xp), xip = cv(in.xip), gN = cv(in.gN),
                       detJ = cv(in.detJ), h = cv(in.h), params = cv(in.params);
  const c8::Quad<F> q = quad_of<F>(in);
  const F meas0 = in.D == 2 ? 0.5 : 1.0 / 6.0;
  std::vector<F> R((size_t)in.nde * in.E), J((size_t)in.nde * in.nde * in.E),
      xi((size_t)in.nxi * in.E);
  std::vector<int> path(in.E), fail(in.E), iters(in.E);
  std::vector<long long> ops((size_t)in.E * 5), trial_ops(in.E);
  for (int e = 0; e < in.E; ++e) {
    for (long long& c : F::ops) c = 0;
    c8::implicit_element<F, Model>(e, in.E, x.data(), xp.data(), in.edofs.data(), xip.data(),
                                   gN.data(), detJ.data(), h.data(), params.data(),
                                   in.es.data(), q, meas0, F(in.sc[0]), F(in.sc[1]),
                                   F(in.sc[2]), F(in.sc[3]), R.data(), J.data(), xi.data(),
                                   path.data(), fail.data(), iters.data());
    for (int k = 0; k < 5; ++k) ops[(size_t)e * 5 + k] = F::ops[k];
    if constexpr (c8::has_freeze_path<M>::value) {
      c8::ElemData<F, M> el;
      c8::gather_element<F, M>(e, in.E, x.data(), xp.data(), in.edofs.data(), xip.data(),
                               gN.data(), detJ.data(), h.data(), params.data(), in.es.data(),
                               el);
      F xi0[M::NXI], C0[M::NXI], Ab[M::NXI][M::NXI + 1];
      M::first_guess(el.xip, el.gu, el.gup, el.par(), xi0);
      typename c8::pre_of<M, F>::type pre;
      if constexpr (c8::has_precompute<M>::value) M::precompute(el.gu, el.gup, el.par(), pre);
      const int path0 = c8::local_residual<M>(xi0, el.xip, el.gu, el.gup, pre, el.par(),
                                              F(in.sc[2]), -1, C0);
      for (auto& row : Ab)
        for (F& a : row) a = F(0.0);
      for (long long& c : F::ops) c = 0;
      c8::line_search_trial<F, M>(xi0, Ab, F(1.0), F(1.0), el, pre, el.par(), F(in.sc[2]),
                                  path0, F(1.0));
      for (long long c : F::ops) trial_ops[e] += c;
    }
  }
  wr(o, ops);
  wr(o, iters);
  wr(o, trial_ops);
}
#endif

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  std::vector<int> hdr = rd<int>(f, 8);
  const int model = hdr[0], n_dofs = hdr[2], n_par = hdr[3];
  In in;
  in.E = hdr[1];
  in.npts = hdr[4];
  in.nxi = hdr[5];
  in.nde = hdr[6];
  in.D = hdr[7];
  const int E = in.E, npe = in.D + 1;
  in.sc = rd<double>(f, 4);  // stab_half thick abs_tol fail_tol
  in.params = rd<double>(f, n_par);
  in.x = rd<double>(f, n_dofs);
  in.xp = rd<double>(f, n_dofs);
  in.edofs = rd<int>(f, (size_t)in.nde * E);
  in.xip = rd<double>(f, (size_t)E * in.nxi);
  in.gN = rd<double>(f, (size_t)npe * in.D * E);
  in.detJ = rd<double>(f, E);
  in.h = rd<double>(f, E);
  in.es = rd<int>(f, E);
  in.quad = rd<double>(f, in.npts * npe + in.npts + npe * npe);
  FILE* o = fopen(argv[2], "wb");
  switch (model) {
#ifdef C8_HOSFORD_TWINS
    // tests/test_torch_implicit_eig_host.py's build: the Hosford twins only
    case 9: run<c8::SmallHosford>(in, o); break;
    case 10: run<c8::HypoHosford>(in, o); break;
#else
    case 0: run<c8::SmallHill>(in, o); break;
    case 1: run<c8::SmallHillPlaneStrain>(in, o); break;
    case 2: run<c8::SmallHillPlaneStress>(in, o); break;
    case 3: run<c8::HyperJ2>(in, o); break;
    case 4: run<c8::HyperJ2PlaneStrain>(in, o); break;
    case 5: run<c8::HyperJ2PlaneStress>(in, o); break;
    case 6: run<c8::HypoHill>(in, o); break;
    case 7: run<c8::HypoHillPlaneStrain>(in, o); break;
    case 8: run<c8::HypoHillPlaneStress>(in, o); break;
    case 11: run<c8::HypoBarlat>(in, o); break;
#endif
    default: return 3;
  }
  fclose(o);
  return 0;
}
"""

# the Hosford twins (implicit_eig.cu), built and counted by
# tests/test_torch_implicit_eig_host.py (-DC8_HOSFORD_TWINS)
HOSFORD_MODELS = ("small_hosford", "hypo_hosford")
# the instances of the two libraries that this file checks
TEAM_MODELS = ("small_hill", "small_hill_plane_strain", "small_hill_plane_stress", "hyper_J2",
               "hyper_J2_plane_strain", "hyper_J2_plane_stress", "hypo_hill",
               "hypo_hill_plane_strain", "hypo_hill_plane_stress", "hypo_barlat")
# the bit-for-bit cases: (twin, mesh, deformation scale); hypo_barlat also
# at 5 times the scale, where every element is plastic and the line search
# cuts steps (at 0.02 it accepts every full one)
TEAM_CASES = (("hypo_barlat", CUBE2, 0.02), ("hypo_barlat", CUBE2, 0.1),
              ("small_hill", CUBE2, 0.02), ("hyper_J2", CUBE2, 0.02), ("hypo_hill", CUBE2, 0.02),
              ("hyper_J2_plane_stress", NOTCH, 0.01))


def build_harness(d, builds, timeout=300, source=HARNESS):
    """Build `source` (HARNESS, or a variant of it) into directory d once per
    entry of `builds` ({mode: extra g++ flags}), all side by side; returns
    run(mode, name, header, scalars, params, *arrays), the mode's output
    bytes on those inputs."""
    gxx = shutil.which("g++")
    src = d / "harness.cpp"
    src.write_text(source)
    procs = {mode: subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", *defs, "-I", str(CSRC),
         str(src), "-o", str(d / mode)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for mode, defs in builds.items()}
    for mode, p in procs.items():
        out = p.communicate(timeout=timeout)[0]
        assert p.returncode == 0, out.decode()[-4000:]

    def run(mode, name, header, scalars, params, *arrays):
        inp, out = d / f"{mode}_{name}.in", d / f"{mode}_{name}.out"
        with open(inp, "wb") as fh:
            fh.write(np.asarray(header, np.int32).tobytes())
            fh.write(np.asarray(scalars, np.float64).tobytes())
            fh.write(np.asarray(params, np.float64).tobytes())
            for a in arrays:
                fh.write(np.ascontiguousarray(a).tobytes())
        subprocess.run([str(d / mode), str(inp), str(out)], check=True, timeout=120)
        return out.read_bytes()

    return run


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host harness of csrc/c8_implicit.cuh")
    # the team harness and the counting one, built side by side
    return build_harness(tmp_path_factory.mktemp("team_host"),
                         {"team": (), "count": ("-DC8_COUNT",)})


def twin_state(name, mesh, scale):
    """(prob, x, x_prev, xi_prev) on the twin case's deck with `mesh`:
    tests/test_torch_hyper_assembly.py's displacement state (x_prev at half
    the scale, another seed) and a small previous local state (about the
    initial one for the finite-deformation twins, alpha >= 0) as
    tests/test_torch_hosford_assembly_3d.py builds them."""
    deck = case_deck(TWINS[name], mesh=mesh, num_steps=1)
    prob = Problem(load_deck(copy.deepcopy(deck)), device="cpu")
    disc, bm = prob.disc, prob.assembler.bmodel
    d, mixed = disc.spec.dim, disc.spec.mixed
    coords = disc.mesh.coords
    x = hyper_state(coords, disc.n_nodes, d, mixed, scale, seed=0)
    x_prev = hyper_state(coords, disc.n_nodes, d, mixed, 0.5 * scale, seed=2)
    rng = np.random.default_rng(1)
    xi_prev = 1e-4 * rng.standard_normal((disc.n_elem, bm.nxi))
    if bm.finite_deformation:
        xi_prev = xi_prev + np.asarray(prob.model.init_xi())
        xi_prev[:, -1] = np.abs(xi_prev[:, -1])
    return prob, torch.tensor(x), torch.tensor(x_prev), torch.tensor(xi_prev)


def _run(harness, mode, tag, prob, x, x_prev, xi_prev):
    disc, bm = prob.disc, prob.assembler.bmodel
    name = bm.name
    E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
    quad, npts = _quad_array(disc.spec.dim)
    params = prob.params0.numpy()
    header = [KERNEL_MODEL_ID[name], E, disc.n_dofs, params.size, npts, nxi, nde, disc.spec.dim]
    scalars = [disc.spec.stab_multiplier * 0.5, row_thickness(disc.spec), bm.abs_tol,
               max(bm.abs_tol * 10.0, 1e-30)]
    return harness(mode, tag, header, scalars, params, x.numpy(), x_prev.numpy(),
                   disc.edofs_T.numpy(), xi_prev.numpy(), disc.gN_T.numpy(), disc.detJ.numpy(),
                   disc.h.numpy(), disc.es_ids32.numpy(), np.asarray(list(quad)))


def _outputs(buf, E, nde, nxi):
    """(R, J, xi, path, fail, iters) of one body's run, and the bytes read."""
    sizes = [nde * E, nde * nde * E, nxi * E]
    n64 = 8 * sum(sizes)
    f64 = np.frombuffer(buf[:n64], np.float64)
    ints = np.frombuffer(buf[n64:n64 + 12 * E], np.int32).reshape(3, E)
    return (*np.split(f64, np.cumsum(sizes)[:-1]), *ints), n64 + 12 * E


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def test_team_body_matches_element_bitwise_and_plain(harness):
    shortened_by_G = {}
    for name, mesh, scale in TEAM_CASES:
        prob, x, x_prev, xi_prev = twin_state(name, mesh, scale)
        disc, bm = prob.disc, prob.assembler.bmodel
        E, nde, nxi = disc.n_elem, disc.spec.ndofs_elem, bm.nxi
        buf = _run(harness, "team", f"{name}_{scale}", prob, x, x_prev, xi_prev)
        ref, at = _outputs(buf, E, nde, nxi)
        iters_p = torch.zeros(E, dtype=torch.int32)
        want = fused_assembly_plain(disc, bm, x, xi_prev, prob.params0,
                                    x_prev=x_prev if bm.finite_deformation else None,
                                    newton_iters=iters_p)
        np.testing.assert_array_equal(ref[3], want[3].numpy(), err_msg=name)
        np.testing.assert_array_equal(ref[4], want[4].numpy(), err_msg=name)
        np.testing.assert_array_equal(ref[5], iters_p.numpy(), err_msg=name)
        for got, w, label in zip(ref[:3], (want[0], want[1], want[2]), ("R", "J", "xi")):
            assert _close(got, w.numpy().reshape(-1), 1e-13), (name, label)
        assert int(ref[3].sum()) > 0, (name, "no plastic element")
        lanes = []
        for _ in range(4):
            G = int(np.frombuffer(buf[at:at + 4], np.int32)[0])
            ballots, shortened = np.frombuffer(buf[at + 4:at + 20], np.int64).tolist()
            team, n = _outputs(buf[at + 20:], E, nde, nxi)
            at += 20 + n
            lanes.append(abs(G))
            for a, b, label in zip(team, ref, ("R", "J", "xi", "path", "fail", "iters")):
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (name, G, label)
            if name == "hypo_barlat":
                shortened_by_G[abs(G)] = shortened_by_G.get(abs(G), 0) + shortened
                if G == 1:
                    # one lane's rounds are the sequential search's trials:
                    # the plain version's count, which the bound takes
                    assert ballots == int(plain_trials(prob, x, x_prev, xi_prev).sum()), name
        assert at == len(buf) and lanes[:2] == [1, 4], (name, lanes)
    # the line search cut a step (alpha < 1) on some iterations, at every G
    assert min(shortened_by_G.values()) > 0, shortened_by_G


def plain_trials(prob, x, x_prev, xi_prev):
    """Each element's line-search trials up to the accepted one, from the
    plain local Newton (implicit_newton's `trials`)."""
    disc, bm = prob.disc, prob.assembler.bmodel
    gu = elem_kinematics(disc.spec, x[disc.edofs].T, disc.gN_T)
    gup = elem_kinematics(disc.spec, x_prev[disc.edofs].T, disc.gN_T)
    trials = torch.zeros(disc.n_elem, dtype=torch.int32)
    implicit_newton(bm, xi_prev.T, gu, prob.params0[disc.es_ids.long()].T,
                    gup if bm.finite_deformation else None, trials=trials)
    return trials


def test_operation_counts_match_flops_table(harness):
    # this file counts TEAM_MODELS; tests/test_torch_implicit_eig_host.py
    # the Hosford twins and tests/test_torch_implicit_hybrid_host.py the
    # hybrid, the table's other rows
    assert sorted(FLOPS) == sorted(TEAM_MODELS + HOSFORD_MODELS + ("hybrid_hyper_J2_plane_stress",))
    for name in TEAM_MODELS:
        prob, x, x_prev, xi_prev = twin_state(name, NOTCH if "plane" in name else CUBE2, 0.02)
        E = prob.disc.n_elem
        buf = _run(harness, "count", name, prob, x, x_prev, xi_prev)
        ops = np.frombuffer(buf[:40 * E], np.int64).reshape(E, 5)
        iters = np.frombuffer(buf[40 * E:44 * E], np.int32).astype(np.int64)
        trial = np.frombuffer(buf[44 * E:], np.int64)
        total = ops.sum(1)
        assert len(set(iters.tolist())) >= 2, (name, "one local count: B is not determined")
        A, B, T = FLOPS[name]
        # implicit_element runs all four trials of every update
        np.testing.assert_array_equal(total, A + (B + 4 * T) * iters, err_msg=name)
        np.testing.assert_array_equal(trial, T, err_msg=name)
