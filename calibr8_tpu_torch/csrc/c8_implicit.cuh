// Per-element assembly in the implicit kernel mode: the local Newton for
// xi, the residual rows, and the statically condensed Jacobian
// J = dR/dx - dR/dxi (dC/dxi)^-1 dC/dx (reference evaluations.cpp:112).
// One kernel, implicit_team_kernel, launched from all four implicit
// libraries (implicit_assembly.cu: the twins of c8_hill.cuh, c8_hyper.cuh
// and c8_hypo.cuh; implicit_eig.cu and implicit_barlat.cu: those of
// c8_hosford.cuh; implicit_hybrid.cu: c8_hybrid.cuh's).  It puts a team of
// G lanes of one warp on each element (G from implicit_team_lanes); at G =
// 1 the team is one thread that runs implicit_element, at G > 1 the lanes
// run implicit_team_element and split the element's tangents.  The two
// bodies do the same operations in the same order and so give the same
// bits.
//
// What bounds it on an H100: the arithmetic, not the stores.  An element
// moves ~2.5 KB (J_T is nde^2 words, 2 KB in float64 for the 3D twins),
// 0.15 ms at cube n=32; its operations, counted on the host
// (implicit_cost.FLOPS, one per add, multiply, divide, square root or
// function), are 1e4 (small_hill) to 2e5 (hypo_barlat) per element.  In
// float64 a divide, a square root, pow, log, acos or cos is a sequence of
// many instructions, and the tangents divide too (a'/b), so the kernels
// run many times their count's time at the card's peak rate.  One thread
// carrying Dual<double, 16> (17 words a scalar) spills (hypo_hill 44 KB,
// hypo_barlat 85 KB).  A team gives each lane ceil(N / G) of the N
// tangents, and runs the line search's four trials side by side; its price
// is the primal values, which every lane computes again.  Measured on the
// card (implicit_sweep.py, PERF.md), more lanes win only where one
// thread's spills or its serial trials cost more than that: hypo_hill
// float64 at G = 4, hypo_barlat and the Hosford twins' float64 at G = 2,
// hypo_hill_plane_strain float32 at G = 2; every other instance takes
// G = 1.  With G > 1 the block stages its elements' rows in shared memory
// and stores them so that a warp writes one J entry of consecutive
// elements, the trailing layout; one lane's own stores are that layout
// already.
// A model's parameters are copied into registers (NPAR of them), or, for
// a model with RUNTIME_PAR (the hybrid, whose network the deck sizes),
// read in place from its element set's row in global memory.  A model
// with an ElemConst (the hybrid's NN(0)) forms it once per element, after
// the gather, and its residual reads it.  A model may ask the launch for a
// slab of shared memory per thread (implicit_launch's slab_words: the
// hybrid's deeper networks), which lies after the team's own words, at
// implicit_slab_at().
//
// The arithmetic follows calibr8_tpu's fused Pallas kernel in its
// implicit mode (fem/pallas_assembly.py:242-482) and its local Newton
// (models/batched.py:561-671), as does the port's plain version
// (calibr8_tpu_torch/fem/fused_assembly.py), so the three agree to
// rounding:
//  - local Newton from the model's first guess (xi_prev, or the elastic
//    trial state of the finite-deformation twins), at most
//    M::NEWTON_ITERS iterations: the branch is
//    taken from the current xi, or, for a model with FREEZE_PATH (the
//    eigensolver twins of c8_hosford.cuh), once from the first guess and
//    kept (batched.py:585-586,603,607,667); the lane is done once ||C|| <
//    abs_tol (then it stops, which gives the same xi as calibr8_tpu's
//    gated update); the step is dxi = -(dC/dxi)^-1 C, added times
//    all(isfinite(dxi)), and for FREEZE_PATH models times the alpha of a
//    4-halving Armijo line search on 1/2 ||C||^2 (:621-647), whose trial
//    residuals are evaluated on plain T; fail where ||C(xi)|| >= fail_tol
//    at the end;
//  - small solves: Gauss-Jordan without pivoting, multiplying by
//    1 / A[k][k] (utils/smallsolve.py:64-83);
//  - condensation: the tangents of H(v) = [C; S_rows] over the
//    nxi + d*d seeds of v = [xi; grad_u] (Dual<T, NXI + D*D>, the
//    counterpart of jax.linearize) at the Newton's branch (the frozen one
//    where FREEZE_PATH; pallas_assembly.py:363-400), which is also the
//    element's path, dxi/dgu = -(dC/dxi)^-1 dC/dgu, and
//    the condensed row K_i = dS_i/dgu + sum_k dS_i/dxi_k dxi_k/dgu, the k
//    terms added in index order (pallas_assembly.py:363-400).
// The Newton carries the nxi tangents only (Dual<T, NXI>); the nxi + d*d
// tangents are carried once, at the converged xi.
//
// The precompute hook (calibr8_tpu's precompute / residual_aux,
// models/batched.py:594-603): a model with PRECOMPUTE = true (the hypo
// family of c8_hypo.cuh) splits its residual into Pre<S>, the part that
// does not depend on xi, formed by precompute(gu, gup, par, pre), and
// residual_pre(xi, xip, pre, par, abs_tol, C).  The local Newton forms
// Pre<T> once, before its loop, and its residuals read it as constants;
// the condensation forms Pre<Dual<T, NXI + D*D>> from the seeded grad_u,
// so that dC/dgu carries it.  Models without the hook give residual(xi,
// xip, gu, gup, par, abs_tol, C), which both passes call as before.
//
// Rows: mixed u/p with GLS stabilization and the analytic pressure
// columns (pallas_assembly.py:423-476), or, for displacement-only specs,
// the momentum rows times the thickness (pallas_assembly.py:299-314,
// 402-421).  For FINITE models (pallas_assembly.py:235,299-315,423-451)
// the momentum rows are P = sigma cof(F), times the z-stretch xi when
// displacement only; the stabilization row (tau / det F) cof^T cof
// grad_p depends on grad_u and carries its tangents; the pressure
// columns go through cof(F) and M = cof^T cof / det F at the element's F.
// x_prev is gathered as x is, into the frozen previous grad_u, for FINITE
// models only.  Layouts as in c8_element.cuh, with nde = npe * (d + 1)
// (mixed) or npe * d; iters (E,) int32, when not null, gets each
// element's number of Newton updates.
#pragma once

#include "c8_hypo.cuh"

namespace c8 {

// whether model M has the precompute hook (M::PRECOMPUTE), and its Pre<S>
template <typename M, typename = void>
struct has_precompute : std::false_type {};
template <typename M>
struct has_precompute<M, std::void_t<decltype(M::PRECOMPUTE)>>
    : std::integral_constant<bool, M::PRECOMPUTE> {};

struct NoPre {};
template <typename M, typename S, bool = has_precompute<M>::value>
struct pre_of {
  typedef NoPre type;
};
template <typename M, typename S>
struct pre_of<M, S, true> {
  typedef typename M::template Pre<S> type;
};

// whether model M reads its parameters at run time (M::RUNTIME_PAR: the
// hybrid's network weights, whose count the deck sets): its element set's
// row is read in place, of stride M::par_stride(), and not copied into
// registers
template <typename M, typename = void>
struct has_runtime_par : std::false_type {};
template <typename M>
struct has_runtime_par<M, std::void_t<decltype(M::RUNTIME_PAR)>>
    : std::integral_constant<bool, M::RUNTIME_PAR> {};

// whether model M freezes its branch at the first guess (M::FREEZE_PATH)
template <typename M, typename = void>
struct has_freeze_path : std::false_type {};
template <typename M>
struct has_freeze_path<M, std::void_t<decltype(M::FREEZE_PATH)>>
    : std::integral_constant<bool, M::FREEZE_PATH> {};

// whether model M has constants of its element (M::ElemConst, formed once
// by M::elem_const(par, kc) after the gather: the hybrid's NN(0)), which
// its residual takes after C
template <typename M, typename = void>
struct has_elem_const : std::false_type {};
template <typename M>
struct has_elem_const<M, std::void_t<typename M::ElemConst>> : std::true_type {};
template <typename M, bool = has_elem_const<M>::value>
struct elem_const_of {
  typedef NoConst type;
};
template <typename M>
struct elem_const_of<M, true> {
  typedef typename M::ElemConst type;
};

// C at xi; returns its path.  FREEZE_PATH models take the branch path_in
// (-1: the one xi selects), the others always the one xi selects.  gu
// (any scalar) is read by models without the precompute hook, pre by
// models with it.  ln, the lanes that split the yield surface's own seeds
// (c8_dual.cuh SoloLane / TeamLane), goes to the FREEZE_PATH models (the
// eigensolver twins of c8_hosford.cuh); kc, the element's constants, to
// the models that have them (the others' residuals do not take it).
template <typename M, typename T, typename S, typename G, typename P, typename L = SoloLane,
          typename K = NoConst>
C8_HD int local_residual(const S* xi, const T* xip, const G gu[M::D][M::D],
                         const T gup[M::D][M::D], const P& pre, const T* par, T abs_tol,
                         int path_in, S* C, const L& ln = L(), const K& kc = K()) {
  if constexpr (has_precompute<M>::value) {
    if constexpr (has_freeze_path<M>::value)
      return M::residual_pre(xi, xip, pre, par, abs_tol, path_in, C, ln);
    else
      return M::residual_pre(xi, xip, pre, par, abs_tol, C);
  } else {
    if constexpr (has_freeze_path<M>::value)
      return M::residual(xi, xip, gu, gup, par, abs_tol, path_in, C, ln);
    else if constexpr (has_elem_const<M>::value)
      return M::residual(xi, xip, gu, gup, par, abs_tol, C, kc);
    else
      return M::residual(xi, xip, gu, gup, par, abs_tol, C);
  }
}

// Gauss-Jordan without pivoting on [A | B] (N rows, N + M columns), in
// place; the solution is left in columns N .. N + M - 1.  Columns at or
// left of the pivot are not updated: they do not enter the solution.
template <typename T, int N, int M>
C8_HD void gauss_solve(T Ab[N][N + M]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T inv = T(1) / Ab[k][k];
#pragma unroll
    for (int j = k + 1; j < N + M; ++j) Ab[k][j] = Ab[k][j] * inv;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const T f = Ab[i][k];
#pragma unroll
      for (int j = k + 1; j < N + M; ++j) Ab[i][j] = Ab[i][j] - f * Ab[k][j];
    }
  }
}

// ---- the pieces that the thread-per-element body (implicit_element) and
//      the team body (implicit_team_element) share ----

// an element's gathered inputs: nodal u and p, grad_N, detJ, h, the local
// state xi_prev, the parameters (par(): in registers, or, with
// RUNTIME_PAR, in place in global memory) and grad_u and the frozen
// previous grad_u (FINITE models only; zero otherwise); the model's
// constants of the element (kc, where it has them)
template <typename T, typename M>
struct ElemData {
  static constexpr int D = M::D, NPE = D + 1;
  T u[NPE][D], p[NPE], gN[NPE][D], dJ, hh, par_reg[M::NPAR], xip[M::NXI], gu[D][D], gup[D][D];
  const T* par_rt;
  typename elem_const_of<M>::type kc;
  C8_HD const T* par() const { return has_runtime_par<M>::value ? par_rt : par_reg; }
};

template <typename T, typename M>
C8_HD void gather_element(int e, int E, const T* __restrict__ x, const T* __restrict__ x_prev,
                          const int* __restrict__ edofs_T, const T* __restrict__ xi_prev,
                          const T* __restrict__ gN_T, const T* __restrict__ detJ,
                          const T* __restrict__ h, const T* __restrict__ params,
                          const int* __restrict__ es_ids, ElemData<T, M>& el) {
  constexpr int D = M::D, NPE = D + 1, NXI = M::NXI, NPAR = M::NPAR;
  constexpr int NDPN = M::MIXED ? D + 1 : D;
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int c = 0; c < D; ++c) el.u[n][c] = x[elem_dof(edofs_T, n * NDPN + c, E, e)];
    el.p[n] = M::MIXED ? x[elem_dof(edofs_T, n * NDPN + D, E, e)] : T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) el.gN[n][j] = gN_T[(n * D + j) * E + e];
  }
  el.dJ = detJ[e];
  el.hh = h[e];
  el.par_rt = nullptr;
  if constexpr (has_runtime_par<M>::value) {
    el.par_rt = params + es_ids[e] * M::par_stride();
  } else {
    const T* pe = params + es_ids[e] * NPAR;
#pragma unroll
    for (int k = 0; k < NPAR; ++k) el.par_reg[k] = pe[k];
  }
#pragma unroll
  for (int k = 0; k < NXI; ++k) el.xip[k] = xi_prev[e * NXI + k];

  // grad_u[i][j] = sum_n u[n][i] gN[n][j]; grad_u_prev from x_prev alike
  T up[NPE][D];
#pragma unroll
  for (int n = 0; n < NPE; ++n)
#pragma unroll
    for (int c = 0; c < D; ++c)
      up[n][c] = M::FINITE ? x_prev[elem_dof(edofs_T, n * NDPN + c, E, e)] : T(0);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = el.u[0][i] * el.gN[0][j], accp = up[0][i] * el.gN[0][j];
#pragma unroll
      for (int n = 1; n < NPE; ++n) {
        acc = acc + el.u[n][i] * el.gN[n][j];
        accp = accp + up[n][i] * el.gN[n][j];
      }
      el.gu[i][j] = acc;
      el.gup[i][j] = accp;
    }
  if constexpr (has_elem_const<M>::value) M::elem_const(el.par(), el.kc);
}

// the state-independent pressure data (frozen under the seeds)
template <typename T, int D>
struct PressData {
  T wdv0, inv_npe, p_ip, psf, tau, grad_p[D], coef[4];
};

template <typename T, typename M>
C8_HD void pressure_data(const ElemData<T, M>& el, const Quad<T>& q, T meas0, T stab_half,
                         PressData<T, M::D>& pd) {
  constexpr int D = M::D, NPE = D + 1;
  pd.wdv0 = el.dJ * meas0;
  pd.inv_npe = T(1.0 / NPE);
  pd.p_ip = T(0);
  pd.psf = T(1);
  pd.tau = T(0);
  if constexpr (M::MIXED) {
    const T* par = el.par();
    const T mu = shear_modulus(par);
    pd.psf = M::psf(par);
    pd.tau = stab_half * el.hh * el.hh / mu;
    pd.p_ip = el.p[0];
#pragma unroll
    for (int n = 1; n < NPE; ++n) pd.p_ip = pd.p_ip + el.p[n];
    pd.p_ip = pd.p_ip * pd.inv_npe;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = el.p[0] * el.gN[0][j];
#pragma unroll
      for (int n = 1; n < NPE; ++n) acc = acc + el.p[n] * el.gN[n][j];
      pd.grad_p[j] = acc;
    }
    for (int qq = 0; qq < q.npts; ++qq) {
      T pq = q.N1[qq][0] * el.p[0];
#pragma unroll
      for (int n = 1; n < NPE; ++n) pq = pq + q.N1[qq][n] * el.p[n];
      pd.coef[qq] = (pq / pd.psf) * (q.w1[qq] * el.dJ);
    }
  }
}

// the flux of the rows with the tangents of SV: sigma, or for FINITE
// models P = sigma cof(F) (times the z-stretch when displacement only);
// the pressure row's constant part; the stabilization flux (tau / det F)
// cof^T cof grad_p; cof0 and M0 = cof^T cof / det F at the element's F
// for the pressure columns
template <typename T, int D, typename SV>
struct Flux {
  SV sigma[D][D], rp_const, stab_gp[D];
  T cof0[D][D], M0[D][D];
};

template <typename T, typename M, typename SV>
C8_HD void element_flux(const SV* xv, const SV gv[M::D][M::D], const ElemData<T, M>& el,
                        const PressData<T, M::D>& pd, Flux<T, M::D, SV>& fl) {
  constexpr int D = M::D;
  const T* par = el.par();
  M::stress(xv, gv, par, fl.sigma);
  fl.rp_const = SV(T(0));
  if constexpr (M::MIXED) {
#pragma unroll
    for (int i = 0; i < D; ++i) fl.sigma[i][i] = fl.sigma[i][i] - pd.p_ip;
    fl.rp_const = (-(M::hydro(xv, gv, par) / pd.psf) * pd.inv_npe) * pd.wdv0;
  }
  if constexpr (M::FINITE) {
    SV F[D][D], cof[D][D], P[D][D];
    def_grad<D>(gv, F);
    cofactor<D>(F, cof);
    mat_mul<D>(fl.sigma, cof, P);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if constexpr (M::MIXED) fl.sigma[i][j] = P[i][j];
        else fl.sigma[i][j] = xv[M::Z_STRETCH] * P[i][j];
        fl.cof0[i][j] = cof[i][j].v;
      }
    if constexpr (M::MIXED) {
      SV Mst[D][D];
      mat_mul_at<D>(cof, cof, Mst);
      const SV dF = det<D>(F);
      const SV sc = pd.tau / dF;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        SV acc = Mst[j][0] * pd.grad_p[0];
#pragma unroll
        for (int k = 1; k < D; ++k) acc = acc + Mst[j][k] * pd.grad_p[k];
        fl.stab_gp[j] = sc * acc;
      }
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) fl.M0[i][j] = Mst[i][j].v / dF.v;
    }
  }
}

// row ci of node n (R with its tangents): the momentum rows, or the
// pressure row with its stabilization and the analytic pressure terms
template <typename T, typename M, typename SV>
C8_HD SV element_row(int n, int ci, const Flux<T, M::D, SV>& fl, const ElemData<T, M>& el,
                     const PressData<T, M::D>& pd, const Quad<T>& q, T thick) {
  constexpr int D = M::D;
  if (ci < D) {
    SV acc = fl.sigma[ci][0] * el.gN[n][0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + fl.sigma[ci][j] * el.gN[n][j];
    return M::MIXED ? acc * pd.wdv0 : (acc * pd.wdv0) * thick;
  }
  T r_p1 = T(0);
  for (int qq = 0; qq < q.npts; ++qq) r_p1 = r_p1 + pd.coef[qq] * q.N1[qq][n];
  if constexpr (M::FINITE) {
    SV stab_n = el.gN[n][0] * fl.stab_gp[0];
#pragma unroll
    for (int j = 1; j < D; ++j) stab_n = stab_n + el.gN[n][j] * fl.stab_gp[j];
    return (fl.rp_const - stab_n * pd.wdv0) - r_p1;
  } else {
    T stab_n = (pd.tau * pd.grad_p[0]) * el.gN[n][0];
#pragma unroll
    for (int j = 1; j < D; ++j) stab_n = stab_n + (pd.tau * pd.grad_p[j]) * el.gN[n][j];
    return (fl.rp_const - stab_n * pd.wdv0) - r_p1;
  }
}

// J entry (row of node n, component ci; column of node m, component c)
// from the row's condensed K (NG = d*d entries): K . grad_N, or the
// analytic pressure column
template <typename T, typename M, typename SV>
C8_HD T jac_entry(const T* K, int n, int ci, int m, int c, const Flux<T, M::D, SV>& fl,
                  const ElemData<T, M>& el, const PressData<T, M::D>& pd, const Quad<T>& q) {
  constexpr int D = M::D;
  if (c < D) {
    T acc = K[c * D + 0] * el.gN[m][0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + K[c * D + j] * el.gN[m][j];
    return acc;
  }
  if (ci < D) {
    if constexpr (M::FINITE) {
      T cg = fl.cof0[ci][0] * el.gN[n][0];
#pragma unroll
      for (int j = 1; j < D; ++j) cg = cg + fl.cof0[ci][j] * el.gN[n][j];
      return (-pd.inv_npe * pd.wdv0) * cg;
    } else {
      return (-pd.inv_npe * el.gN[n][ci]) * pd.wdv0;
    }
  }
  T gg = T(0);
  if constexpr (M::FINITE) {
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) gg = gg + (el.gN[n][j] * fl.M0[j][k]) * el.gN[m][k];
  } else {
    gg = el.gN[m][0] * el.gN[n][0];
#pragma unroll
    for (int j = 1; j < D; ++j) gg = gg + el.gN[m][j] * el.gN[n][j];
  }
  return (-pd.tau * pd.wdv0) * gg - (el.dJ / pd.psf) * q.mass[n][m];
}

// one trial of the line search (FREEZE_PATH models), on plain T: C at xi +
// (a gate) dxi, dxi in Ab's last column; whether it is accepted, 1/2
// ||C||^2 <= phi0 (1 - 2e-4 a) with every C finite
template <typename T, typename M, typename P>
C8_HD bool line_search_trial(const T* xi, const T Ab[M::NXI][M::NXI + 1], T a, T gate,
                             const ElemData<T, M>& el, const P& pre, const T* par, T abs_tol,
                             int path0, T phi0) {
  constexpr int NXI = M::NXI;
  T trial[NXI], Ct[NXI];
#pragma unroll
  for (int k = 0; k < NXI; ++k) trial[k] = xi[k] + (a * gate) * Ab[k][NXI];
  local_residual<M>(trial, el.xip, el.gu, el.gup, pre, par, abs_tol, path0, Ct);
  T sq = Ct[0] * Ct[0];
  bool fin = finite(Ct[0]);
#pragma unroll
  for (int k = 1; k < NXI; ++k) {
    sq = sq + Ct[k] * Ct[k];
    fin = fin && finite(Ct[k]);
  }
  return T(0.5) * sq <= phi0 * (T(1) - T(2.0 * 1e-4) * a) && fin;
}

// ---- one element in one thread ----
template <typename T, template <typename> class Model>
C8_HD void implicit_element(
    int e, int E, const T* __restrict__ x, const T* __restrict__ x_prev,
    const int* __restrict__ edofs_T,
    const T* __restrict__ xi_prev, const T* __restrict__ gN_T,
    const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids,
    const Quad<T>& q, T meas0, T stab_half, T thick, T abs_tol, T fail_tol,
    T* __restrict__ R_T, T* __restrict__ J_T, T* __restrict__ xi_T,
    int* __restrict__ path_out, int* __restrict__ fail_out, int* __restrict__ iters_out) {
  typedef Model<T> M;
  constexpr int D = M::D, NPE = D + 1, NG = D * D, NXI = M::NXI;
  constexpr bool MIXED = M::MIXED, PRE = has_precompute<M>::value;
  constexpr bool FREEZE = has_freeze_path<M>::value;
  constexpr int NDPN = MIXED ? D + 1 : D, NDE = NPE * NDPN, NV = NXI + NG;
  constexpr int NEWTON_ITERS = M::NEWTON_ITERS;

  ElemData<T, M> el;
  gather_element<T, M>(e, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, el);
  const T* par = el.par();
  const T* xip = el.xip;

  // ---- local Newton, tangents over xi ----
  typedef Dual<T, NXI> SX;
  T xi[NXI];
  M::first_guess(xip, el.gu, el.gup, par, xi);
  SX gux[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) gux[i][j] = SX(el.gu[i][j]);
  typename pre_of<M, T>::type pre_n;
  if constexpr (PRE) M::precompute(el.gu, el.gup, par, pre_n);
  // FREEZE_PATH: the branch of the first guess, for every evaluation
  int path0 = -1;
  if constexpr (FREEZE) {
    T C0[NXI];
    path0 = local_residual<M>(xi, xip, el.gu, el.gup, pre_n, par, abs_tol, -1, C0);
  }
  int it = 0;
  for (; it < NEWTON_ITERS; ++it) {
    SX xs[NXI], C[NXI];
#pragma unroll
    for (int k = 0; k < NXI; ++k) {
      xs[k] = SX(xi[k]);
      xs[k].d[k] = T(1);
    }
    local_residual<M>(xs, xip, gux, el.gup, pre_n, par, abs_tol, path0, C, SoloLane(), el.kc);
    T rn2 = C[0].v * C[0].v;
#pragma unroll
    for (int k = 1; k < NXI; ++k) rn2 = rn2 + C[k].v * C[k].v;
    if (c8_sqrt(rn2) < abs_tol) break;
    T Ab[NXI][NXI + 1];
#pragma unroll
    for (int i = 0; i < NXI; ++i) {
#pragma unroll
      for (int k = 0; k < NXI; ++k) Ab[i][k] = C[i].d[k];
      Ab[i][NXI] = -C[i].v;
    }
    gauss_solve<T, NXI, 1>(Ab);
    bool ok = true;
#pragma unroll
    for (int k = 0; k < NXI; ++k) ok = ok && finite(Ab[k][NXI]);
    const T gate = ok ? T(1) : T(0);
    T alpha = T(1);
    if constexpr (FREEZE) {
      // the line search on 1/2 ||C||^2, on plain T: four trials at xi +
      // alpha ok dxi; alpha halves until a trial is accepted and stays
      // from then on (1/16 if none is)
      const T rn = c8_sqrt(rn2);
      const T phi0 = (T(0.5) * rn) * rn;
      bool accepted = false;
      for (int ls = 0; ls < 4; ++ls) {
        const bool good = line_search_trial<T, M>(xi, Ab, alpha, gate, el, pre_n, par, abs_tol,
                                                  path0, phi0);
        if (!(good || accepted)) alpha = T(0.5) * alpha;
        accepted = accepted || good;
      }
    }
    // alpha = 1 without the line search: 1 * dxi is dxi, bit for bit
#pragma unroll
    for (int k = 0; k < NXI; ++k) xi[k] = xi[k] + gate * (alpha * Ab[k][NXI]);
  }

  // ---- condensation at the converged xi: seeds over v = [xi; gu] ----
  typedef Dual<T, NV> SV;
  SV xv[NXI], gv[D][D];
#pragma unroll
  for (int k = 0; k < NXI; ++k) {
    xv[k] = SV(xi[k]);
    xv[k].d[k] = T(1);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      gv[i][j] = SV(el.gu[i][j]);
      gv[i][j].d[NXI + i * D + j] = T(1);
    }
  T dxi_dgu[NXI][NG];
  int path;
  {
    SV C[NXI];
    // the branch of the final xi (pathfn), or the frozen one
    typename pre_of<M, SV>::type pre_v;
    if constexpr (PRE) M::precompute(gv, el.gup, par, pre_v);
    path = local_residual<M>(xv, xip, gv, el.gup, pre_v, par, abs_tol, path0, C, SoloLane(),
                             el.kc);
    T rn2 = C[0].v * C[0].v;
#pragma unroll
    for (int k = 1; k < NXI; ++k) rn2 = rn2 + C[k].v * C[k].v;
    fail_out[e] = c8_sqrt(rn2) >= fail_tol ? 1 : 0;
    T Ab[NXI][NXI + NG];
#pragma unroll
    for (int i = 0; i < NXI; ++i)
#pragma unroll
      for (int k = 0; k < NV; ++k) Ab[i][k] = C[i].d[k];
    gauss_solve<T, NXI, NG>(Ab);
#pragma unroll
    for (int k = 0; k < NXI; ++k)
#pragma unroll
      for (int g = 0; g < NG; ++g) dxi_dgu[k][g] = -Ab[k][NXI + g];
  }

  PressData<T, D> pd;
  pressure_data<T, M>(el, q, meas0, stab_half, pd);
  Flux<T, D, SV> fl;
  element_flux<T, M, SV>(xv, gv, el, pd, fl);

  // ---- rows of each node: R, the condensed row K, J = K . grad_N plus
  //      the analytic pressure columns ----
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int ci = 0; ci < NDPN; ++ci) {
      const SV row = element_row<T, M, SV>(n, ci, fl, el, pd, q, thick);
      T K[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        T acc = row.d[NXI + g];
#pragma unroll
        for (int k = 0; k < NXI; ++k) acc = acc + row.d[k] * dxi_dgu[k][g];
        K[g] = acc;
      }
      const int i = n * NDPN + ci;
      R_T[i * E + e] = row.v;
      T* Jrow = J_T + (size_t)i * NDE * E + e;
#pragma unroll
      for (int m = 0; m < NPE; ++m)
#pragma unroll
        for (int c = 0; c < NDPN; ++c)
          Jrow[(size_t)(m * NDPN + c) * E] = jac_entry<T, M, SV>(K, n, ci, m, c, fl, el, pd, q);
    }
  }
#pragma unroll
  for (int k = 0; k < NXI; ++k) xi_T[k * E + e] = xi[k];
  path_out[e] = path;
  if (iters_out) iters_out[e] = it;
}

// ---- one element in a team of G lanes ----
//
// The lanes of the team share the element.  Lane l carries the seeds k
// with k mod G = l, in slot k / G of its duals (Dual<T, ceil(N / G)>), and
// computes every primal value itself: the same operations in the same
// order in every lane, so the same bits, and every branch (the path, ok,
// the Newton's stop) is the team's.  Each tangent component is computed
// apart from the others (c8_dual.cuh), so lane l's tangent k has the bits
// of component k of implicit_element's Dual<T, N>, and the element's
// outputs are implicit_element's, bit for bit.  The lanes meet where they
// need each other's tangents, through the team's scratch `sh`
// (implicit_team_scratch<M>() words) and tm.sync():
//  - the Newton Jacobian dC/dxi is gathered into sh and solved by every
//    lane (the same bits in each);
//  - FREEZE_PATH: the line search's trials alpha = 1, 1/2, 1/4, 1/8 run on
//    lanes 0..3 at once (in rounds when G < 4) and the team takes the first
//    accepted one, tm.ballot: the alpha of the sequential search;
//  - the condensation gathers dC/dxi and each lane solves its own dC/dgu
//    columns (gauss_solve's column operations do not mix columns);
//  - each row's xi tangents go through sh to the lanes that own the grad_u
//    seeds, which form K in implicit_element's order and put it in sh; J's
//    entries are then split across the lanes.
// Outputs go through the team type: put_J(i, col, v) from the lane that
// owns the column, put_R(i, v), put_xi(k, v) and put_ints(path, fail,
// iters) from lane 0, row_done(i) after row i, done() at the end.  It also
// gives `lane`, sync() and ballot(bool) (a mask of the team's lanes, bit l
// for lane l).  Where row_done and done are barriers of every team that
// shares a stage, every one of them runs the body (the card's block
// clamps its last teams to the last element and masks their stores).

// the lanes of an instance's team: M::TEAM_LANES where the model gives it
// (it may depend on T), else 1, set from `python -m
// calibr8_tpu_torch.implicit_sweep` on the card (PERF.md); a build with
// -DC8_IMPLICIT_TEAM=G fixes G (the sweep's builds)
template <typename M, typename = void>
struct team_lanes_of : std::integral_constant<int, 1> {};
template <typename M>
struct team_lanes_of<M, std::void_t<decltype(M::TEAM_LANES)>>
    : std::integral_constant<int, M::TEAM_LANES> {};

template <typename M>
C8_HD constexpr int implicit_team_lanes() {
#ifdef C8_IMPLICIT_TEAM
  return C8_IMPLICIT_TEAM;
#else
  return team_lanes_of<M>::value;
#endif
}

// scratch words of one team; the element's dofs
template <typename M>
C8_HD constexpr int implicit_team_scratch() {
  return M::NXI * M::NXI > M::NXI + M::D * M::D ? M::NXI * M::NXI : M::NXI + M::D * M::D;
}
template <typename M>
C8_HD constexpr int implicit_team_dofs() {
  return (M::D + 1) * (M::MIXED ? M::D + 1 : M::D);
}

template <typename T, template <typename> class Model, int G, typename Team>
C8_HD void implicit_team_element(
    const Team& tm, int e, int E, const T* __restrict__ x, const T* __restrict__ x_prev,
    const int* __restrict__ edofs_T, const T* __restrict__ xi_prev, const T* __restrict__ gN_T,
    const T* __restrict__ detJ, const T* __restrict__ h, const T* __restrict__ params,
    const int* __restrict__ es_ids, const Quad<T>& q, T meas0, T stab_half, T thick, T abs_tol,
    T fail_tol, T* sh) {
  typedef Model<T> M;
  constexpr int D = M::D, NPE = D + 1, NG = D * D, NXI = M::NXI;
  constexpr bool MIXED = M::MIXED, PRE = has_precompute<M>::value;
  constexpr bool FREEZE = has_freeze_path<M>::value;
  constexpr int NDPN = MIXED ? D + 1 : D, NDE = NPE * NDPN, NV = NXI + NG;
  constexpr int NEWTON_ITERS = M::NEWTON_ITERS;
  // the lane's slots: seed j G + l in slot j
  constexpr int NLX = (NXI + G - 1) / G, NL = (NV + G - 1) / G;
  const int l = tm.lane;
  // the residual's own seeds split the same way (the eigensolver twins'
  // yield surface, c8_eig.cuh yield_inner: 7 x 6 words of sh, free while a
  // residual runs)
  static_assert(!FREEZE || implicit_team_scratch<M>() >= 7 * 6, "yield_inner's scratch");
  const TeamLane<G, Team, T> lanes{tm, sh, l};

  ElemData<T, M> el;
  gather_element<T, M>(e, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, el);
  const T* par = el.par();
  const T* xip = el.xip;

  // ---- local Newton, the lane's tangents over xi ----
  typedef Dual<T, NLX> SX;
  T xi[NXI];
  M::first_guess(xip, el.gu, el.gup, par, xi);
  SX gux[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) gux[i][j] = SX(el.gu[i][j]);
  typename pre_of<M, T>::type pre_n;
  if constexpr (PRE) M::precompute(el.gu, el.gup, par, pre_n);
  int path0 = -1;
  if constexpr (FREEZE) {
    T C0[NXI];
    path0 = local_residual<M>(xi, xip, el.gu, el.gup, pre_n, par, abs_tol, -1, C0);
  }
  int it = 0;
  for (; it < NEWTON_ITERS; ++it) {
    SX xs[NXI], C[NXI];
#pragma unroll
    for (int k = 0; k < NXI; ++k) {
      xs[k] = SX(xi[k]);
#pragma unroll
      for (int j = 0; j < NLX; ++j) xs[k].d[j] = j * G + l == k ? T(1) : T(0);
    }
    local_residual<M>(xs, xip, gux, el.gup, pre_n, par, abs_tol, path0, C, lanes, el.kc);
    T rn2 = C[0].v * C[0].v;
#pragma unroll
    for (int k = 1; k < NXI; ++k) rn2 = rn2 + C[k].v * C[k].v;
    if (c8_sqrt(rn2) < abs_tol) break;
    // dC/dxi: sh[i NXI + k] = C[i].d of seed k
#pragma unroll
    for (int i = 0; i < NXI; ++i)
#pragma unroll
      for (int j = 0; j < NLX; ++j)
        if (j * G + l < NXI) sh[i * NXI + j * G + l] = C[i].d[j];
    tm.sync();
    T Ab[NXI][NXI + 1];
#pragma unroll
    for (int i = 0; i < NXI; ++i) {
#pragma unroll
      for (int k = 0; k < NXI; ++k) Ab[i][k] = sh[i * NXI + k];
      Ab[i][NXI] = -C[i].v;
    }
    tm.sync();
    gauss_solve<T, NXI, 1>(Ab);
    bool ok = true;
#pragma unroll
    for (int k = 0; k < NXI; ++k) ok = ok && finite(Ab[k][NXI]);
    const T gate = ok ? T(1) : T(0);
    T alpha = T(1);
    if constexpr (FREEZE) {
      // trial t (0..3) at alpha 2^-t, on lane t mod G in round t / G; the
      // sequential search ends at alpha 2^-t of the first accepted t (its
      // trials before t ran at these alphas, its trials after t change
      // nothing), or at 1/16
      const T rn = c8_sqrt(rn2);
      const T phi0 = (T(0.5) * rn) * rn;
      int first = 4;
      for (int r = 0; r * G < 4; ++r) {
        const int t = r * G + l;
        bool good = false;
        if (t < 4) {
          T a = T(1);
          for (int s = 0; s < t; ++s) a = T(0.5) * a;
          good = line_search_trial<T, M>(xi, Ab, a, gate, el, pre_n, par, abs_tol, path0, phi0);
        }
        const unsigned acc = tm.ballot(good);
        if (acc) {
          int f = 0;
          while (!((acc >> f) & 1u)) ++f;
          first = r * G + f;
          break;
        }
      }
      for (int s = 0; s < first; ++s) alpha = T(0.5) * alpha;
    }
#pragma unroll
    for (int k = 0; k < NXI; ++k) xi[k] = xi[k] + gate * (alpha * Ab[k][NXI]);
  }

  // ---- condensation at the converged xi: the lane's seeds over v ----
  typedef Dual<T, NL> SV;
  SV xv[NXI], gv[D][D];
#pragma unroll
  for (int k = 0; k < NXI; ++k) {
    xv[k] = SV(xi[k]);
#pragma unroll
    for (int j = 0; j < NL; ++j) xv[k].d[j] = j * G + l == k ? T(1) : T(0);
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      gv[i][j] = SV(el.gu[i][j]);
#pragma unroll
      for (int s = 0; s < NL; ++s) gv[i][j].d[s] = s * G + l == NXI + i * D + j ? T(1) : T(0);
    }
  // dxi[k][j]: dxi_k / d(seed j G + l), for the lane's grad_u seeds
  T dxi[NXI][NL];
  int path, fail;
  {
    SV C[NXI];
    typename pre_of<M, SV>::type pre_v;
    if constexpr (PRE) M::precompute(gv, el.gup, par, pre_v);
    path = local_residual<M>(xv, xip, gv, el.gup, pre_v, par, abs_tol, path0, C, lanes, el.kc);
    T rn2 = C[0].v * C[0].v;
#pragma unroll
    for (int k = 1; k < NXI; ++k) rn2 = rn2 + C[k].v * C[k].v;
    fail = c8_sqrt(rn2) >= fail_tol ? 1 : 0;
#pragma unroll
    for (int i = 0; i < NXI; ++i)
#pragma unroll
      for (int j = 0; j < NL; ++j)
        if (j * G + l < NXI) sh[i * NXI + j * G + l] = C[i].d[j];
    tm.sync();
    T Ab[NXI][NXI + NL];
#pragma unroll
    for (int i = 0; i < NXI; ++i) {
#pragma unroll
      for (int k = 0; k < NXI; ++k) Ab[i][k] = sh[i * NXI + k];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int s = j * G + l;
        Ab[i][NXI + j] = s >= NXI && s < NV ? C[i].d[j] : T(0);
      }
    }
    tm.sync();
    gauss_solve<T, NXI, NL>(Ab);
#pragma unroll
    for (int k = 0; k < NXI; ++k)
#pragma unroll
      for (int j = 0; j < NL; ++j) dxi[k][j] = -Ab[k][NXI + j];
  }

  PressData<T, D> pd;
  pressure_data<T, M>(el, q, meas0, stab_half, pd);
  Flux<T, D, SV> fl;
  element_flux<T, M, SV>(xv, gv, el, pd, fl);

  // ---- rows: the xi tangents to sh[0 .. NXI), K to sh[NXI .. NV), then
  //      J's entries of the row, column col on lane col mod G ----
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int ci = 0; ci < NDPN; ++ci) {
      const SV row = element_row<T, M, SV>(n, ci, fl, el, pd, q, thick);
#pragma unroll
      for (int j = 0; j < NL; ++j)
        if (j * G + l < NXI) sh[j * G + l] = row.d[j];
      tm.sync();
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int s = j * G + l;
        if (s >= NXI && s < NV) {
          T acc = row.d[j];
#pragma unroll
          for (int k = 0; k < NXI; ++k) acc = acc + sh[k] * dxi[k][j];
          sh[s] = acc;
        }
      }
      tm.sync();
      const int i = n * NDPN + ci;
#pragma unroll
      for (int m = 0; m < NPE; ++m)
#pragma unroll
        for (int c = 0; c < NDPN; ++c)
          if ((m * NDPN + c) % G == l)
            tm.put_J(i, m * NDPN + c, jac_entry<T, M, SV>(sh + NXI, n, ci, m, c, fl, el, pd, q));
      if (l == 0) tm.put_R(i, row.v);
      tm.row_done(i);
    }
  }
  if (l == 0) {
#pragma unroll
    for (int k = 0; k < NXI; ++k) tm.put_xi(k, xi[k]);
    tm.put_ints(path, fail, it);
  }
  tm.done();
}

}  // namespace c8

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace c8 {

// the block of the team kernel: THREADS lanes, EB = THREADS / G elements.
// For G > 1 shared memory holds each team's scratch and the block's stage:
// word f of element b at stage[f * EBP + b] (row i's J entries, its R,
// then xi; EBP = EB + 1 spreads a team's writes over the banks), then
// path, fail and iters, EB ints each.
template <typename T, typename M>
struct TeamLayout {
  static constexpr int G = implicit_team_lanes<M>();
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G divides 32");
  static constexpr int THREADS = 128, EB = THREADS / G, EBP = EB + 1;
  static constexpr int NDE = implicit_team_dofs<M>(), NXI = M::NXI;
  static constexpr int NS = implicit_team_scratch<M>(), NST = NDE + 1 + NXI;
  static constexpr size_t SMEM =
      G == 1 ? 0 : (size_t)(EB * NS + NST * EBP) * sizeof(T) + 3 * EB * sizeof(int);
};

// a team of G > 1 consecutive lanes of one warp, in a block that stores
// its teams' staged rows together: consecutive threads store one output
// word of consecutive elements, the trailing layout's order
template <typename T, typename L>
struct BlockTeam {
  int lane, first;  // the lane in the team, the team's first lane in the warp
  unsigned mask;    // the team's lanes in the warp
  int E, e0, nE;    // elements; the block's first one and its count
  T* stage;         // the block's stage, and the team's column of it
  T* st;
  int* istage;
  int* ist;
  T *R_T, *J_T, *xi_T;
  int *path, *fail, *iters;
  // C8_HD, as the team body is; the body runs only on the card
  C8_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }
  C8_HD unsigned ballot(bool p) const {
#ifdef __CUDA_ARCH__
    return (__ballot_sync(mask, p) & mask) >> first;
#else
    return p;
#endif
  }
  C8_HD void put_J(int, int col, T v) const { st[col * L::EBP] = v; }
  C8_HD void put_R(int, T v) const { st[L::NDE * L::EBP] = v; }
  C8_HD void put_xi(int k, T v) const { st[(L::NDE + 1 + k) * L::EBP] = v; }
  C8_HD void put_ints(int p, int f, int it) const {
    ist[0] = p;
    ist[L::EB] = f;
    ist[2 * L::EB] = it;
  }
  C8_HD void row_done(int i) const {
#ifdef __CUDA_ARCH__
    __syncthreads();
    for (int k = threadIdx.x; k < (L::NDE + 1) * L::EB; k += L::THREADS) {
      const int f = k / L::EB, b = k % L::EB;
      if (b >= nE) continue;
      const T v = stage[f * L::EBP + b];
      if (f < L::NDE) J_T[((size_t)i * L::NDE + f) * E + e0 + b] = v;
      else R_T[(size_t)i * E + e0 + b] = v;
    }
    __syncthreads();
#endif
  }
  C8_HD void done() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
    for (int k = threadIdx.x; k < L::NXI * L::EB; k += L::THREADS) {
      const int f = k / L::EB, b = k % L::EB;
      if (b < nE) xi_T[(size_t)f * E + e0 + b] = stage[(L::NDE + 1 + f) * L::EBP + b];
    }
    if ((int)threadIdx.x < nE) {
      path[e0 + threadIdx.x] = istage[threadIdx.x];
      fail[e0 + threadIdx.x] = istage[L::EB + threadIdx.x];
      if (iters) iters[e0 + threadIdx.x] = istage[2 * L::EB + threadIdx.x];
    }
#endif
  }
};

template <typename T, template <typename> class Model>
__global__ void __launch_bounds__(TeamLayout<T, Model<T>>::THREADS) implicit_team_kernel(
    int E, const T* __restrict__ x, const T* __restrict__ x_prev,
    const int* __restrict__ edofs_T, const T* __restrict__ xi_prev,
    const T* __restrict__ gN_T, const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids, const Quad<T> q, T meas0,
    T stab_half, T thick, T abs_tol, T fail_tol, T* __restrict__ R_T, T* __restrict__ J_T,
    T* __restrict__ xi_T, int* __restrict__ path, int* __restrict__ fail,
    int* __restrict__ iters) {
  typedef TeamLayout<T, Model<T>> L;
  constexpr int G = L::G, EB = L::EB;
  if constexpr (G == 1) {
    // a team of one lane is implicit_element: it has no one to exchange
    // with, and its own stores are the trailing layout's
    const int e = blockIdx.x * EB + threadIdx.x;
    if (e < E)
      implicit_element<T, Model>(e, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params,
                                 es_ids, q, meas0, stab_half, thick, abs_tol, fail_tol, R_T, J_T,
                                 xi_T, path, fail, iters);
  } else {
    extern __shared__ double c8_team_smem[];
    T* sh = reinterpret_cast<T*>(c8_team_smem);
    T* stage = sh + EB * L::NS;
    int* istage = reinterpret_cast<int*>(stage + L::NST * L::EBP);
    const int b = threadIdx.x / G, e0 = blockIdx.x * EB;
    BlockTeam<T, L> tm;
    tm.lane = threadIdx.x % G;
    tm.first = (threadIdx.x % 32) - tm.lane;
    tm.mask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << tm.first;
    tm.E = E;
    tm.e0 = e0;
    tm.nE = E - e0 < EB ? E - e0 : EB;
    tm.stage = stage;
    tm.st = stage + b;
    tm.istage = istage;
    tm.ist = istage + b;
    tm.R_T = R_T;
    tm.J_T = J_T;
    tm.xi_T = xi_T;
    tm.path = path;
    tm.fail = fail;
    tm.iters = iters;
    // the block's last teams, past the last element, redo it: every team
    // reaches the stage's barriers; the block's stores stop at nE
    const int e = e0 + b < E ? e0 + b : E - 1;
    implicit_team_element<T, Model, G>(tm, e, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h,
                                       params, es_ids, q, meas0, stab_half, thick, abs_tol,
                                       fail_tol, sh + b * L::NS);
  }
}

// where a model's slab of shared memory starts in its block's dynamic
// shared memory: after the team's words, at 16 bytes
template <typename T, typename M>
constexpr size_t implicit_slab_at() {
  return (TeamLayout<T, M>::SMEM + 15) / 16 * 16;
}

// one launch of Model's team kernel on `stream`; returns the launch's
// cudaError_t.  quad = [N1 (npts, npe) | w1 (npts) | mass (npe, npe)],
// row-major doubles.  slab_words > 0: each thread also gets that many
// words of T of shared memory at implicit_slab_at().
template <typename T, template <typename> class Model>
int implicit_launch(int E, const void* x, const void* x_prev, const void* edofs_T,
                    const void* xi_prev, const void* gN_T, const void* detJ, const void* h,
                    const void* params, const void* es_ids, const double* quad, int npts,
                    double stab_half, double thick, double abs_tol, double fail_tol, void* R_T,
                    void* J_T, void* xi_T, void* path, void* fail, void* iters,
                    cudaStream_t stream, int slab_words = 0) {
  constexpr int D = Model<T>::D, NPE = D + 1;
  Quad<T> q;
  for (int a = 0; a < 4; ++a) {
    q.w1[a] = T(0);
    for (int b = 0; b < 4; ++b) q.N1[a][b] = q.mass[a][b] = T(0);
  }
  for (int a = 0; a < npts; ++a)
    for (int n = 0; n < NPE; ++n) q.N1[a][n] = T(quad[a * NPE + n]);
  for (int a = 0; a < npts; ++a) q.w1[a] = T(quad[npts * NPE + a]);
  for (int n = 0; n < NPE; ++n)
    for (int m = 0; m < NPE; ++m) q.mass[n][m] = T(quad[npts * NPE + npts + n * NPE + m]);
  q.npts = npts;
  const T meas0 = T(D == 2 ? 0.5 : 1.0 / 6.0);
  if (E <= 0) return (int)cudaGetLastError();
  typedef TeamLayout<T, Model<T>> L;
  const size_t smem = slab_words > 0 ? implicit_slab_at<T, Model<T>>() +
                                           (size_t)slab_words * sizeof(T) * L::THREADS
                                     : L::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        implicit_team_kernel<T, Model>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  implicit_team_kernel<T, Model><<<(E + L::EB - 1) / L::EB, L::THREADS, smem, stream>>>(
      E, (const T*)x, (const T*)x_prev, (const int*)edofs_T, (const T*)xi_prev, (const T*)gN_T,
      (const T*)detJ, (const T*)h, (const T*)params, (const int*)es_ids, q, meas0, T(stab_half),
      T(thick), T(abs_tol), T(fail_tol), (T*)R_T, (T*)J_T, (T*)xi_T, (int*)path, (int*)fail,
      (int*)iters);
  return (int)cudaGetLastError();
}

// the body of a library's C entry point: `model` selects Models[model],
// `dtype` float (0) or double (1); slab_words as for implicit_launch;
// returns the launch's cudaError_t
template <template <typename> class... Models>
int implicit_team_entry(int device, int dtype, int model, int E, const void* x,
                        const void* x_prev, const void* edofs_T, const void* xi_prev,
                        const void* gN_T, const void* detJ, const void* h, const void* params,
                        const void* es_ids, const double* quad, int npts, double stab_half,
                        double thick, double abs_tol, double fail_tol, void* R_T, void* J_T,
                        void* xi_T, void* path, void* fail, void* iters, void* stream,
                        int slab_words = 0) {
  if (npts < 1 || npts > 4 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue, id = 0;
  // one test per model, in order; only Models[model] launches
  ((model == id++
        ? (rc = dtype == 0
                    ? implicit_launch<float, Models>(
                          E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad,
                          npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail,
                          iters, s, slab_words)
                    : implicit_launch<double, Models>(
                          E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids, quad,
                          npts, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T, path, fail,
                          iters, s, slab_words))
        : 0),
   ...);
  return rc;
}

}  // namespace c8

#endif  // __CUDACC__
