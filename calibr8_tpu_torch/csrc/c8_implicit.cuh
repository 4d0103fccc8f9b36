// Per-element assembly in the implicit kernel mode: the local Newton for
// xi, the residual rows, and the statically condensed Jacobian
// J = dR/dx - dR/dxi (dC/dxi)^-1 dC/dx (reference evaluations.cpp:112).
// One call handles one element; implicit_assembly_kernel below runs it in
// one thread per element (launched from implicit_assembly.cu for the
// small-strain twins of c8_hill.cuh and the finite-deformation twins of
// c8_hyper.cuh and c8_hypo.cuh; from implicit_eig.cu, implicit_barlat.cu
// and implicit_hybrid.cu for those of c8_hosford.cuh and c8_hybrid.cuh).
// A model's parameters are copied into registers (NPAR of them), or, for
// a model with RUNTIME_PAR (the hybrid, whose network the deck sizes),
// read in place from its element set's row in global memory.
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

// C at xi; returns its path.  FREEZE_PATH models take the branch path_in
// (-1: the one xi selects), the others always the one xi selects.  gu
// (any scalar) is read by models without the precompute hook, pre by
// models with it.
template <typename M, typename T, typename S, typename G, typename P>
C8_HD int local_residual(const S* xi, const T* xip, const G gu[M::D][M::D],
                         const T gup[M::D][M::D], const P& pre, const T* par, T abs_tol,
                         int path_in, S* C) {
  if constexpr (has_precompute<M>::value) {
    if constexpr (has_freeze_path<M>::value)
      return M::residual_pre(xi, xip, pre, par, abs_tol, path_in, C);
    else
      return M::residual_pre(xi, xip, pre, par, abs_tol, C);
  } else {
    if constexpr (has_freeze_path<M>::value)
      return M::residual(xi, xip, gu, gup, par, abs_tol, path_in, C);
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
  constexpr int D = M::D, NPE = D + 1, NG = D * D, NXI = M::NXI, NPAR = M::NPAR;
  constexpr bool MIXED = M::MIXED, FINITE = M::FINITE, PRE = has_precompute<M>::value;
  constexpr bool FREEZE = has_freeze_path<M>::value;
  constexpr int NDPN = MIXED ? D + 1 : D, NDE = NPE * NDPN, NV = NXI + NG;
  constexpr int NEWTON_ITERS = M::NEWTON_ITERS;

  // ---- gather ----
  T u[NPE][D], p[NPE], gN[NPE][D];
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int c = 0; c < D; ++c) u[n][c] = x[elem_dof(edofs_T, n * NDPN + c, E, e)];
    p[n] = MIXED ? x[elem_dof(edofs_T, n * NDPN + D, E, e)] : T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) gN[n][j] = gN_T[(n * D + j) * E + e];
  }
  const T dJ = detJ[e], hh = h[e];
  T par_reg[NPAR], xip[NXI];
  const T* par = par_reg;
  if constexpr (has_runtime_par<M>::value) {
    par = params + es_ids[e] * M::par_stride();
  } else {
    const T* pe = params + es_ids[e] * NPAR;
#pragma unroll
    for (int k = 0; k < NPAR; ++k) par_reg[k] = pe[k];
  }
#pragma unroll
  for (int k = 0; k < NXI; ++k) xip[k] = xi_prev[e * NXI + k];

  // ---- kinematics: grad_u[i][j] = sum_n u[n][i] gN[n][j]; grad_u_prev
  //      from x_prev alike (FINITE models only; zero otherwise) ----
  T up[NPE][D];
#pragma unroll
  for (int n = 0; n < NPE; ++n)
#pragma unroll
    for (int c = 0; c < D; ++c) up[n][c] = FINITE ? x_prev[elem_dof(edofs_T, n * NDPN + c, E, e)] : T(0);
  T gu[D][D], gup[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = u[0][i] * gN[0][j], accp = up[0][i] * gN[0][j];
#pragma unroll
      for (int n = 1; n < NPE; ++n) {
        acc = acc + u[n][i] * gN[n][j];
        accp = accp + up[n][i] * gN[n][j];
      }
      gu[i][j] = acc;
      gup[i][j] = accp;
    }

  // ---- local Newton, tangents over xi ----
  typedef Dual<T, NXI> SX;
  T xi[NXI];
  M::first_guess(xip, gu, gup, par, xi);
  SX gux[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) gux[i][j] = SX(gu[i][j]);
  typename pre_of<M, T>::type pre_n;
  if constexpr (PRE) M::precompute(gu, gup, par, pre_n);
  // FREEZE_PATH: the branch of the first guess, for every evaluation
  int path0 = -1;
  if constexpr (FREEZE) {
    T C0[NXI];
    path0 = local_residual<M>(xi, xip, gu, gup, pre_n, par, abs_tol, -1, C0);
  }
  int it = 0;
  for (; it < NEWTON_ITERS; ++it) {
    SX xs[NXI], C[NXI];
#pragma unroll
    for (int k = 0; k < NXI; ++k) {
      xs[k] = SX(xi[k]);
      xs[k].d[k] = T(1);
    }
    local_residual<M>(xs, xip, gux, gup, pre_n, par, abs_tol, path0, C);
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
        T trial[NXI], Ct[NXI];
#pragma unroll
        for (int k = 0; k < NXI; ++k) trial[k] = xi[k] + (alpha * gate) * Ab[k][NXI];
        local_residual<M>(trial, xip, gu, gup, pre_n, par, abs_tol, path0, Ct);
        T sq = Ct[0] * Ct[0];
        bool fin = finite(Ct[0]);
#pragma unroll
        for (int k = 1; k < NXI; ++k) {
          sq = sq + Ct[k] * Ct[k];
          fin = fin && finite(Ct[k]);
        }
        const bool good = T(0.5) * sq <= phi0 * (T(1) - T(2.0 * 1e-4) * alpha) && fin;
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
      gv[i][j] = SV(gu[i][j]);
      gv[i][j].d[NXI + i * D + j] = T(1);
    }
  T dxi_dgu[NXI][NG];
  int path;
  {
    SV C[NXI];
    // the branch of the final xi (pathfn), or the frozen one
    typename pre_of<M, SV>::type pre_v;
    if constexpr (PRE) M::precompute(gv, gup, par, pre_v);
    path = local_residual<M>(xv, xip, gv, gup, pre_v, par, abs_tol, path0, C);
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

  // ---- state-independent pressure data (frozen under the seeds) ----
  const T wdv0 = dJ * meas0;
  const T inv_npe = T(1.0 / NPE);
  T p_ip = T(0), psf = T(1), tau = T(0), grad_p[D], coef[4];
  if constexpr (MIXED) {
    const T mu = shear_modulus(par);
    psf = M::psf(par);
    tau = stab_half * hh * hh / mu;
    p_ip = p[0];
#pragma unroll
    for (int n = 1; n < NPE; ++n) p_ip = p_ip + p[n];
    p_ip = p_ip * inv_npe;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = p[0] * gN[0][j];
#pragma unroll
      for (int n = 1; n < NPE; ++n) acc = acc + p[n] * gN[n][j];
      grad_p[j] = acc;
    }
    for (int qq = 0; qq < q.npts; ++qq) {
      T pq = q.N1[qq][0] * p[0];
#pragma unroll
      for (int n = 1; n < NPE; ++n) pq = pq + q.N1[qq][n] * p[n];
      coef[qq] = (pq / psf) * (q.w1[qq] * dJ);
    }
  }

  // ---- stress with the nxi + d*d tangents ----
  SV sigma[D][D];
  M::stress(xv, gv, par, sigma);
  SV rp_const(T(0));
  if constexpr (MIXED) {
#pragma unroll
    for (int i = 0; i < D; ++i) sigma[i][i] = sigma[i][i] - p_ip;
    rp_const = (-(M::hydro(xv, gv, par) / psf) * inv_npe) * wdv0;
  }
  // FINITE: sigma becomes P = sigma cof(F) (times the z-stretch when
  // displacement only); the stabilization flux (tau / det F) cof^T cof
  // grad_p; cof0 and M0 = cof^T cof / det F at the element's F for the
  // pressure columns
  SV stab_gp[D];
  T cof0[D][D], M0[D][D];
  if constexpr (FINITE) {
    SV F[D][D], cof[D][D], P[D][D];
    def_grad<D>(gv, F);
    cofactor<D>(F, cof);
    mat_mul<D>(sigma, cof, P);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if constexpr (MIXED) sigma[i][j] = P[i][j];
        else sigma[i][j] = xv[M::Z_STRETCH] * P[i][j];
        cof0[i][j] = cof[i][j].v;
      }
    if constexpr (MIXED) {
      SV Mst[D][D];
      mat_mul_at<D>(cof, cof, Mst);
      const SV dF = det<D>(F);
      const SV sc = tau / dF;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        SV acc = Mst[j][0] * grad_p[0];
#pragma unroll
        for (int k = 1; k < D; ++k) acc = acc + Mst[j][k] * grad_p[k];
        stab_gp[j] = sc * acc;
      }
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) M0[i][j] = Mst[i][j].v / dF.v;
    }
  }

  // ---- rows of each node: R, the condensed row K, J = K . grad_N plus
  //      the analytic pressure columns ----
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int ci = 0; ci < NDPN; ++ci) {
      SV row;
      if (ci < D) {
        SV acc = sigma[ci][0] * gN[n][0];
#pragma unroll
        for (int j = 1; j < D; ++j) acc = acc + sigma[ci][j] * gN[n][j];
        row = MIXED ? acc * wdv0 : (acc * wdv0) * thick;
      } else {
        T r_p1 = T(0);
        for (int qq = 0; qq < q.npts; ++qq) r_p1 = r_p1 + coef[qq] * q.N1[qq][n];
        if constexpr (FINITE) {
          SV stab_n = gN[n][0] * stab_gp[0];
#pragma unroll
          for (int j = 1; j < D; ++j) stab_n = stab_n + gN[n][j] * stab_gp[j];
          row = (rp_const - stab_n * wdv0) - r_p1;
        } else {
          T stab_n = (tau * grad_p[0]) * gN[n][0];
#pragma unroll
          for (int j = 1; j < D; ++j) stab_n = stab_n + (tau * grad_p[j]) * gN[n][j];
          row = (rp_const - stab_n * wdv0) - r_p1;
        }
      }
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
      for (int m = 0; m < NPE; ++m) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          T acc = K[c * D + 0] * gN[m][0];
#pragma unroll
          for (int j = 1; j < D; ++j) acc = acc + K[c * D + j] * gN[m][j];
          Jrow[(size_t)(m * NDPN + c) * E] = acc;
        }
        if constexpr (MIXED) {
          T pcol;
          if (ci < D) {
            if constexpr (FINITE) {
              T cg = cof0[ci][0] * gN[n][0];
#pragma unroll
              for (int j = 1; j < D; ++j) cg = cg + cof0[ci][j] * gN[n][j];
              pcol = (-inv_npe * wdv0) * cg;
            } else {
              pcol = (-inv_npe * gN[n][ci]) * wdv0;
            }
          } else {
            T gg = T(0);
            if constexpr (FINITE) {
#pragma unroll
              for (int j = 0; j < D; ++j)
#pragma unroll
                for (int k = 0; k < D; ++k) gg = gg + (gN[n][j] * M0[j][k]) * gN[m][k];
            } else {
              gg = gN[m][0] * gN[n][0];
#pragma unroll
              for (int j = 1; j < D; ++j) gg = gg + gN[m][j] * gN[n][j];
            }
            pcol = (-tau * wdv0) * gg - (dJ / psf) * q.mass[n][m];
          }
          Jrow[(size_t)(m * NDPN + D) * E] = pcol;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NXI; ++k) xi_T[k * E + e] = xi[k];
  path_out[e] = path;
  if (iters_out) iters_out[e] = it;
}

}  // namespace c8

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace c8 {

template <typename T, template <typename> class Model>
__global__ void __launch_bounds__(128) implicit_assembly_kernel(
    int E, const T* __restrict__ x, const T* __restrict__ x_prev,
    const int* __restrict__ edofs_T, const T* __restrict__ xi_prev,
    const T* __restrict__ gN_T, const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids, const Quad<T> q, T meas0,
    T stab_half, T thick, T abs_tol, T fail_tol, T* __restrict__ R_T, T* __restrict__ J_T,
    T* __restrict__ xi_T, int* __restrict__ path, int* __restrict__ fail,
    int* __restrict__ iters) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  implicit_element<T, Model>(e, E, x, x_prev, edofs_T, xi_prev, gN_T, detJ, h, params, es_ids,
                             q, meas0, stab_half, thick, abs_tol, fail_tol, R_T, J_T, xi_T,
                             path, fail, iters);
}

// one launch of Model's kernel on `stream`; returns the launch's
// cudaError_t.  quad = [N1 (npts, npe) | w1 (npts) | mass (npe, npe)],
// row-major doubles.
template <typename T, template <typename> class Model>
int implicit_launch(int E, const void* x, const void* x_prev, const void* edofs_T,
                    const void* xi_prev, const void* gN_T, const void* detJ, const void* h,
                    const void* params, const void* es_ids, const double* quad, int npts,
                    double stab_half, double thick, double abs_tol, double fail_tol, void* R_T,
                    void* J_T, void* xi_T, void* path, void* fail, void* iters,
                    cudaStream_t stream) {
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
  const int block = 128;
  const int grid = (E + block - 1) / block;
  if (E > 0)
    implicit_assembly_kernel<T, Model><<<grid, block, 0, stream>>>(
        E, (const T*)x, (const T*)x_prev, (const int*)edofs_T, (const T*)xi_prev,
        (const T*)gN_T, (const T*)detJ, (const T*)h, (const T*)params, (const int*)es_ids, q,
        meas0, T(stab_half), T(thick), T(abs_tol), T(fail_tol), (T*)R_T, (T*)J_T, (T*)xi_T,
        (int*)path, (int*)fail, (int*)iters);
  return (int)cudaGetLastError();
}

// the body of the library's C entry point: `model` selects Models[model],
// `dtype` float (0) or double (1); returns the launch's cudaError_t
template <template <typename> class... Models>
int implicit_entry(int device, int dtype, int model, int E, const void* x, const void* x_prev,
                   const void* edofs_T, const void* xi_prev, const void* gN_T, const void* detJ,
                   const void* h, const void* params, const void* es_ids, const double* quad,
                   int npts, double stab_half, double thick, double abs_tol, double fail_tol,
                   void* R_T, void* J_T, void* xi_T, void* path, void* fail, void* iters,
                   void* stream) {
  if (npts < 1 || npts > 4 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue, id = 0;
  // one test per model, in order; only Models[model] launches
  ((model == id++
        ? (rc = dtype == 0
                    ? implicit_launch<float, Models>(E, x, x_prev, edofs_T, xi_prev, gN_T, detJ,
                                                     h, params, es_ids, quad, npts, stab_half,
                                                     thick, abs_tol, fail_tol, R_T, J_T, xi_T,
                                                     path, fail, iters, s)
                    : implicit_launch<double, Models>(E, x, x_prev, edofs_T, xi_prev, gN_T,
                                                      detJ, h, params, es_ids, quad, npts,
                                                      stab_half, thick, abs_tol, fail_tol, R_T,
                                                      J_T, xi_T, path, fail, iters, s))
        : 0),
   ...);
  return rc;
}

}  // namespace c8

#endif  // __CUDACC__
