// Per-element assembly of the mechanics residual and its statically
// condensed Jacobian, for the models of the analytic kernel mode: mixed
// u/p rows for elastic and small_J2, displacement-only rows for
// isotropic_elastic (M::MIXED).  One call handles one element; the fused
// assembly kernel (fused_assembly.cu) runs it in one thread per element.
//
// The arithmetic follows calibr8_tpu's fused Pallas kernel
// (fem/pallas_assembly.py:242-482, analytic mode) and the trailing
// twins (models/batched.py:161-302) step for step, as does the port's
// plain version (calibr8_tpu_torch/fem/fused_assembly.py), so all three
// agree to rounding.  Constants are cast to T before use, as JAX's weak
// typing does, so the float32 kernel rounds where the float32 reference
// rounds.
//
// Layouts (E = number of elements, e = this element):
//   x        (n_dofs,)        flat dofs, u block then p block
//   edofs_T  (nde, E) int32   element dof ids, node-interleaved [u.., p];
//                             null: x holds the (nde, E) element columns
//                             (the element-level entry, elem_dof)
//   xi_prev  (E, nxi)         previous local state
//   gN_T     (npe, d, E)      shape-function gradients
//   detJ, h  (E,)
//   params   (n_sets, npar) with es_ids (E,) int32
//   R_T (nde, E), J_T (nde, nde, E), xi_T (nxi, E), path/fail (E,) int32
// with nde = npe (d + 1) for mixed u/p, npe d for displacement only.
#pragma once

#include "c8_dual.cuh"

namespace c8 {

// static quadrature data of the order-2 pressure rule (ip set 1,
// fem/pallas_assembly.py:214-232): N1[q][n], w1[q] and the pressure
// "mass" mass[n][m] = sum_q w1[q] N1[q][n] N1[q][m]
template <typename T>
struct Quad {
  T N1[4][4];
  T w1[4];
  T mass[4][4];
  int npts;
};

// The position in x of element e's i-th dof: x[edofs_T[i, e]], or, when
// edofs_T is null, x[i, e]: x then holds the pre-gathered (nde, E)
// element columns (the element-level entry of calibr8_tpu's Pallas
// kernel, fem/pallas_assembly.py:529-543, which parallel/dist.py calls
// per part).  A branch at run time, uniform across the grid: one build
// serves both entries.
C8_HD size_t elem_dof(const int* __restrict__ edofs_T, int i, int E, int e) {
  const size_t k = (size_t)i * E + e;
  return edofs_T ? (size_t)edofs_T[k] : k;
}

// -- small tensor helpers over plain or dual scalars --------------------

template <int D, typename S>
C8_HD void sym_dev3(const S gu[D][D], S out[D][D]) {
  // dev3(sym(gu)): eps = 0.5 (gu + gu^T), minus tr(eps)/3 on the diagonal
  S eps[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) eps[i][j] = (gu[i][j] + gu[j][i]) * 0.5;
  S tr = eps[0][0];
#pragma unroll
  for (int i = 1; i < D; ++i) tr = tr + eps[i][i];
  const S third = tr / 3.0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = (i == j) ? eps[i][j] - third : eps[i][j];
}

template <int D, typename S>
C8_HD S sym_trace(const S gu[D][D]) {
  S tr = (gu[0][0] + gu[0][0]) * 0.5;
#pragma unroll
  for (int i = 1; i < D; ++i) tr = tr + (gu[i][i] + gu[i][i]) * 0.5;
  return tr;
}

template <int D, typename V, typename S>
C8_HD void voigt_to_sym(const V* v, S a[D][D]) {
  if constexpr (D == 2) {
    a[0][0] = S(v[0]); a[0][1] = S(v[2]);
    a[1][0] = S(v[2]); a[1][1] = S(v[1]);
  } else {
    a[0][0] = S(v[0]); a[0][1] = S(v[3]); a[0][2] = S(v[4]);
    a[1][0] = S(v[3]); a[1][1] = S(v[1]); a[1][2] = S(v[5]);
    a[2][0] = S(v[4]); a[2][1] = S(v[5]); a[2][2] = S(v[2]);
  }
}

template <int D, typename S>
C8_HD void sym_to_voigt(const S a[D][D], S* v) {
  if constexpr (D == 2) {
    v[0] = a[0][0]; v[1] = a[1][1]; v[2] = a[0][1];
  } else {
    v[0] = a[0][0]; v[1] = a[1][1]; v[2] = a[2][2];
    v[3] = a[0][1]; v[4] = a[0][2]; v[5] = a[1][2];
  }
}

// sqrt(sum a^2 + 1e-30), summed over rows first, then columns (t_norm)
template <int D, typename S>
C8_HD S norm_eps(const S a[D][D]) {
  typedef decltype(val(a[0][0])) T;
  S tot;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    S col = a[0][j] * a[0][j];
#pragma unroll
    for (int i = 1; i < D; ++i) col = col + a[i][j] * a[i][j];
    tot = (j == 0) ? col : tot + col;
  }
  return c8_sqrt(tot + T(1e-30));
}

// -- models -------------------------------------------------------------
// Each model: NXI local variables, NPAR parameters (deck order), MIXED
// (its rows), local_solve (closed form); a mixed one dev_cauchy, hydro and
// psf, a displacement-only one the full stress, cauchy.

// elastic (models/batched.py:257-302): xi = [dummy] = 0,
// params [E, nu, cte, delta_T]
template <typename T, int D>
struct Elastic {
  static constexpr int NXI = 1;
  static constexpr int NPAR = 4;
  static constexpr bool MIXED = true;

  template <typename S>
  C8_HD static void local_solve(const T* xip, const S gu[D][D], const T* par,
                                T abs_tol, S* xi, int& path) {
    xi[0] = S(T(0));
    path = 0;
  }

  template <typename S>
  C8_HD static void dev_cauchy(const S* xi, const S gu[D][D], const T* par, S out[D][D]) {
    const T mu = par[0] / (T(2) * (T(1) + par[1]));
    S dv[D][D];
    sym_dev3<D>(gu, dv);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) out[i][j] = (T(2) * mu) * dv[i][j];
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[D][D], const T* par) {
    const T Em = par[0], nu = par[1], cte = par[2], dT = par[3];
    const T kappa = Em / (T(3) * (T(1) - T(2) * nu));
    const T thermal = cte * dT * Em / (T(1) - T(2) * nu);
    return sym_trace<D>(gu) * kappa - thermal;
  }

  C8_HD static T psf(const T* par) { return par[0] / (T(3) * (T(1) - T(2) * par[1])); }
};

// small_J2 (models/batched.py:161-254): closed-form radial return,
// xi = [pstrain voigt (nc), alpha], params [E, nu, K, Y, cte, delta_T]
template <typename T, int D>
struct SmallJ2 {
  static constexpr int NC = (D == 2) ? 3 : 6;
  static constexpr int NXI = NC + 1;
  static constexpr int NPAR = 6;
  static constexpr bool MIXED = true;

  template <typename S>
  C8_HD static void local_solve(const T* xip, const S gu[D][D], const T* par,
                                T abs_tol, S* xi, int& path) {
    const T mu = par[0] / (T(2) * (T(1) + par[1]));
    const T K = par[2], Y = par[3];
    T ps_prev[D][D];
    voigt_to_sym<D>(xip, ps_prev);
    const T alpha_prev = xip[NC];
    S dv[D][D], s_tr[D][D];
    sym_dev3<D>(gu, dv);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) s_tr[i][j] = (dv[i][j] - ps_prev[i][j]) * (T(2) * mu);
    const S s_mag = norm_eps<D>(s_tr);
    const S f_tr = (s_mag - T(0.816496580927726) * (Y + K * alpha_prev)) / mu;
    const bool plastic = val(f_tr) >= -abs_tol;
    const S dgam = max0(f_tr) * mu / (T(2) * mu + T(2.0 / 3.0) * K);
    const S gam = plastic ? dgam : S(T(0));
    S ps[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) ps[i][j] = ps_prev[i][j] + gam * (s_tr[i][j] / s_mag);
    sym_to_voigt<D>(ps, xi);
    xi[NC] = alpha_prev + (plastic ? dgam * T(0.816496580927726) : S(T(0)));
    path = plastic ? 1 : 0;
  }

  template <typename S>
  C8_HD static void dev_cauchy(const S* xi, const S gu[D][D], const T* par, S out[D][D]) {
    const T mu = par[0] / (T(2) * (T(1) + par[1]));
    S ps[D][D], dv[D][D];
    voigt_to_sym<D>(xi, ps);
    sym_dev3<D>(gu, dv);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) out[i][j] = (dv[i][j] - ps[i][j]) * (T(2) * mu);
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[D][D], const T* par) {
    const T Em = par[0], nu = par[1], cte = par[4], dT = par[5];
    const T kappa = Em / (T(3) * (T(1) - T(2) * nu));
    const T thermal = cte * dT * Em / (T(1) - T(2) * nu);
    return sym_trace<D>(gu) * kappa - thermal;
  }

  C8_HD static T psf(const T* par) { return par[0] / (T(3) * (T(1) - T(2) * par[1])); }
};

// isotropic_elastic (models/batched.py:2014-2072), displacement only:
// xi = [dummy] = 0, params [E, nu]; sigma = lambda tr(eps) I + 2 mu eps
template <typename T, int D>
struct IsotropicElastic {
  static constexpr int NXI = 1;
  static constexpr int NPAR = 2;
  static constexpr bool MIXED = false;

  template <typename S>
  C8_HD static void local_solve(const T* xip, const S gu[D][D], const T* par,
                                T abs_tol, S* xi, int& path) {
    xi[0] = S(T(0));
    path = 0;
  }

  template <typename S>
  C8_HD static void cauchy(const S* xi, const S gu[D][D], const T* par, S out[D][D]) {
    const T Em = par[0], nu = par[1];
    const T lam = Em * nu / ((T(1) + nu) * (T(1) - T(2) * nu));
    const T mu = Em / (T(2) * (T(1) + nu));
    S eps[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) eps[i][j] = (gu[i][j] + gu[j][i]) * 0.5;
    S tr = eps[0][0];
#pragma unroll
    for (int i = 1; i < D; ++i) tr = tr + eps[i][i];
    const S ltr = lam * tr;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        out[i][j] = (T(2) * mu) * eps[i][j];
        if (i == j) out[i][j] = out[i][j] + ltr;
      }
  }
};

// -- the element --------------------------------------------------------

template <typename T, int D, template <typename, int> class Model>
C8_HD void assemble_element(
    int e, int E, const T* __restrict__ x, const int* __restrict__ edofs_T,
    const T* __restrict__ xi_prev, const T* __restrict__ gN_T,
    const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids,
    const Quad<T>& q, T meas0, T stab_half, T abs_tol, T thick,
    T* __restrict__ R_T, T* __restrict__ J_T, T* __restrict__ xi_T,
    int* __restrict__ path_out, int* __restrict__ fail_out) {
  typedef Model<T, D> M;
  constexpr bool MIXED = M::MIXED;
  constexpr int NPE = D + 1, NDPN = MIXED ? D + 1 : D, NDE = NPE * NDPN, NG = D * D;
  typedef Dual<T, NG> S;
  constexpr int NXI = M::NXI, NPAR = M::NPAR;

  // ---- gather (no pressure when displacement only) ----
  T u[NPE][D], p[NPE], gN[NPE][D];
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int c = 0; c < D; ++c) u[n][c] = x[elem_dof(edofs_T, n * NDPN + c, E, e)];
    if constexpr (MIXED) p[n] = x[elem_dof(edofs_T, n * NDPN + D, E, e)];
#pragma unroll
    for (int j = 0; j < D; ++j) gN[n][j] = gN_T[(n * D + j) * E + e];
  }
  const T dJ = detJ[e], hh = h[e];
  T par[NPAR], xip[NXI];
  const T* pe = params + es_ids[e] * NPAR;
#pragma unroll
  for (int k = 0; k < NPAR; ++k) par[k] = pe[k];
#pragma unroll
  for (int k = 0; k < NXI; ++k) xip[k] = xi_prev[e * NXI + k];

  // ---- kinematics: grad_u[i][j] = sum_n u[n][i] gN[n][j], seeded ----
  S gu[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = u[0][i] * gN[0][j];
#pragma unroll
      for (int n = 1; n < NPE; ++n) acc = acc + u[n][i] * gN[n][j];
      gu[i][j] = S(acc);
      gu[i][j].d[i * D + j] = T(1);
    }

  // ---- state-independent pressure data (frozen under the seeds) ----
  const T wdv0 = dJ * meas0;
  const T inv_npe = T(1.0 / NPE);
  T psf = T(1), tau = T(0), p_ip = T(0), grad_p[D], coef[4];
  if constexpr (MIXED) {
    const T mu = par[0] / (T(2) * (T(1) + par[1]));
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

  // ---- local solve and stress, differentiated along the d*d seeds ----
  S xi[NXI];
  int path = 0;
  M::local_solve(xip, gu, par, abs_tol, xi, path);
  S sigma[D][D];
  S rp_const(T(0));
  if constexpr (MIXED) {
    M::dev_cauchy(xi, gu, par, sigma);
#pragma unroll
    for (int i = 0; i < D; ++i) sigma[i][i] = sigma[i][i] - p_ip;
    rp_const = (-(M::hydro(xi, gu, par) / psf) * inv_npe) * wdv0;
  } else {
    M::cauchy(xi, gu, par, sigma);
  }

  // ---- rows of each node: R, and J = (gu tangents) . grad_N, plus the
  //      analytic pressure columns when mixed (fem/pallas_assembly.py:
  //      423-476); displacement only, the momentum rows times `thick`
  //      (the thickness under plane stress, 1 otherwise) ----
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int ci = 0; ci < NDPN; ++ci) {
      S row;
      if (ci < D) {
        S acc = sigma[ci][0] * gN[n][0];
#pragma unroll
        for (int j = 1; j < D; ++j) acc = acc + sigma[ci][j] * gN[n][j];
        if constexpr (MIXED) row = acc * wdv0;
        else row = (acc * wdv0) * thick;
      } else {
        T stab_n = (tau * grad_p[0]) * gN[n][0];
#pragma unroll
        for (int j = 1; j < D; ++j) stab_n = stab_n + (tau * grad_p[j]) * gN[n][j];
        T r_p1 = T(0);
        for (int qq = 0; qq < q.npts; ++qq) r_p1 = r_p1 + coef[qq] * q.N1[qq][n];
        row = (rp_const - stab_n * wdv0) - r_p1;
      }
      const int i = n * NDPN + ci;
      R_T[i * E + e] = row.v;
      T* Jrow = J_T + (size_t)i * NDE * E + e;
#pragma unroll
      for (int m = 0; m < NPE; ++m) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          T acc = row.d[c * D + 0] * gN[m][0];
#pragma unroll
          for (int j = 1; j < D; ++j) acc = acc + row.d[c * D + j] * gN[m][j];
          Jrow[(size_t)(m * NDPN + c) * E] = acc;
        }
        if constexpr (MIXED) {
          T pcol;
          if (ci < D) {
            pcol = (-inv_npe * gN[n][ci]) * wdv0;
          } else {
            T gg = gN[m][0] * gN[n][0];
#pragma unroll
            for (int j = 1; j < D; ++j) gg = gg + gN[m][j] * gN[n][j];
            pcol = (-tau * wdv0) * gg - (dJ / psf) * q.mass[n][m];
          }
          Jrow[(size_t)(m * NDPN + D) * E] = pcol;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NXI; ++k) xi_T[k * E + e] = xi[k].v;
  path_out[e] = path;
  fail_out[e] = 0;
}

}  // namespace c8
