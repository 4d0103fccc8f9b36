// The hypo_hill family, implicit-mode twins of the fused assembly:
// hypo_hill (3D, mixed u/p), hypo_hill_plane_strain (2D, mixed u/p, TC_zz
// as local state) and hypo_hill_plane_stress (2D, displacement only, with
// a material rotation Q and the out-of-plane stretch lambda_z as local
// state).
//
// Each follows calibr8_tpu's trailing twin (models/batched.py:677-822,
// 1028-1157, 1290-1393) and the port's plain version
// (calibr8_tpu_torch/models/batched.py) step for step, as c8_hill.cuh
// and c8_hyper.cuh do for theirs: the unrotated Cauchy stress TC is
// updated by the unrotated rate d = R^T sym((F - F_prev) F^-1) R, R the
// polar factor of F by Higham's scaled Newton iteration (6 iterations);
// Hill yield with Voce hardening; the stress rows read R TC R^T.
//
// The rate does not depend on xi, so these models give the kernel the
// precompute hook of c8_implicit.cuh: PRECOMPUTE = true, Pre<S> (the
// rate), precompute(gu, gup, par, pre) and residual_pre(xi, xip, pre,
// par, abs_tol, C) in place of residual().  The local Newton reads the
// rate as plain T, formed once; the condensation forms it from the
// grad_u seeds, so dC/dgu carries the rate's dependence on F.  The
// stress is rotated by the polar factor of the current F, so it too
// depends on grad_u through R.  Everything is templated on the scalar
// (plain T or a Dual), as in c8_hill.cuh; constants are cast to T, so
// that float instances stay float (1e-300 is 0 in float32, as in
// calibr8_tpu's float32 run).
#pragma once

#include "c8_hyper.cuh"

namespace c8 {

// The rotation R of F = R U (t_polar): R <- (s R + cof(R) / det(R) / s) / 2,
// s = exp(-log(|det R| + 1e-300) / D), s = 1 where it is not finite
// (with a zero tangent, as jnp.where's unselected branch).
template <int D, typename S>
C8_HD void polar(const S F[D][D], S R[D][D]) {
  typedef decltype(val(F[0][0])) T;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) R[i][j] = F[i][j];
  for (int it = 0; it < 6; ++it) {
    const S dt = det<D>(R);
    S s = c8_exp((-c8_log(c8_abs(dt) + T(1e-300))) / T(D));
    if (!finite(val(s))) s = S(T(1));
    S c[D][D];
    cofactor<D>(R, c);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) R[i][j] = T(0.5) * (s * R[i][j] + (c[i][j] / dt) / s);
  }
}

// d = R^T sym((F - F_prev) F^-1) R, R = polar(F) (t_unrotated_rate);
// F^-1 = cof(F)^T / det(F), each product summed in index order
template <int D, typename T, typename S>
C8_HD void unrotated_rate(const S gu[D][D], const T gup[D][D], S d[D][D]) {
  S F[D][D], c[D][D], dF[D][D], Fi[D][D], L[D][D], Ds[D][D], R[D][D], RtD[D][D];
  T Fp[D][D];
  def_grad<D>(gu, F);
  def_grad<D>(gup, Fp);
  cofactor<D>(F, c);
  const S dt = det<D>(F);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      dF[i][j] = F[i][j] - Fp[i][j];
      Fi[i][j] = c[j][i] / dt;
    }
  mat_mul<D>(dF, Fi, L);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) Ds[i][j] = T(0.5) * (L[i][j] + L[j][i]);
  polar<D>(F, R);
  mat_mul_at<D>(R, Ds, RtD);
  mat_mul<D>(RtD, R, d);
}

// R TC R^T, R = polar(I + gu)
template <int D, typename S>
C8_HD void rotated_stress(const S* xi, const S gu[D][D], S RC[D][D]) {
  S F[D][D], R[D][D], TC[D][D];
  def_grad<D>(gu, F);
  polar<D>(F, R);
  voigt_to_sym<D>(xi, TC);
  push_forward<D>(R, TC, RC);
}

template <typename T>
C8_HD T lame_lambda(const T* par) {
  return (par[0] * par[1]) / ((T(1) + par[1]) * (T(1) - T(2) * par[1]));
}

// what the three share: 20 local Newton iterations, the precompute hook
template <typename T, int D_, int NXI_, int NPAR_, bool MIXED_>
struct HypoTwin {
  static constexpr int D = D_, NXI = NXI_, NPAR = NPAR_, NEWTON_ITERS = 20;
  static constexpr bool MIXED = MIXED_, FINITE = true, PRECOMPUTE = true;

  // the xi-independent part of the local residual: the unrotated rate
  template <typename S>
  struct Pre {
    S d[D_][D_];
  };
};

// hypo_hill (models/batched.py:707-822), 3D mixed u/p, residual scaled by
// 1/mu (hypo_hill.cpp:266-268): xi = [TC voigt (6), alpha]; params [E, nu,
// Y, R00, R11, R22, R01, R02, R12, S, D]
template <typename T>
struct HypoHill : HypoTwin<T, 3, 7, 11, true> {
  // kernel 1b's lanes per element (c8_implicit.cuh implicit_team_lanes)
  static constexpr int TEAM_LANES = sizeof(T) == 8 ? 4 : 1;
  template <typename S>
  using Pre = typename HypoTwin<T, 3, 7, 11, true>::template Pre<S>;

  template <typename S>
  C8_HD static void precompute(const S gu[3][3], const T gup[3][3], const T* par, Pre<S>& pre) {
    unrotated_rate<3>(gu, gup, pre.d);
  }

  // TC_old + 2 mu d + lam tr(d) I, in voigt order
  template <typename P>
  C8_HD static void elastic_update(const T* xip, const P d[3][3], const T* par, P upd[6]) {
    const T mu = shear_modulus(par), lam = lame_lambda(par);
    const P ltr = lam * ((d[0][0] + d[1][1]) + d[2][2]);
    const P dv[6] = {d[0][0], d[1][1], d[2][2], d[0][1], d[0][2], d[1][2]};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      upd[k] = xip[k] + (T(2) * mu) * dv[k];
      if (k < 3) upd[k] = upd[k] + ltr;
    }
  }

  C8_HD static void first_guess(const T* xip, const T gu[3][3], const T gup[3][3],
                                const T* par, T* xi) {
    Pre<T> pre;
    precompute(gu, gup, par, pre);
    elastic_update(xip, pre.d, par, xi);
    xi[6] = xip[6];
  }

  template <typename S, typename P>
  C8_HD static int residual_pre(const S* xi, const T* xip, const Pre<P>& pre, const T* par,
                                T abs_tol, S* C) {
    const T mu = shear_modulus(par);
    const HillCoef<T> hc(par[3], par[4], par[5], par[6], par[7], par[8]);
    P upd[6];
    elastic_update(xip, pre.d, par, upd);
    const S hval = hill_value(hc, xi[0], xi[1], xi[2], xi[3], xi[4], xi[5]);
    const S f = (hval - voce(par[2], par[9], par[10], xi[6])) / mu;
    S n[6];
    hill_normal(hc, xi[0], xi[1], xi[2], xi[3], xi[4], xi[5], hval, n);
    const int path = val(f) >= -abs_tol ? 1 : 0;
    const T w = T(path), wc = T(1) - w;
    const S dgam = xi[6] - xip[6];
    const S g = (w * T(2)) * dgam;
#pragma unroll
    for (int k = 0; k < 6; ++k) C[k] = (xi[k] - upd[k]) / mu + g * n[k];
    C[6] = w * f + wc * dgam;
    return path;
  }

  // the deviator of R TC R^T (the caller subtracts the pressure)
  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[3][3], const T* par, S out[3][3]) {
    rotated_stress<3>(xi, gu, out);
    const S third = ((out[0][0] + out[1][1]) + out[2][2]) / T(3);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i][i] = out[i][i] - third;
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[3][3], const T* par) {
    S RC[3][3];
    rotated_stress<3>(xi, gu, RC);
    return ((RC[0][0] + RC[1][1]) + RC[2][2]) / T(3);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }
};

// the yield function of the plane variants on the 3D embedding of TC with
// szz in the corner (TC_zz in plane strain, 0 in plane stress); returns f
// and the in-plane normal n2 = [n00, n11, n01]
template <typename T, typename S, typename Z>
C8_HD S hypo2d_hill(const S* xi, const T* par, const Z& szz, S n2[3]) {
  const T mu = shear_modulus(par);
  const HillCoef<T> hc(par[5], par[6], par[7], par[8], T(1), T(1));
  const S z(T(0));
  const S s22(szz);
  const S hval = hill_value(hc, xi[0], xi[1], s22, xi[2], z, z);
  S n[6];
  hill_normal(hc, xi[0], xi[1], s22, xi[2], z, z, hval, n);
  n2[0] = n[0];
  n2[1] = n[1];
  n2[2] = n[3];
  return (hval - voce(par[2], par[3], par[4], xi[3])) / mu;
}

// hypo_hill_plane_strain (models/batched.py:1038-1157), 2D mixed u/p, the
// in-plane rotation: xi = [TC voigt (3), alpha, TC_zz]; params [E, nu, Y,
// S, D, R00, R11, R22, R01]
template <typename T>
struct HypoHillPlaneStrain : HypoTwin<T, 2, 5, 9, true> {
  static constexpr int TEAM_LANES = sizeof(T) == 8 ? 1 : 2;
  template <typename S>
  using Pre = typename HypoTwin<T, 2, 5, 9, true>::template Pre<S>;

  template <typename S>
  C8_HD static void precompute(const S gu[2][2], const T gup[2][2], const T* par, Pre<S>& pre) {
    unrotated_rate<2>(gu, gup, pre.d);
  }

  C8_HD static void first_guess(const T* xip, const T gu[2][2], const T gup[2][2],
                                const T* par, T* xi) {
    const T mu = shear_modulus(par), lam = lame_lambda(par);
    Pre<T> pre;
    precompute(gu, gup, par, pre);
    const T(&d)[2][2] = pre.d;
    const T ltr = lam * (d[0][0] + d[1][1]);
    xi[0] = (xip[0] + (T(2) * mu) * d[0][0]) + ltr;
    xi[1] = (xip[1] + (T(2) * mu) * d[1][1]) + ltr;
    xi[2] = xip[2] + (T(2) * mu) * d[0][1];
    xi[3] = xip[3];
    xi[4] = xip[4] + ltr;
  }

  template <typename S, typename P>
  C8_HD static int residual_pre(const S* xi, const T* xip, const Pre<P>& pre, const T* par,
                                T abs_tol, S* C) {
    const T mu = shear_modulus(par), lam = lame_lambda(par);
    const P(&d)[2][2] = pre.d;
    const P ltr = lam * (d[0][0] + d[1][1]);
    S n2[3];
    const S f = hypo2d_hill(xi, par, xi[4], n2);
    const int path = val(f) >= -abs_tol ? 1 : 0;
    const T w = T(path), wc = T(1) - w;
    const S dgam = xi[3] - xip[3];
    const T g = (w * T(2)) * mu;
    const P dv[3] = {d[0][0], d[1][1], d[0][1]};
    S dp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dp[k] = dgam * n2[k];
      S r = (xi[k] - xip[k]) - (T(2) * mu) * dv[k];
      if (k < 2) r = r - ltr;
      C[k] = r + g * dp[k];
    }
    C[3] = w * f + wc * dgam;
    C[4] = ((xi[4] - xip[4]) - ltr) + g * (-(dp[0] + dp[1]));
    return path;
  }

  // RC - ((tr(RC) + TC_zz) / 3) I (the caller subtracts the pressure)
  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[2][2], const T* par, S out[2][2]) {
    rotated_stress<2>(xi, gu, out);
    const S h = ((out[0][0] + out[1][1]) + xi[4]) / T(3);
    out[0][0] = out[0][0] - h;
    out[1][1] = out[1][1] - h;
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[2][2], const T* par) {
    S RC[2][2];
    rotated_stress<2>(xi, gu, RC);
    return ((RC[0][0] + RC[1][1]) + xi[4]) / T(3);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }
};

// hypo_hill_plane_stress (models/batched.py:1290-1393), 2D displacement
// only: xi = [TC voigt (3), alpha, lambda_z]; params [E, nu, Y, S, D, R00,
// R11, R22, R01, Q00, Q01, Q10, Q11]; the rate is Q^T d Q, the stress
// R Q TC Q^T R^T, and the rows are lambda_z sigma cof(F)
template <typename T>
struct HypoHillPlaneStress : HypoTwin<T, 2, 5, 13, false> {
  static constexpr int Z_STRETCH = 4;
  template <typename S>
  using Pre = typename HypoTwin<T, 2, 5, 13, false>::template Pre<S>;

  template <typename S>
  C8_HD static void precompute(const S gu[2][2], const T gup[2][2], const T* par, Pre<S>& pre) {
    const T Q[2][2] = {{par[9], par[10]}, {par[11], par[12]}};
    S dq[2][2], QtD[2][2];
    unrotated_rate<2>(gu, gup, dq);
    mat_mul_at<2>(Q, dq, QtD);
    mat_mul<2>(QtD, Q, pre.d);
  }

  C8_HD static void first_guess(const T* xip, const T gu[2][2], const T gup[2][2],
                                const T* par, T* xi) {
    const T mu = shear_modulus(par), lam = lame_lambda(par);
    Pre<T> pre;
    precompute(gu, gup, par, pre);
    const T(&d)[2][2] = pre.d;
    const T tr = d[0][0] + d[1][1];
    const T d_zz = ((-lam) * tr) / (lam + T(2) * mu);
    const T ldiag = lam * (tr + d_zz);
    xi[0] = (xip[0] + (T(2) * mu) * d[0][0]) + ldiag;
    xi[1] = (xip[1] + (T(2) * mu) * d[1][1]) + ldiag;
    xi[2] = xip[2] + (T(2) * mu) * d[0][1];
    xi[3] = xip[3];
    xi[4] = xip[4] / (T(1) - d_zz);
  }

  template <typename S, typename P>
  C8_HD static int residual_pre(const S* xi, const T* xip, const Pre<P>& pre, const T* par,
                                T abs_tol, S* C) {
    const T mu = shear_modulus(par), lam = lame_lambda(par);
    const P(&d)[2][2] = pre.d;
    const P tr = d[0][0] + d[1][1];
    const P d_zz = ((-lam) * tr) / (lam + T(2) * mu);
    const P ldiag = lam * (tr + d_zz);
    S n2[3];
    const S f = hypo2d_hill(xi, par, T(0), n2);
    const int path = val(f) >= -abs_tol ? 1 : 0;
    const T w = T(path), wc = T(1) - w;
    const S dgam = xi[3] - xip[3];
    const P dv[3] = {d[0][0], d[1][1], d[0][1]};
    S dp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) dp[k] = dgam * n2[k];
    const S corr = ((T(2) * mu) * (-(dp[0] + dp[1]))) / (T(2) * mu + lam);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      S re = (xi[k] - xip[k]) - (T(2) * mu) * dv[k];
      if (k < 2) re = re - ldiag;
      S rp = re + (T(2) * mu) * dp[k];
      if (k < 2) rp = rp - lam * corr;
      C[k] = w * (rp / mu) + wc * re;
    }
    C[3] = w * f + wc * dgam;
    const S lam_z = xi[4];
    C[4] = w * (lam_z - xip[4] / (T(1) - (d_zz + corr))) + wc * (lam_z - xip[4] / (T(1) - d_zz));
    return path;
  }

  // the full in-plane Cauchy stress R Q TC Q^T R^T
  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[2][2], const T* par, S out[2][2]) {
    const T Q[2][2] = {{par[9], par[10]}, {par[11], par[12]}};
    S F[2][2], R[2][2], RQ[2][2], TC[2][2];
    def_grad<2>(gu, F);
    polar<2>(F, R);
    mat_mul<2>(R, Q, RQ);
    voigt_to_sym<2>(xi, TC);
    push_forward<2>(RQ, TC, out);
  }
};

}  // namespace c8
