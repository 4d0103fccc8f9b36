// The finite-deformation J2 family, implicit-mode twins of the fused
// assembly: hyper_J2 (3D, mixed u/p), hyper_J2_plane_strain (2D, mixed
// u/p) and hyper_J2_plane_stress (2D, displacement only, with the
// out-of-plane stretch lambda_z as local state).
//
// Each follows calibr8_tpu's trailing twin (models/batched.py:304-421,
// 1159-1289, 1396-1573) and the port's plain version
// (calibr8_tpu_torch/models/batched.py) step for step, as c8_hill.cuh
// does for the Hill family: local state [zeta voigt, Ie, (lambda_z,)
// alpha], zeta = dev(be_bar), Ie = tr(be_bar) / 3; the trial be_bar is
// xi_prev's pushed forward by rF_bar = rF exp(-log(det rF) / 3), rF =
// F F_prev^-1; radial return with n = s / |s|, s = mu zeta.
//
// Beyond the Hill interface (c8_hill.cuh) a model here provides FINITE =
// true, the kernel's cue for PK1 rows sigma cof(F) and the pulled-back
// stabilization (c8_implicit.cuh); first_guess(), the elastic trial
// state the local Newton starts from (batched.py:582); and residual()
// reads gu_prev, the frozen previous grad_u.  The plane-stress model
// names the z-stretch slot of xi (Z_STRETCH) that scales its rows.
#pragma once

#include "c8_hill.cuh"

namespace c8 {

constexpr double C8_SQRT_23 = 0.81649658092772603273;  // sqrt(2/3)
constexpr double C8_SQRT_32 = 1.22474487139158904910;  // sqrt(3/2)

// -- small tensor algebra over plain or dual scalars --------------------

// out = a b, the k sums in index order (t_mm)
template <int D, typename A, typename B, typename O>
C8_HD void mat_mul(const A a[D][D], const B b[D][D], O out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      O acc = a[i][0] * b[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + a[i][k] * b[k][j];
      out[i][j] = acc;
    }
}

// out = a b^T
template <int D, typename A, typename B, typename O>
C8_HD void mat_mul_bt(const A a[D][D], const B b[D][D], O out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      O acc = a[i][0] * b[j][0];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + a[i][k] * b[j][k];
      out[i][j] = acc;
    }
}

// out = a^T b
template <int D, typename A, typename B, typename O>
C8_HD void mat_mul_at(const A a[D][D], const B b[D][D], O out[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      O acc = a[0][i] * b[0][j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = acc + a[k][i] * b[k][j];
      out[i][j] = acc;
    }
}

template <typename S>
C8_HD S det2(const S a[2][2]) { return a[0][0] * a[1][1] - a[0][1] * a[1][0]; }

template <typename S>
C8_HD S det3(const S a[3][3]) {
  return (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1]) -
          a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])) +
         a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

template <int D, typename S>
C8_HD S det(const S a[D][D]) {
  if constexpr (D == 2) return det2(a);
  else return det3(a);
}

template <typename S>
C8_HD S minor2(const S a[3][3], int i1, int j1, int i2, int j2) {
  return a[i1][j1] * a[i2][j2] - a[i1][j2] * a[i2][j1];
}

// the cofactor matrix (t_cof): inv(a) = cof(a)^T / det(a)
template <int D, typename S>
C8_HD void cofactor(const S a[D][D], S c[D][D]) {
  if constexpr (D == 2) {
    c[0][0] = a[1][1];
    c[0][1] = -a[1][0];
    c[1][0] = -a[0][1];
    c[1][1] = a[0][0];
  } else {
    c[0][0] = minor2(a, 1, 1, 2, 2);
    c[0][1] = -minor2(a, 1, 0, 2, 2);
    c[0][2] = minor2(a, 1, 0, 2, 1);
    c[1][0] = -minor2(a, 0, 1, 2, 2);
    c[1][1] = minor2(a, 0, 0, 2, 2);
    c[1][2] = -minor2(a, 0, 0, 2, 1);
    c[2][0] = minor2(a, 0, 1, 1, 2);
    c[2][1] = -minor2(a, 0, 0, 1, 2);
    c[2][2] = minor2(a, 0, 0, 1, 1);
  }
}

// F = I + gu
template <int D, typename S>
C8_HD void def_grad(const S gu[D][D], S F[D][D]) {
  typedef decltype(val(gu[0][0])) T;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) F[i][j] = i == j ? gu[i][j] + T(1) : gu[i][j];
}

// rF = F inv(Fp), inv(Fp) = cof(Fp)^T / det(Fp)  (t_mm(F, t_inv(Fp)))
template <int D, typename T, typename S>
C8_HD void rel_def_grad(const S F[D][D], const T Fp[D][D], S rF[D][D]) {
  T c[D][D], inv[D][D];
  cofactor<D>(Fp, c);
  const T dp = det<D>(Fp);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) inv[i][j] = c[j][i] / dp;
  mat_mul<D>(F, inv, rF);
}

// the 3D embedding of a 2x2 a with zz in the corner (t_embed3)
template <typename S, typename Z>
C8_HD void embed3(const S a[2][2], const Z& zz, S out[3][3]) {
  const S z(0.0);
  out[0][0] = a[0][0]; out[0][1] = a[0][1]; out[0][2] = z;
  out[1][0] = a[1][0]; out[1][1] = a[1][1]; out[1][2] = z;
  out[2][0] = z;       out[2][1] = z;       out[2][2] = S(zz);
}

// a - (tr(a) / 3) I (t_dev3)
template <int D, typename S>
C8_HD void dev3(const S a[D][D], S out[D][D]) {
  S tr = a[0][0];
#pragma unroll
  for (int i = 1; i < D; ++i) tr = tr + a[i][i];
  const S third = tr / 3.0;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = i == j ? a[i][j] - third : a[i][j];
}

// be = rFb (b0) rFb^T
template <int D, typename T, typename S>
C8_HD void push_forward(const S rFb[D][D], const T b0[D][D], S be[D][D]) {
  S tmp[D][D];
  mat_mul<D>(rFb, b0, tmp);
  mat_mul_bt<D>(tmp, rFb, be);
}

// Y + S (1 - exp(-D alpha)) + A (alpha + 1e-12)^n + K alpha, params
// [E, nu, Y, S, D, A, n, K]
template <typename T, typename S>
C8_HD S sigma_yield_power(const S& alpha, const T* par) {
  return ((par[2] + par[3] * (T(1) - c8_exp((-par[4]) * alpha))) +
          par[5] * c8_pow(alpha + T(1e-12), par[6])) +
         par[7] * alpha;
}

template <typename T>
C8_HD T bulk_modulus(const T* par) { return par[0] / (T(3) * (T(1) - T(2) * par[1])); }

// the constants of an element that a model's residual reads (M::ElemConst,
// c8_implicit.cuh): none
struct NoConst {};

// the blended zeta, Ie and alpha rows of the two plane variants, from
// the trial (zeta_tr, Ie_tr); alpha at xi[M::ALPHA], M::sigma_yield its
// hardening, which also takes the element's constants kc; C gets [zeta
// voigt (3), Ie] at 0..3 and alpha's row at ALPHA.  Returns the path.
template <typename M, typename T, typename S, typename K = NoConst>
C8_HD int hyper2d_rows(const S* xi, const T* xip, const S zeta_tr[2][2], const S& Ie_tr,
                       const T* par, T abs_tol, S* C, const K& kc = K()) {
  constexpr int AI = M::ALPHA;
  const T mu = shear_modulus(par);
  S zeta[2][2], zeta3[3][3], s3[3][3];
  voigt_to_sym<2>(xi, zeta);
  const S Ie = xi[3], alpha = xi[AI];
  embed3(zeta, -(zeta[0][0] + zeta[1][1]), zeta3);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s3[i][j] = mu * zeta3[i][j];
  const S s_mag = norm_eps<3>(s3);
  const S f = (s_mag - T(C8_SQRT_23) * M::sigma_yield(alpha, par, kc)) / mu;
  const int path = val(f) >= -abs_tol ? 1 : 0;
  const T w = T(path), wc = T(1) - w;
  const S sc = mu / s_mag;
  const S dgam = T(C8_SQRT_32) * (alpha - xip[AI]);
  const S g = (T(2) * dgam) * Ie;
  S rz[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const S re = zeta[i][j] - zeta_tr[i][j];
      rz[i][j] = w * (re + g * (sc * zeta[i][j])) + wc * re;
    }
  sym_to_voigt<2>(rz, C);
  S be3[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) be3[i][j] = i == j ? zeta3[i][j] + Ie : zeta3[i][j];
  C[3] = w * (det3(be3) - T(1)) + wc * (Ie - Ie_tr);
  C[AI] = w * f + wc * (alpha - xip[AI]);
  return path;
}

// (zeta_tr, Ie_tr) of a trial be_bar (3x3)
template <typename S>
C8_HD void trial_state(const S be3[3][3], S zeta_tr[2][2], S& Ie_tr) {
  Ie_tr = ((be3[0][0] + be3[1][1]) + be3[2][2]) / 3.0;
  zeta_tr[0][0] = be3[0][0] - Ie_tr;
  zeta_tr[0][1] = be3[0][1];
  zeta_tr[1][0] = be3[1][0];
  zeta_tr[1][1] = be3[1][1] - Ie_tr;
}

// hyper_J2 (models/batched.py:304-421), 3D mixed u/p: xi = [zeta voigt
// (6), Ie, alpha]; params [E, nu, Y, S, D, A, n, K]
template <typename T>
struct HyperJ2 {
  static constexpr int D = 3, NXI = 8, NPAR = 8, NEWTON_ITERS = 16;
  static constexpr bool MIXED = true, FINITE = true;

  // be_bar trial = rFb (zeta_old + Ie_old I) rFb^T
  template <typename S>
  C8_HD static void be_bar_trial(const T* xip, const S gu[3][3], const T gup[3][3], S be[3][3]) {
    S F[3][3], rF[3][3];
    T Fp[3][3], b0[3][3];
    def_grad<3>(gu, F);
    def_grad<3>(gup, Fp);
    rel_def_grad<3>(F, Fp, rF);
    const S sc = c8_exp((-c8_log(det3(rF))) / T(3));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) rF[i][j] = rF[i][j] * sc;
    voigt_to_sym<3>(xip, b0);
#pragma unroll
    for (int i = 0; i < 3; ++i) b0[i][i] = b0[i][i] + xip[6];
    push_forward<3>(rF, b0, be);
  }

  C8_HD static void first_guess(const T* xip, const T gu[3][3], const T gup[3][3],
                                const T* par, T* xi) {
    T be[3][3], z[3][3];
    be_bar_trial(xip, gu, gup, be);
    dev3<3>(be, z);
    sym_to_voigt<3>(z, xi);
    xi[6] = ((be[0][0] + be[1][1]) + be[2][2]) / T(3);
    xi[7] = xip[7];
  }

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[3][3], const T* par, S out[3][3]) {
    S F[3][3], zeta[3][3];
    def_grad<3>(gu, F);
    voigt_to_sym<3>(xi, zeta);
    const S c = shear_modulus(par) / det3(F);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) out[i][j] = c * zeta[i][j];
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[3][3], const T* par) {
    S F[3][3];
    def_grad<3>(gu, F);
    const S J = det3(F);
    return (T(0.5) * bulk_modulus(par)) * (J - T(1) / J);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }

  template <typename S>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[3][3], const T gup[3][3],
                            const T* par, T abs_tol, S* C) {
    const T mu = shear_modulus(par);
    S zeta[3][3], s[3][3], be[3][3], dev_tr[3][3];
    voigt_to_sym<3>(xi, zeta);
    const S Ie = xi[6], alpha = xi[7];
    be_bar_trial(xip, gu, gup, be);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) s[i][j] = mu * zeta[i][j];
    const S s_mag = norm_eps<3>(s);
    const S f = (s_mag - T(C8_SQRT_23) * sigma_yield_power(alpha, par)) / mu;
    const int path = val(f) >= -abs_tol ? 1 : 0;
    const T w = T(path), wc = T(1) - w;
    const S dgam = T(C8_SQRT_32) * (alpha - xip[7]);
    const S g = (T(2) * dgam) * Ie;
    dev3<3>(be, dev_tr);
    S rz[3][3], zI[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const S re = zeta[i][j] - dev_tr[i][j];
        rz[i][j] = w * (re + g * (s[i][j] / s_mag)) + wc * re;
        zI[i][j] = i == j ? zeta[i][j] + Ie : zeta[i][j];
      }
    sym_to_voigt<3>(rz, C);
    C[6] = w * (det3(zI) - T(1)) + wc * (Ie - ((be[0][0] + be[1][1]) + be[2][2]) / T(3));
    C[7] = w * f + wc * (alpha - xip[7]);
    return path;
  }
};

// hyper_J2_plane_strain (models/batched.py:1159-1289), 2D mixed u/p:
// xi = [zeta voigt (3), Ie, alpha]; params [E, nu, K, Y, Y_inf, delta]
template <typename T>
struct HyperJ2PlaneStrain {
  static constexpr int D = 2, NXI = 5, NPAR = 6, NEWTON_ITERS = 16, ALPHA = 4;
  static constexpr bool MIXED = true, FINITE = true;

  // Y + K alpha + (Y_inf - Y)(1 - exp(-delta alpha))
  template <typename S>
  C8_HD static S sigma_yield(const S& alpha, const T* par, NoConst = NoConst()) {
    return (par[3] + par[2] * alpha) + (par[4] - par[3]) * (T(1) - c8_exp((-par[5]) * alpha));
  }

  // eval_be_bar_plane_strain: be2 = rFb (zeta_old + Ie_old I) rFb^T,
  // be_zz = (-tr(zeta_old) + Ie_old) / c^2, c = det(rF)^(1/3)
  template <typename S>
  C8_HD static void be_bar_3d(const T* xip, const S gu[2][2], const T gup[2][2], S be3[3][3]) {
    S F[2][2], rF[2][2], be2[2][2];
    T Fp[2][2], b0[2][2];
    def_grad<2>(gu, F);
    def_grad<2>(gup, Fp);
    rel_def_grad<2>(F, Fp, rF);
    const S c = c8_exp(c8_log(det2(rF)) / T(3));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) rF[i][j] = rF[i][j] / c;
    voigt_to_sym<2>(xip, b0);
    b0[0][0] = b0[0][0] + xip[3];
    b0[1][1] = b0[1][1] + xip[3];
    push_forward<2>(rF, b0, be2);
    embed3(be2, ((-(xip[0] + xip[1])) + xip[3]) / (c * c), be3);
  }

  C8_HD static void first_guess(const T* xip, const T gu[2][2], const T gup[2][2],
                                const T* par, T* xi) {
    T be3[3][3], zt[2][2], Ie;
    be_bar_3d(xip, gu, gup, be3);
    trial_state(be3, zt, Ie);
    sym_to_voigt<2>(zt, xi);
    xi[3] = Ie;
    xi[4] = xip[4];
  }

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[2][2], const T* par, S out[2][2]) {
    S F[2][2], zeta[2][2];
    def_grad<2>(gu, F);
    voigt_to_sym<2>(xi, zeta);
    const S c = shear_modulus(par) / det2(F);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) out[i][j] = c * zeta[i][j];
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[2][2], const T* par) {
    S F[2][2];
    def_grad<2>(gu, F);
    const S J = det2(F);
    return (T(0.5) * bulk_modulus(par)) * (J - T(1) / J);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }

  template <typename S>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[2][2], const T gup[2][2],
                            const T* par, T abs_tol, S* C) {
    S be3[3][3], zt[2][2], Ie_tr;
    be_bar_3d(xip, gu, gup, be3);
    trial_state(be3, zt, Ie_tr);
    return hyper2d_rows<HyperJ2PlaneStrain>(xi, xip, zt, Ie_tr, par, abs_tol, C);
  }
};

// hyper_J2_plane_stress (models/batched.py:1396-1573), 2D displacement
// only: xi = [zeta voigt (3), Ie, lambda_z, alpha]; params [E, nu, Y, S,
// D, A, n, K]; the rows are z_stretch sigma cof(F)
template <typename T>
struct HyperJ2PlaneStress {
  static constexpr int D = 2, NXI = 6, NPAR = 8, NEWTON_ITERS = 20, Z_STRETCH = 4, ALPHA = 5;
  static constexpr bool MIXED = false, FINITE = true;

  template <typename S>
  C8_HD static S sigma_yield(const S& alpha, const T* par, NoConst = NoConst()) {
    return sigma_yield_power(alpha, par);
  }

  // eval_be_bar_plane_stress with lambda_z in F3 and lambda_z_old in Fp3
  template <typename S, typename L>
  C8_HD static void be_bar_3d(const T* xip, const S gu[2][2], const T gup[2][2], const L& lam_z,
                              S be3[3][3]) {
    S F2[2][2], F3[3][3], rF[3][3];
    T Fp2[2][2], Fp3[3][3], z2[2][2], b0[3][3];
    def_grad<2>(gu, F2);
    embed3(F2, lam_z, F3);
    def_grad<2>(gup, Fp2);
    embed3(Fp2, xip[4], Fp3);
    rel_def_grad<3>(F3, Fp3, rF);
    const S sc = c8_exp((-c8_log(det3(rF))) / T(3));
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) rF[i][j] = rF[i][j] * sc;
    voigt_to_sym<2>(xip, z2);
    embed3(z2, -(xip[0] + xip[1]), b0);
#pragma unroll
    for (int i = 0; i < 3; ++i) b0[i][i] = b0[i][i] + xip[3];
    push_forward<3>(rF, b0, be3);
  }

  C8_HD static void first_guess(const T* xip, const T gu[2][2], const T gup[2][2],
                                const T* par, T* xi) {
    T be3[3][3], zt[2][2], Ie;
    be_bar_3d(xip, gu, gup, xip[4], be3);
    trial_state(be3, zt, Ie);
    sym_to_voigt<2>(zt, xi);
    xi[3] = Ie;
    xi[4] = xip[4];
    xi[5] = xip[5];
  }

  // the full in-plane Cauchy stress, J = det(F) lambda_z
  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[2][2], const T* par, S out[2][2]) {
    S F[2][2], zeta[2][2];
    def_grad<2>(gu, F);
    voigt_to_sym<2>(xi, zeta);
    const S J = det2(F) * xi[4];
    const S c = shear_modulus(par) / J;
    const S diag = (T(0.5) * bulk_modulus(par)) * (J - T(1) / J);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        out[i][j] = c * zeta[i][j];
        if (i == j) out[i][j] = out[i][j] + diag;
      }
  }

  // Self names the struct whose sigma_yield the rows take, and kc its
  // element's constants (the hybrid of c8_hybrid.cuh passes itself and its
  // NN(0))
  template <typename S, typename Self = HyperJ2PlaneStress, typename K = NoConst>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[2][2], const T gup[2][2],
                            const T* par, T abs_tol, S* C, const K& kc = K()) {
    const T mu = shear_modulus(par);
    const T kappa = bulk_modulus(par);
    const S lam_z = xi[4];
    S be3[3][3], zt[2][2], Ie_tr;
    be_bar_3d(xip, gu, gup, lam_z, be3);
    trial_state(be3, zt, Ie_tr);
    const int path = hyper2d_rows<Self>(xi, xip, zt, Ie_tr, par, abs_tol, C, kc);
    // the plane-stress constraint on the out-of-plane stretch
    const S zeta_zz = -(xi[0] + xi[1]);
    S F[2][2];
    def_grad<2>(gu, F);
    const S J2 = det2(F);
    const S q = (T(1) - zeta_zz / (kappa / (T(2) * mu))) / (J2 * J2);
    C[4] = lam_z - c8_sqrt(maxc(q, T(1e-30)));
    return path;
  }
};

}  // namespace c8
