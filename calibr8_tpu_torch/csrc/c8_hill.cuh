// The small-strain Hill family, the implicit-mode twins of the fused
// assembly: small_hill (3D, mixed u/p), small_hill_plane_strain (2D,
// mixed u/p) and small_hill_plane_stress (2D, displacement only).
//
// Each follows calibr8_tpu's trailing twin (models/batched.py:423-469,
// 471-558, 825-1025) and the port's plain version
// (calibr8_tpu_torch/models/batched.py) step for step: the same
// operations in the same order, constants cast to T as JAX's weak typing
// casts them, zeros of the 3D embedding carried through the arithmetic,
// and the branches blended as w a + (1 - w) b, not selected.  Everything
// is templated on the scalar S (plain T, or a Dual carrying tangents), so
// one body serves the local Newton (seeds over xi) and the condensation
// (seeds over [xi; grad_u]).
//
// A model provides: D, NXI, NPAR, MIXED; residual() -> path, the
// branchwise local residual C at the branch the current xi selects
// (pathfn: f >= -abs_tol); stress(), the deviatoric Cauchy stress
// (mixed: the pressure is subtracted by the caller) or the full in-plane
// Cauchy stress (plane stress); and for mixed models hydro() and psf().
#pragma once

#include "c8_element.cuh"

namespace c8 {

// Hill coefficients (F, G, H, L, M, N) from the six ratios;
// r**-2 is 1 / (r * r), as JAX lowers integer_pow(r, -2)
template <typename T>
struct HillCoef {
  T F, G, H, L, M, N;
  C8_HD HillCoef(T R00, T R11, T R22, T R01, T R02, T R12) {
    const T i00 = T(1) / (R00 * R00), i11 = T(1) / (R11 * R11), i22 = T(1) / (R22 * R22);
    F = T(0.5) * ((i11 + i22) - i00);
    G = T(0.5) * ((i22 + i00) - i11);
    H = T(0.5) * ((i00 + i11) - i22);
    L = T(1.5) * (T(1) / (R12 * R12));
    M = T(1.5) * (T(1) / (R02 * R02));
    N = T(1.5) * (T(1) / (R01 * R01));
  }
};

template <typename S>
C8_HD S sq(const S& a) { return a * a; }

// the Hill function and its normal on a symmetric 3x3 s, given by its six
// components (t_hill_value, t_hill_normal); n = [n00, n11, n22, n01, n02, n12]
template <typename T, typename S>
C8_HD S hill_value(const HillCoef<T>& h, const S& s00, const S& s11, const S& s22,
                   const S& s01, const S& s02, const S& s12) {
  const S v2 = ((h.F * sq(s11 - s22) + h.G * sq(s22 - s00)) + h.H * sq(s00 - s11)) +
               T(2) * ((h.L * sq(s12) + h.M * sq(s02)) + h.N * sq(s01));
  return c8_sqrt(v2 + T(1e-30));
}

template <typename T, typename S>
C8_HD void hill_normal(const HillCoef<T>& h, const S& s00, const S& s11, const S& s22,
                       const S& s01, const S& s02, const S& s12, const S& hval, S n[6]) {
  const S den = maxc(hval, T(1e-30));
  n[0] = (((h.G + h.H) * s00 - h.H * s11) - h.G * s22) / den;
  n[1] = (((h.F + h.H) * s11 - h.H * s00) - h.F * s22) / den;
  n[2] = (((h.G + h.F) * s22 - h.G * s00) - h.F * s11) / den;
  n[3] = (h.N * s01) / den;
  n[4] = (h.M * s02) / den;
  n[5] = (h.L * s12) / den;
}

// Voce hardening Y + S (1 - exp(-D alpha))
template <typename T, typename S>
C8_HD S voce(T Y, T Sat, T Dexp, const S& alpha) {
  return Y + Sat * (T(1) - c8_exp((-Dexp) * alpha));
}

template <typename T>
C8_HD T shear_modulus(const T* par) { return par[0] / (T(2) * (T(1) + par[1])); }

// (2 mu) (dev3(sym(gu)) - pstrain), pstrain from the voigt xi[0..NC)
template <int D, typename T, typename S>
C8_HD void small_dev_stress(const S* xi, const S gu[D][D], T mu, S out[D][D]) {
  S ps[D][D], dv[D][D];
  voigt_to_sym<D>(xi, ps);
  sym_dev3<D>(gu, dv);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = (T(2) * mu) * (dv[i][j] - ps[i][j]);
}

// the mixed models' hydrostatic stress kappa tr(sym(gu)) and pressure
// scale factor E / (3 (1 - 2 nu))
template <int D, typename T, typename S>
C8_HD S small_hydro(const S gu[D][D], const T* par) {
  const T kappa = par[0] / (T(3) * (T(1) - T(2) * par[1]));
  return kappa * sym_trace<D>(gu);
}

template <typename T>
C8_HD T small_psf(const T* par) { return par[0] / (T(3) * (T(1) - T(2) * par[1])); }

// small_hill (models/batched.py:471-558): xi = [pstrain voigt (6), alpha];
// params [E, nu, Y, R00, R11, R22, R01, R02, R12, S, D]
template <typename T>
struct SmallHill {
  static constexpr int D = 3, NXI = 7, NPAR = 11;
  static constexpr bool MIXED = true;

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[3][3], const T* par, S out[3][3]) {
    small_dev_stress<3>(xi, gu, shear_modulus(par), out);
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[3][3], const T* par) {
    return small_hydro<3>(gu, par);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }

  template <typename S>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[3][3], const T* par,
                            T abs_tol, S* C) {
    const T mu = shear_modulus(par);
    const HillCoef<T> hc(par[3], par[4], par[5], par[6], par[7], par[8]);
    S s[3][3];
    stress(xi, gu, par, s);
    const S hval = hill_value(hc, s[0][0], s[1][1], s[2][2], s[0][1], s[0][2], s[1][2]);
    const S f = (hval - voce(par[2], par[9], par[10], xi[6])) / mu;
    S n[6];
    hill_normal(hc, s[0][0], s[1][1], s[2][2], s[0][1], s[0][2], s[1][2], hval, n);
    const int path = val(f) >= -abs_tol ? 1 : 0;
    const T w = T(path), wc = T(1) - w;
    const S dgam = xi[6] - xip[6];
    // voigt order 00 11 22 01 02 12; the plastic zz row is
    // incompressibility tr(pstrain) = 0 (small_hill.cpp:240)
    S re[6], rp[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      re[k] = xi[k] - xip[k];
      rp[k] = re[k] - dgam * n[k];
    }
    rp[2] = (xi[0] + xi[1]) + xi[2];
#pragma unroll
    for (int k = 0; k < 6; ++k) C[k] = w * rp[k] + wc * re[k];
    C[6] = w * f + wc * dgam;
    return path;
  }
};

// the two plane variants: xi = [pstrain voigt (3), alpha]; params
// [E, nu, Y, S, D, R00, R11, R22, R01], R02 = R12 = 1
template <typename T, typename Self>
struct SmallHill2D {
  static constexpr int D = 2, NXI = 4, NPAR = 9;

  template <typename S>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[2][2], const T* par,
                            T abs_tol, S* C) {
    const T mu = shear_modulus(par);
    const HillCoef<T> hc(par[5], par[6], par[7], par[8], T(1), T(1));
    S s00, s11, s01, szz;
    Self::hill_stress(xi, gu, par, s00, s11, s01, szz);
    const S z(T(0));
    const S hval = hill_value(hc, s00, s11, szz, s01, z, z);
    const S f = (hval - voce(par[2], par[3], par[4], xi[3])) / mu;
    S n[6];
    hill_normal(hc, s00, s11, szz, s01, z, z, hval, n);
    const int path = val(f) >= -abs_tol ? 1 : 0;
    const T w = T(path), wc = T(1) - w;
    const S dgam = xi[3] - xip[3];
    const S wd = w * dgam;
    // voigt order 00 11 01; n3[0][0], n3[1][1], n3[0][1]
    C[0] = (xi[0] - xip[0]) - wd * n[0];
    C[1] = (xi[1] - xip[1]) - wd * n[1];
    C[2] = (xi[2] - xip[2]) - wd * n[3];
    C[3] = w * f + wc * dgam;
    return path;
  }
};

// small_hill_plane_strain (models/batched.py:927-1025), mixed u/p: the
// in-plane deviator embedded in 3D with s_zz = 2 mu (-tr(eps)/3 + tr(ps))
template <typename T>
struct SmallHillPlaneStrain : SmallHill2D<T, SmallHillPlaneStrain<T>> {
  static constexpr bool MIXED = true;

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[2][2], const T* par, S out[2][2]) {
    small_dev_stress<2>(xi, gu, shear_modulus(par), out);
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[2][2], const T* par) {
    return small_hydro<2>(gu, par);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }

  template <typename S>
  C8_HD static void hill_stress(const S* xi, const S gu[2][2], const T* par, S& s00, S& s11,
                                S& s01, S& szz) {
    const T mu = shear_modulus(par);
    S s2[2][2];
    stress(xi, gu, par, s2);
    s00 = s2[0][0];
    s11 = s2[1][1];
    s01 = s2[0][1];
    szz = (T(2) * mu) * ((-sym_trace<2>(gu)) / T(3) + (xi[0] + xi[1]));
  }
};

// small_hill_plane_stress (models/batched.py:825-925), displacement only:
// sigma_zz = 0 eliminated through eps_zz; Hill on the 3D embedding of the
// in-plane Cauchy stress (s_zz = 0)
template <typename T>
struct SmallHillPlaneStress : SmallHill2D<T, SmallHillPlaneStress<T>> {
  static constexpr bool MIXED = false;

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[2][2], const T* par, S out[2][2]) {
    const T Em = par[0], nu = par[1];
    const T lam = (Em * nu) / ((T(1) + nu) * (T(1) - T(2) * nu));
    const T mu = shear_modulus(par);
    S eps[2][2], ps[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) eps[i][j] = (gu[i][j] + gu[j][i]) * T(0.5);
    voigt_to_sym<2>(xi, ps);
    const S tr_eps = eps[0][0] + eps[1][1];
    const S eps_zz = (-(lam * tr_eps + (T(2) * mu) * (ps[0][0] + ps[1][1]))) / (lam + T(2) * mu);
    const S diag = lam * (tr_eps + eps_zz);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        out[i][j] = (T(2) * mu) * (eps[i][j] - ps[i][j]);
        if (i == j) out[i][j] = out[i][j] + diag;
      }
  }

  template <typename S>
  C8_HD static void hill_stress(const S* xi, const S gu[2][2], const T* par, S& s00, S& s11,
                                S& s01, S& szz) {
    S c[2][2];
    stress(xi, gu, par, c);
    s00 = c[0][0];
    s11 = c[1][1];
    s01 = c[0][1];
    szz = S(T(0));
  }
};

}  // namespace c8
