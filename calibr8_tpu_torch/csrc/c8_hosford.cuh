// The eigensolver twins, implicit-mode models of the fused assembly:
// small_hosford (3D, mixed u/p, small strain), hypo_hosford and
// hypo_barlat (3D, mixed u/p, the hypo kinematics of c8_hypo.cuh).
//
// Each follows calibr8_tpu's trailing twin (models/batched.py:1768-1953)
// and the port's plain version (calibr8_tpu_torch/models/batched.py) step
// for step, on the yield surfaces of c8_eig.cuh.  What they add to the
// model interface of c8_hill.cuh: FREEZE_PATH = true.  Their local
// Newton (c8_implicit.cuh) takes the branch once, at the first guess, and
// passes it into every residual, the line search's and the
// condensation's, whose residual(..., abs_tol, path_in, C) reads path_in
// (or, given -1, takes the branch from f >= -abs_tol, as pathfn does) and
// returns the path it used; FREEZE_PATH also turns on the local line
// search (calibr8_tpu's local_line_search defaults to freeze_path).
// 30 local Newton iterations.  The hypo twins use the precompute hook:
// their residual_pre reads the unrotated rate d.  The residuals take the
// lanes that split the yield surface's own seeds (SoloLane, or kernel 1b's
// TeamLane): the Hosford surface runs on the stress's six components
// (c8_eig.cuh yield_inner); Barlat's ignores them.
#pragma once

#include "c8_eig.cuh"
#include "c8_hypo.cuh"

namespace c8 {

template <typename T, typename S>
C8_HD int frozen_path(int path_in, const S& f, T abs_tol) {
  return path_in >= 0 ? path_in : (val(f) >= -abs_tol ? 1 : 0);
}

// Y + K alpha + S (1 - exp(-D alpha))
template <typename T, typename S>
C8_HD S combined_flow(T Y, T K, T Sat, T Dexp, const S& alpha) {
  return (Y + K * alpha) + Sat * (T(1) - c8_exp((-Dexp) * alpha));
}

// Hosford on a deviatoric stress s (small_hosford's): sigma and dev are s
template <typename T>
struct HosfordOnDev {
  template <typename S>
  C8_HD static S eval(const S s[3][3], const T* par, S n[6]) {
    return hosford_phi_n(s, s, par[3], n);
  }
};

// small_hosford (models/batched.py:1768-1851): xi = [pstrain voigt (6),
// alpha]; params [E, nu, Y, a, K, S, D]; Hosford on the deviatoric stress
template <typename T>
struct SmallHosford : SmallStrainTwin<T, 3, 7> {
  static constexpr int NPAR = 7, NEWTON_ITERS = 30;
  static constexpr bool MIXED = true, FREEZE_PATH = true;
  // kernel 1b's lanes per element (c8_implicit.cuh implicit_team_lanes)
  static constexpr int TEAM_LANES = sizeof(T) == 8 ? 2 : 1;

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[3][3], const T* par, S out[3][3]) {
    small_dev_stress<3>(xi, gu, shear_modulus(par), out);
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[3][3], const T* par) {
    return small_hydro<3>(gu, par);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }

  template <typename S, typename L = SoloLane>
  C8_HD static int residual(const S* xi, const T* xip, const S gu[3][3], const T gup[3][3],
                            const T* par, T abs_tol, int path_in, S* C, const L& ln = L()) {
    const T mu = shear_modulus(par);
    S s[3][3], n[6];
    stress(xi, gu, par, s);
    const S phi = yield_inner<HosfordOnDev<T>>(s, par, ln, n);
    const S f = (phi - combined_flow(par[2], par[4], par[5], par[6], xi[6])) / (T(2) * mu);
    const int path = frozen_path(path_in, f, abs_tol);
    const T w = T(path);
    const S dgam = xi[6] - xip[6];
    const S wd = w * dgam;
#pragma unroll
    for (int k = 0; k < 6; ++k) C[k] = (xi[k] - xip[k]) - wd * n[k];
    C[6] = w * f + (T(1) - w) * dgam;
    return path;
  }
};

// what hypo_hosford and hypo_barlat share (models/batched.py:1854-1953):
// the hypo_hill kinematics (HypoHill's elastic update and rotated stress),
// xi = [TC voigt (6), alpha], the residual scaled by 1 / (2 mu); Yield
// gives phi, n and the flow stress
template <typename T, int NPAR_, typename Yield>
struct HypoEigTwin : HypoTwin<T, 3, 7, NPAR_, true> {
  static constexpr int NEWTON_ITERS = 30;
  static constexpr bool FREEZE_PATH = true;
  template <typename S>
  using Pre = typename HypoTwin<T, 3, 7, NPAR_, true>::template Pre<S>;

  template <typename S>
  C8_HD static void precompute(const S gu[3][3], const T gup[3][3], const T* par, Pre<S>& pre) {
    unrotated_rate<3>(gu, gup, pre.d);
  }

  C8_HD static void first_guess(const T* xip, const T gu[3][3], const T gup[3][3],
                                const T* par, T* xi) {
    HypoHill<T>::first_guess(xip, gu, gup, par, xi);
  }

  template <typename S, typename P, typename L = SoloLane>
  C8_HD static int residual_pre(const S* xi, const T* xip, const Pre<P>& pre, const T* par,
                                T abs_tol, int path_in, S* C, const L& ln = L()) {
    const T mu = shear_modulus(par);
    P upd[6];
    HypoHill<T>::elastic_update(xip, pre.d, par, upd);
    S TC[3][3], n[6];
    voigt_to_sym<3>(xi, TC);
    const S phi = Yield::phi_n(TC, par, n, ln);
    const S f = (phi - Yield::flow(par, xi[6])) / (T(2) * mu);
    const int path = frozen_path(path_in, f, abs_tol);
    const T w = T(path);
    const S dgam = xi[6] - xip[6];
    const S wd = w * dgam;
#pragma unroll
    for (int k = 0; k < 6; ++k) C[k] = (xi[k] - upd[k]) / (T(2) * mu) + wd * n[k];
    C[6] = w * f + (T(1) - w) * dgam;
    return path;
  }

  template <typename S>
  C8_HD static void stress(const S* xi, const S gu[3][3], const T* par, S out[3][3]) {
    HypoHill<T>::stress(xi, gu, par, out);
  }

  template <typename S>
  C8_HD static S hydro(const S* xi, const S gu[3][3], const T* par) {
    return HypoHill<T>::hydro(xi, gu, par);
  }

  C8_HD static T psf(const T* par) { return small_psf(par); }
};

// Hosford on TC (deviator from TC), through TC's six components
// (yield_inner), flow Y + S (1 - exp(-D alpha))
template <typename T>
struct HosfordOnTC {
  template <typename S>
  C8_HD static S eval(const S TC[3][3], const T* par, S n[6]) {
    S dv[3][3];
    dev3(TC, dv);
    return hosford_phi_n(TC, dv, par[3], n);
  }
  template <typename S, typename L>
  C8_HD static S phi_n(const S TC[3][3], const T* par, S n[6], const L& ln) {
    return yield_inner<HosfordOnTC<T>>(TC, par, ln, n);
  }
  template <typename S>
  C8_HD static S flow(const T* par, const S& alpha) {
    return par[2] + par[5] * (T(1) - c8_exp((-par[6]) * alpha));
  }
};

// Barlat Yld2004-18p on TC with sp = par[7..15], dp = par[16..24], flow
// Y + K alpha + S (1 - exp(-D alpha))
template <typename T>
struct BarlatOnTC {
  template <typename S, typename L>
  C8_HD static S phi_n(const S TC[3][3], const T* par, S n[6], const L&) {
    return barlat_phi_n(TC, par + 7, par + 16, par[3], n);
  }
  template <typename S>
  C8_HD static S flow(const T* par, const S& alpha) {
    return combined_flow(par[2], par[4], par[5], par[6], alpha);
  }
};

// hypo_hosford (models/batched.py:1854-1901): params [E, nu, Y, a, K, S, D]
template <typename T>
struct HypoHosford : HypoEigTwin<T, 7, HosfordOnTC<T>> {
  // kernel 1b's lanes per element (c8_implicit.cuh implicit_team_lanes)
  static constexpr int TEAM_LANES = sizeof(T) == 8 ? 2 : 1;
};

// hypo_barlat (models/batched.py:1904-1953): params [E, nu, Y, a, K, S, D,
// sp_* (9), dp_* (9)]
template <typename T>
struct HypoBarlat : HypoEigTwin<T, 25, BarlatOnTC<T>> {
  // kernel 1b's lanes per element (c8_implicit.cuh implicit_team_lanes)
  static constexpr int TEAM_LANES = 2;
};

}  // namespace c8
