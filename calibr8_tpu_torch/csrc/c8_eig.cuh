// The symmetric 3x3 eigendecomposition and the two yield surfaces built
// on it, Hosford's and Barlat's Yld2004-18p: the element code of the
// eigensolver twins (c8_hosford.cuh).
//
// Each function follows calibr8_tpu's trailing twin (models/batched.py:
// 1574-1765) and the port's plain version (calibr8_tpu_torch/models/
// batched.py t_eig_sym33, t_hosford_phi_n, t_barlat_phi_n) operation for
// operation, templated on the scalar S (plain T or a Dual), so one body
// serves the local Newton, its line search and the condensation:
//  - the closed trigonometric eigenvalues, r = det(B / p) / 2 clipped to
//    [-1 + 1e-14, 1 - 1e-14] (c8_clip: a zero tangent where the clip is
//    active), phi = acos(r) / 3 (the card's acos; calibr8_tpu's
//    polynomial t_acos served Mosaic, which has no inverse trig);
//  - each eigenvector the largest column of (A - lam_j I)(A - lam_k I),
//    picked branchlessly with strict > (the first of equal norms) and
//    blended as w a + (1 - w) b, e0 where that column's norm is <= 1e3
//    eps, v1 orthogonalized against v0, v2 = v0 x v1;
//  - every |x|^e as exp(e log(|x| + 1e-300)) (the 1e-300 is 0 in float).
// Sums run in the plain version's order (usum: index order, rows before
// columns); constants are cast to T.
#pragma once

#include "c8_hyper.cuh"  // det3

namespace c8 {

// |x|^e for a per-lane exponent (t_powa)
template <typename T, typename S>
C8_HD S powa(const S& x, T e) {
  return c8_exp(e * c8_log(c8_abs(x) + T(1e-300)));
}

// a - s I on a 3x3
template <typename S>
C8_HD void sub_diag3(const S a[3][3], const S& s, S out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = i == j ? a[i][j] - s : a[i][j];
}

// sum_ij a_ij^2, over rows first, then columns (usum(usum(a * a, 0), 0))
template <typename S>
C8_HD S sum_sq3(const S a[3][3]) {
  S tot;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const S col = (a[0][j] * a[0][j] + a[1][j] * a[1][j]) + a[2][j] * a[2][j];
    tot = j == 0 ? col : tot + col;
  }
  return tot;
}

template <typename S>
C8_HD S dot3(const S a[3], const S b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// the unit largest column of (A - lj I)(A - lk I), e0 where it vanishes
template <typename S>
C8_HD void eig_vec(const S A[3][3], const S& lj, const S& lk, S v[3]) {
  typedef decltype(val(A[0][0])) T;
  S X[3][3], Y[3][3], M[3][3];
  sub_diag3(A, lj, X);
  sub_diag3(A, lk, Y);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = (X[i][0] * Y[0][j] + X[i][1] * Y[1][j]) + X[i][2] * Y[2][j];
  S nrm[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) nrm[m] = (M[0][m] * M[0][m] + M[1][m] * M[1][m]) + M[2][m] * M[2][m];
  const T w1 = val(nrm[1]) > val(nrm[0]) ? T(1) : T(0);
  S va[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) va[i] = w1 * M[i][1] + (T(1) - w1) * M[i][0];
  const S na = w1 * nrm[1] + (T(1) - w1) * nrm[0];
  const T w2 = val(nrm[2]) > val(na) ? T(1) : T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = w2 * M[i][2] + (T(1) - w2) * va[i];
  const S nmax = w2 * nrm[2] + (T(1) - w2) * na;
  const T ok = c8_sqrt(val(nmax)) > T(1e3 * 1e-12) ? T(1) : T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = ok * v[i] + (T(1) - ok) * S(T(i == 0 ? 1 : 0));
  const S inv = c8_sqrt(dot3(v, v) + T(1e-12 * 1e-12));
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = v[i] / inv;
}

// eigenvalues lam (descending) and eigenvectors V[i] (t_eig_sym33)
template <typename S>
C8_HD void eig_sym33(const S A[3][3], S lam[3], S V[3][3]) {
  typedef decltype(val(A[0][0])) T;
  const S q = ((A[0][0] + A[1][1]) + A[2][2]) / T(3);
  S B[3][3], Bn[3][3];
  sub_diag3(A, q, B);
  const S p = c8_sqrt(sum_sq3(B) / T(6) + T(1e-12 * 1e-12));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Bn[i][j] = B[i][j] / p;
  const S r = c8_clip(det3(Bn) / T(2), T(-1.0 + 1e-14), T(1.0 - 1e-14));
  const S phi = c8_acos(r) / T(3);
  const S tp = T(2) * p;
  lam[0] = q + tp * c8_cos(phi);
  lam[2] = q + tp * c8_cos(phi + T(2.0 * 3.141592653589793 / 3.0));
  lam[1] = (T(3) * q - lam[0]) - lam[2];
  S v1r[3];
  eig_vec(A, lam[1], lam[2], V[0]);
  eig_vec(A, lam[2], lam[0], v1r);
  const S dv = dot3(v1r, V[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i) v1r[i] = v1r[i] - dv * V[0][i];
  const S inv = c8_sqrt(dot3(v1r, v1r) + T(1e-12 * 1e-12));
#pragma unroll
  for (int i = 0; i < 3; ++i) V[1][i] = v1r[i] / inv;
  V[2][0] = V[0][1] * V[1][2] - V[0][2] * V[1][1];
  V[2][1] = V[0][2] * V[1][0] - V[0][0] * V[1][2];
  V[2][2] = V[0][0] * V[1][1] - V[0][1] * V[1][0];
}

// sqrt(3/2 |dev|^2 + 1e-30)
template <typename S>
C8_HD S vm_of(const S dev[3][3]) {
  typedef decltype(val(dev[0][0])) T;
  return c8_sqrt(T(1.5) * sum_sq3(dev) + T(1e-30));
}

// the deviator with the trace over 3 (t_dev3)
template <typename S>
C8_HD void dev3(const S a[3][3], S out[3][3]) {
  typedef decltype(val(a[0][0])) T;
  sub_diag3(a, ((a[0][0] + a[1][1]) + a[2][2]) / T(3), out);
}

// vm exp(log(max(total, 1e-30)) / a)
template <typename T, typename S>
C8_HD S phi_from_total(const S& vm, const S& total, T a) {
  return vm * c8_exp(c8_log(maxc(total, T(1e-30))) / a);
}

// out[i][j] += c v_i v_j, or = when first (the plain version's sum of
// c_k outer(v_k) in k order)
template <typename S>
C8_HD void add_outer(const S& c, const S v[3], bool first, S out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const S t = c * (v[i] * v[j]);
      out[i][j] = first ? t : out[i][j] + t;
    }
}

// Hosford's effective stress and normal (t_hosford_phi_n): n in voigt
// order [00, 11, 22, 01, 02, 12]
template <typename T, typename S>
C8_HD S hosford_phi_n(const S sigma[3][3], const S dev[3][3], T a, S n[6]) {
  const S vm = vm_of(dev);
  S l[3], V[3][3];
  eig_sym33(sigma, l, V);
  const S sl0 = l[0] / vm, sl1 = l[1] / vm, sl2 = l[2] / vm;
  const S d01 = c8_clip(sl0 - sl1, T(-4), T(4));
  const S d12 = c8_clip(sl1 - sl2, T(-4), T(4));
  const S d20 = c8_clip(sl2 - sl0, T(-4), T(4));
  const S total = T(0.5) * ((powa(d01, a) + powa(d12, a)) + powa(d20, a));
  const S phi = phi_from_total(vm, total, a);
  const S ps = maxc(phi, T(1e-30));
  const S p01 = c8_clip(l[0] / ps - l[1] / ps, T(-4), T(4));
  const S p12 = c8_clip(l[1] / ps - l[2] / ps, T(-4), T(4));
  const S p20 = c8_clip(l[2] / ps - l[0] / ps, T(-4), T(4));
  const T am2 = a - T(2);
  const S f01 = p01 * powa(p01, am2), f12 = p12 * powa(p12, am2), f20 = p20 * powa(p20, am2);
  S m[3][3];
  add_outer(f01 - f20, V[0], true, m);
  add_outer(f12 - f01, V[1], false, m);
  add_outer(f20 - f12, V[2], false, m);
  n[0] = T(0.5) * m[0][0];
  n[1] = T(0.5) * m[1][1];
  n[2] = T(0.5) * m[2][2];
  n[3] = T(0.5) * m[0][1];
  n[4] = T(0.5) * m[0][2];
  n[5] = T(0.5) * m[1][2];
  return phi;
}

// ---- a yield surface's tangents through the stress's six components ----
//
// phi and n are functions of the symmetric stress A alone: 6 inputs, 7
// outputs.  The residual's scalar carries more seeds than that (the local
// Newton's 7, the condensation's 16), most of them zero or redundant in
// A.  So yield_inner runs the surface Y (Y::eval(A, par, n)) once on
// Dual<T, 6>, seeded at A's value, one seed per voigt component c of
// [00, 11, 22, 01, 02, 12] (an off-diagonal seed sets A[i][j] and A[j][i]),
// and contracts its 7 x 6 Jacobian with the outer tangents of the same six
// components: out.d[j] = sum_c Jin[r][c] A_c.d[j], c in index order.  The
// values are the surface's own; the tangents differ from a pass of the
// outer duals through Y only by the contraction's rounding (every tie and
// select of Y is the same linear map of the seeds either way).  Exact only
// where A is symmetric bit for bit, in value and every tangent, as
// small_dev_stress and voigt_to_sym build it.
//
// G lanes (L: SoloLane, or a TeamLane of kernel 1b's team) split the six
// seeds, lane l those with c mod G = l (Dual<T, ceil(6 / G)>); at G > 1
// each lane puts its columns of the Jacobian in the team's scratch (42
// words), and after sync() every lane reads all of it and contracts its own
// outer slots.  Each column has the same bits at every G (the Dual rules
// compute each tangent apart), so every G gives the same outputs.  A plain
// T (the line search's trials, the branch at the first guess) calls Y.

// the voigt component of A[i][j]
C8_HD constexpr int voigt_of(int i, int j) {
  return i == j ? i : (i + j == 1 ? 3 : (i + j == 2 ? 4 : 5));
}

template <typename Y, typename T, typename L>
C8_HD T yield_inner(const T A[3][3], const T* par, const L&, T n[6]) {
  return Y::eval(A, par, n);
}

template <typename Y, typename T, int N, typename L>
C8_HD Dual<T, N> yield_inner(const Dual<T, N> A[3][3], const T* par, const L& ln,
                             Dual<T, N> n[6]) {
  constexpr int G = L::G, NI = (6 + G - 1) / G;
  typedef Dual<T, NI> SI;
  SI Ai[3][3], ni[6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Ai[i][j] = SI(A[i][j].v);
#pragma unroll
      for (int s = 0; s < NI; ++s) Ai[i][j].d[s] =
            s * G + ln.lane == voigt_of(i, j) ? T(1) : tangent_zero<T>();
    }
  const SI phii = Y::eval(Ai, par, ni);
  // Jin[r][c]: d(phi, n[0..5])[r] / dA_c
  T Jin[7][6];
  if constexpr (G == 1) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      Jin[0][c] = phii.d[c];
#pragma unroll
      for (int k = 0; k < 6; ++k) Jin[1 + k][c] = ni[k].d[c];
    }
  } else {
#pragma unroll
    for (int s = 0; s < NI; ++s) {
      const int c = s * G + ln.lane;
      if (c < 6) {
        ln.sh[c] = phii.d[s];
#pragma unroll
        for (int k = 0; k < 6; ++k) ln.sh[(1 + k) * 6 + c] = ni[k].d[s];
      }
    }
    ln.sync();
#pragma unroll
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int c = 0; c < 6; ++c) Jin[r][c] = ln.sh[r * 6 + c];
    ln.sync();
  }
  Dual<T, N> phi;
  phi.v = phii.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) n[k].v = ni[k].v;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T a[6] = {A[0][0].d[j], A[1][1].d[j], A[2][2].d[j],
                    A[0][1].d[j], A[0][2].d[j], A[1][2].d[j]};
    T o[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) {
      T acc = Jin[r][0] * a[0];
#pragma unroll
      for (int c = 1; c < 6; ++c) acc = acc + Jin[r][c] * a[c];
      o[r] = acc;
    }
    phi.d[j] = o[0];
#pragma unroll
    for (int k = 0; k < 6; ++k) n[k].d[j] = o[1 + k];
  }
  return phi;
}

// the Yld2004-18p linear transform (t_barlat_L_apply) of a stress in
// Barlat's flat order [00, 11, 22, 01, 12, 20]; c = [c01, c02, c10, c12,
// c20, c21, c33, c44, c55]
template <typename T, typename S>
C8_HD void barlat_L_apply(const T* c, const S s[6], S o[6]) {
  o[0] = (((c[0] + c[1]) * s[0] + (T(-2) * c[0] + c[1]) * s[1]) + (c[0] - T(2) * c[1]) * s[2]) / T(3);
  o[1] = (((T(-2) * c[2] + c[3]) * s[0] + (c[2] + c[3]) * s[1]) + (c[2] - T(2) * c[3]) * s[2]) / T(3);
  o[2] = (((T(-2) * c[4] + c[5]) * s[0] + (c[4] - T(2) * c[5]) * s[1]) + (c[4] + c[5]) * s[2]) / T(3);
  o[3] = c[6] * s[3];
  o[4] = c[7] * s[4];
  o[5] = c[8] * s[5];
}

template <typename S>
C8_HD void flatten_stress(const S a[3][3], S f[6]) {
  f[0] = a[0][0]; f[1] = a[1][1]; f[2] = a[2][2];
  f[3] = a[0][1]; f[4] = a[1][2]; f[5] = a[2][0];
}

template <typename S>
C8_HD void unflatten_stress(const S f[6], S a[3][3]) {
  a[0][0] = f[0]; a[0][1] = f[3]; a[0][2] = f[5];
  a[1][0] = f[3]; a[1][1] = f[1]; a[1][2] = f[4];
  a[2][0] = f[5]; a[2][1] = f[4]; a[2][2] = f[2];
}

// Barlat Yld2004-18p effective stress and normal (t_barlat_phi_n) on TC:
// sp, dp the two transforms' coefficients; n in voigt order
template <typename T, typename S>
C8_HD S barlat_phi_n(const S TC[3][3], const T* sp, const T* dp, T a, S n[6]) {
  S dv[3][3], flat[6], tf[6], X[3][3];
  dev3(TC, dv);
  const S vm = vm_of(dv);
  flatten_stress(TC, flat);
  S sl[3], sV[3][3], dl[3], dV[3][3];
  barlat_L_apply(sp, flat, tf);
  unflatten_stress(tf, X);
  eig_sym33(X, sl, sV);
  barlat_L_apply(dp, flat, tf);
  unflatten_stress(tf, X);
  eig_sym33(X, dl, dV);
  S total;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const S t = powa(c8_clip(sl[i] / vm - dl[j] / vm, T(-8), T(8)), a);
      total = (i == 0 && j == 0) ? t : total + t;
    }
  const S phi = phi_from_total(vm, T(0.25) * total, a);
  const S ps = maxc(phi, T(1e-30));
  const T am2 = a - T(2);
  S fac[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const S dm = c8_clip(sl[i] / ps - dl[j] / ps, T(-8), T(8));
      fac[i][j] = dm * powa(dm, am2);
    }
  S spn[3][3], dpn[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    add_outer(T(0.25) * ((fac[i][0] + fac[i][1]) + fac[i][2]), sV[i], i == 0, spn);
    add_outer(T(-0.25) * ((fac[0][i] + fac[1][i]) + fac[2][i]), dV[i], i == 0, dpn);
  }
  S fs[6], fd[6], os[6], od[6];
  flatten_stress(spn, fs);
  flatten_stress(dpn, fd);
  barlat_L_apply(sp, fs, os);
  barlat_L_apply(dp, fd, od);
  // flat [00, 11, 22, 01, 12, 20] -> voigt [00, 11, 22, 01, 02, 12]
  n[0] = os[0] + od[0];
  n[1] = os[1] + od[1];
  n[2] = os[2] + od[2];
  n[3] = os[3] + od[3];
  n[4] = os[5] + od[5];
  n[5] = os[4] + od[4];
  return phi;
}

}  // namespace c8
