// Per-element assembly in the implicit kernel mode: the local Newton for
// xi, the residual rows, and the statically condensed Jacobian
// J = dR/dx - dR/dxi (dC/dxi)^-1 dC/dx (reference evaluations.cpp:112).
// One call handles one element; implicit_assembly.cu runs it in one
// thread per element.  The models are the implicit twins of c8_hill.cuh.
//
// The arithmetic follows calibr8_tpu's fused Pallas kernel in its
// implicit mode (fem/pallas_assembly.py:242-482) and its local Newton
// (models/batched.py:561-671), as does the port's plain version
// (calibr8_tpu_torch/fem/fused_assembly.py), so the three agree to
// rounding:
//  - local Newton, at most newton_iters = 16 iterations: the branch is
//    taken from the current xi; the lane is done once ||C|| < abs_tol
//    (then it stops, which gives the same xi as calibr8_tpu's gated
//    update); the step is dxi = -(dC/dxi)^-1 C, added times
//    all(isfinite(dxi)); fail where ||C(xi)|| >= fail_tol at the end;
//  - small solves: Gauss-Jordan without pivoting, multiplying by
//    1 / A[k][k] (utils/smallsolve.py:64-83);
//  - condensation: the tangents of H(v) = [C; S_rows] over the
//    nxi + d*d seeds of v = [xi; grad_u] (Dual<T, NXI + D*D>, the
//    counterpart of jax.linearize), dxi/dgu = -(dC/dxi)^-1 dC/dgu, and
//    the condensed row K_i = dS_i/dgu + sum_k dS_i/dxi_k dxi_k/dgu, the k
//    terms added in index order (pallas_assembly.py:363-400).
// The Newton carries the nxi tangents only (Dual<T, NXI>); the nxi + d*d
// tangents are carried once, at the converged xi.
//
// Rows: mixed u/p with GLS stabilization and the analytic pressure
// columns (pallas_assembly.py:423-476), or, for displacement-only specs,
// the momentum rows times the thickness (pallas_assembly.py:299-314,
// 402-421).  Layouts as in c8_element.cuh, with nde = npe * (d + 1)
// (mixed) or npe * d; iters (E,) int32, when not null, gets each
// element's number of Newton updates.
#pragma once

#include "c8_hill.cuh"

namespace c8 {

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

template <typename T>
C8_HD bool finite(T x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

template <typename T, template <typename> class Model>
C8_HD void implicit_element(
    int e, int E, const T* __restrict__ x, const int* __restrict__ edofs_T,
    const T* __restrict__ xi_prev, const T* __restrict__ gN_T,
    const T* __restrict__ detJ, const T* __restrict__ h,
    const T* __restrict__ params, const int* __restrict__ es_ids,
    const Quad<T>& q, T meas0, T stab_half, T thick, T abs_tol, T fail_tol,
    T* __restrict__ R_T, T* __restrict__ J_T, T* __restrict__ xi_T,
    int* __restrict__ path_out, int* __restrict__ fail_out, int* __restrict__ iters_out) {
  typedef Model<T> M;
  constexpr int D = M::D, NPE = D + 1, NG = D * D, NXI = M::NXI, NPAR = M::NPAR;
  constexpr bool MIXED = M::MIXED;
  constexpr int NDPN = MIXED ? D + 1 : D, NDE = NPE * NDPN, NV = NXI + NG;
  constexpr int NEWTON_ITERS = 16;

  // ---- gather ----
  T u[NPE][D], p[NPE], gN[NPE][D];
#pragma unroll
  for (int n = 0; n < NPE; ++n) {
#pragma unroll
    for (int c = 0; c < D; ++c) u[n][c] = x[edofs_T[(n * NDPN + c) * E + e]];
    p[n] = MIXED ? x[edofs_T[(n * NDPN + D) * E + e]] : T(0);
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

  // ---- kinematics: grad_u[i][j] = sum_n u[n][i] gN[n][j] ----
  T gu[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = u[0][i] * gN[0][j];
#pragma unroll
      for (int n = 1; n < NPE; ++n) acc = acc + u[n][i] * gN[n][j];
      gu[i][j] = acc;
    }

  // ---- local Newton, tangents over xi ----
  typedef Dual<T, NXI> SX;
  T xi[NXI];
#pragma unroll
  for (int k = 0; k < NXI; ++k) xi[k] = xip[k];  // first guess: xi_prev
  SX gux[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) gux[i][j] = SX(gu[i][j]);
  int it = 0;
  for (; it < NEWTON_ITERS; ++it) {
    SX xs[NXI], C[NXI];
#pragma unroll
    for (int k = 0; k < NXI; ++k) {
      xs[k] = SX(xi[k]);
      xs[k].d[k] = T(1);
    }
    M::residual(xs, xip, gux, par, abs_tol, C);
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
#pragma unroll
    for (int k = 0; k < NXI; ++k) xi[k] = xi[k] + gate * Ab[k][NXI];
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
    path = M::residual(xv, xip, gv, par, abs_tol, C);  // pathfn at the final xi
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
        T stab_n = (tau * grad_p[0]) * gN[n][0];
#pragma unroll
        for (int j = 1; j < D; ++j) stab_n = stab_n + (tau * grad_p[j]) * gN[n][j];
        T r_p1 = T(0);
        for (int qq = 0; qq < q.npts; ++qq) r_p1 = r_p1 + coef[qq] * q.N1[qq][n];
        row = (rp_const - stab_n * wdv0) - r_p1;
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
  for (int k = 0; k < NXI; ++k) xi_T[k * E + e] = xi[k];
  path_out[e] = path;
  if (iters_out) iters_out[e] = it;
}

}  // namespace c8
