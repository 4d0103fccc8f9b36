"""Trailing-layout (element axis last) constitutive twins, in PyTorch.

The counterparts of calibr8_tpu's hand-batched twins (models/batched.py
there): every array is (..., E) with the element axis last, small tensor
algebra is written out over the leading axes.  They form the body of the
fused assembly's plain version (fem/fused_assembly.py), and the CUDA
kernels' model bodies (csrc/c8_element.cuh for the analytic twins,
csrc/c8_hill.cuh for the implicit ones) follow them line by line, so
the two agree to rounding.

Analytic twins (elastic, small_J2) solve the local state in closed form;
implicit twins (the small-strain Hill family) run implicit_newton, and
the assembly condenses dxi/dgu through their residual.  Every twin has
the local residual C with the branch forced to a given path, which the
adjoint blocks (fem/adjoint_blocks.py) differentiate.  Each twin takes
grad_u (d, d, E) directly (calibr8_tpu passes a Kinematics whose
grad_u_prev none of these models reads).  Tangent
rules follow JAX's, which the plain version reproduces under
torch.func.jvp: torch.where takes the tangent of the selected branch,
torch.maximum splits the tangent evenly at a tie, and t_norm adds 1e-30
under the square root.
"""

from __future__ import annotations

import numpy as np
import torch

from calibr8_tpu_torch.utils.smallsolve import gauss_solve_T

SQRT_23 = float(np.sqrt(2.0 / 3.0))
SQRT_32 = float(np.sqrt(3.0 / 2.0))


def usum(x, dim: int):
    """Sum over a small axis in index order (the order calibr8_tpu's
    unrolled sums and the CUDA kernel use)."""
    acc = x.select(dim, 0)
    for k in range(1, x.shape[dim]):
        acc = acc + x.select(dim, k)
    return acc


def t_voigt_to_sym(v, d: int):
    """(nc, E) -> (d, d, E)."""
    if d == 2:
        return torch.stack(
            [torch.stack([v[0], v[2]]), torch.stack([v[2], v[1]])]
        )
    return torch.stack(
        [
            torch.stack([v[0], v[3], v[4]]),
            torch.stack([v[3], v[1], v[5]]),
            torch.stack([v[4], v[5], v[2]]),
        ]
    )


def t_sym_to_voigt(a, d: int):
    if d == 2:
        return torch.stack([a[0, 0], a[1, 1], a[0, 1]])
    return torch.stack([a[0, 0], a[1, 1], a[2, 2], a[0, 1], a[0, 2], a[1, 2]])


def t_trace(a):
    t = a[0, 0]
    for i in range(1, a.shape[0]):
        t = t + a[i, i]
    return t


def t_sub_diag(a, s):
    """a - s*I on (d, d, E)."""
    d = a.shape[0]
    return torch.stack(
        [torch.stack([a[i, j] - s if i == j else a[i, j] for j in range(d)]) for i in range(d)]
    )


def t_dev3(a):
    """Deviator with the 3D trace factor in any dimension (the
    reference's small-strain models divide the trace by 3 in 2D too)."""
    return t_sub_diag(a, t_trace(a) / 3.0)


def t_norm(a, eps=1e-30):
    return torch.sqrt(usum(usum(a * a, 0), 0) + eps)


def t_sym(a):
    return 0.5 * (a + a.transpose(0, 1))


class BatchedSmallJ2:
    """Twin of SmallJ2: xi (nc+1, E) = [pstrain voigt, alpha]; params
    (6, E) = [E, nu, K, Y, cte, delta_T]."""

    name = "small_J2"
    analytic_solve = True
    plane_stress = False

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nc = 3 if self.dim == 2 else 6
        self.nxi = model.nxi()
        self.abs_tol = model.abs_tol

    def _mu(self, parT):
        return parT[0] / (2.0 * (1.0 + parT[1]))

    def dev_cauchy(self, xiT, gu, parT):
        mu = self._mu(parT)
        ps = t_voigt_to_sym(xiT[: self.nc], self.dim)
        return 2.0 * mu * (t_dev3(t_sym(gu)) - ps)

    def local_solve(self, xipT, gu, parT):
        """Closed-form radial return (the same root the reference's local
        Newton finds, small_J2.cpp:186-246).  Returns (xiT, path (E,)
        int32, failed (E,) int32)."""
        mu = self._mu(parT)
        K, Y = parT[2], parT[3]
        ps_prev = t_voigt_to_sym(xipT[: self.nc], self.dim)
        alpha_prev = xipT[self.nc]
        s_tr = 2.0 * mu * (t_dev3(t_sym(gu)) - ps_prev)
        s_mag = t_norm(s_tr)
        f_tr = (s_mag - SQRT_23 * (Y + K * alpha_prev)) / mu
        plastic = f_tr >= -self.abs_tol
        zero = torch.zeros_like(f_tr)
        dgam = torch.maximum(f_tr, zero) * mu / (2.0 * mu + (2.0 / 3.0) * K)
        n_tr = s_tr / s_mag
        ps = ps_prev + torch.where(plastic, dgam, zero) * n_tr
        alpha = alpha_prev + torch.where(plastic, SQRT_23 * dgam, zero)
        xiT = torch.cat([t_sym_to_voigt(ps, self.dim), alpha[None, :]], dim=0)
        path = plastic.to(torch.int32)
        return xiT, path, torch.zeros_like(path)

    def residual(self, xiT, xipT, gu, parT, path):
        """The local residual C with the branch forced to `path`
        (calibr8_tpu models/small_strain.py:92-148): plastic rows
        pstrain - pstrain_old - sqrt(3/2) dalpha n and f, elastic rows
        the increments.  The branches are selected with torch.where, whose
        tangent is the selected branch's, as jnp.where's is."""
        d, nc = self.dim, self.nc
        mu = self._mu(parT)
        K, Y = parT[2], parT[3]
        ps = t_voigt_to_sym(xiT[:nc], d)
        ps_old = t_voigt_to_sym(xipT[:nc], d)
        alpha, alpha_old = xiT[nc], xipT[nc]
        s = self.dev_cauchy(xiT, gu, parT)
        s_mag = t_norm(s)
        f = (s_mag - SQRT_23 * (Y + K * alpha)) / mu
        R_p_plastic = ps - ps_old - (SQRT_32 * (alpha - alpha_old)) * (s / s_mag)
        plastic = path == 1
        R_p = torch.where(plastic, R_p_plastic, ps - ps_old)
        R_a = torch.where(plastic, f, alpha - alpha_old)
        return torch.cat([t_sym_to_voigt(R_p, d), R_a[None, :]])

    def cauchy(self, xiT, gu, parT, pT):
        """sigma = dev_cauchy - p I, (d, d, E)."""
        return t_sub_diag(self.dev_cauchy(xiT, gu, parT), pT)

    def hydro_cauchy(self, xiT, gu, parT):
        Em, nu, cte, dT = parT[0], parT[1], parT[4], parT[5]
        kappa = Em / (3.0 * (1.0 - 2.0 * nu))
        thermal = cte * dT * Em / (1.0 - 2.0 * nu)
        return kappa * t_trace(t_sym(gu)) - thermal

    def pressure_scale_factor(self, parT):
        return parT[0] / (3.0 * (1.0 - 2.0 * parT[1]))


class BatchedElastic:
    """Twin of Elastic: the local 'solve' is the dummy xi = 0; params
    (4, E) = [E, nu, cte, delta_T]."""

    name = "elastic"
    analytic_solve = True
    plane_stress = False

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nxi = 1
        self.abs_tol = model.abs_tol

    def _mu(self, parT):
        return parT[0] / (2.0 * (1.0 + parT[1]))

    def local_solve(self, xipT, gu, parT):
        path = torch.zeros(xipT.shape[-1], dtype=torch.int32, device=xipT.device)
        return torch.zeros_like(xipT), path, torch.zeros_like(path)

    def residual(self, xiT, xipT, gu, parT, path):
        """C = xi (models/elastic.py:52-53): the dummy slot stays 0."""
        return xiT

    def dev_cauchy(self, xiT, gu, parT):
        return 2.0 * self._mu(parT) * t_dev3(t_sym(gu))

    def cauchy(self, xiT, gu, parT, pT):
        return t_sub_diag(self.dev_cauchy(xiT, gu, parT), pT)

    def hydro_cauchy(self, xiT, gu, parT):
        Em, nu, cte, dT = parT[0], parT[1], parT[2], parT[3]
        kappa = Em / (3.0 * (1.0 - 2.0 * nu))
        thermal = cte * dT * Em / (1.0 - 2.0 * nu)
        return kappa * t_trace(t_sym(gu)) - thermal

    def pressure_scale_factor(self, parT):
        return parT[0] / (3.0 * (1.0 - 2.0 * parT[1]))


def t_add_diag(a, s):
    return t_sub_diag(a, -s)


def t_hill_from_ratios(R00, R11, R22, R01, R02, R12):
    """(F, G, H, L, M, N) of Hill's function from the six yield-stress
    ratios; r**-2 is written 1 / (r * r), as JAX lowers it."""

    def inv2(r):
        return 1.0 / (r * r)

    F = 0.5 * (inv2(R11) + inv2(R22) - inv2(R00))
    G = 0.5 * (inv2(R22) + inv2(R00) - inv2(R11))
    H = 0.5 * (inv2(R00) + inv2(R11) - inv2(R22))
    L = 1.5 * inv2(R12)
    M = 1.5 * inv2(R02)
    N = 1.5 * inv2(R01)
    return F, G, H, L, M, N


def t_hill_params(parT, idx):
    """(F, G, H, L, M, N) from the six ratios at parT[idx:idx+6]."""
    return t_hill_from_ratios(*(parT[idx + k] for k in range(6)))


def t_hill_params_2d(parT, idx):
    """The plane variants carry 4 ratios (R00, R11, R22, R01); R02 =
    R12 = 1 (small_hill_plane_*.cpp)."""
    R00, R11, R22, R01 = (parT[idx + k] for k in range(4))
    one = torch.ones_like(R00)
    return t_hill_from_ratios(R00, R11, R22, R01, one, one)


def t_hill_value(s, hp, eps=1e-30):
    F, G, H, L, M, N = hp
    v2 = (
        F * (s[1, 1] - s[2, 2]) ** 2
        + G * (s[2, 2] - s[0, 0]) ** 2
        + H * (s[0, 0] - s[1, 1]) ** 2
        + 2.0 * (L * s[1, 2] ** 2 + M * s[0, 2] ** 2 + N * s[0, 1] ** 2)
    )
    return torch.sqrt(v2 + eps)


def t_hill_normal(s, hp, hval, eps=1e-30):
    F, G, H, L, M, N = hp
    n00 = (G + H) * s[0, 0] - H * s[1, 1] - G * s[2, 2]
    n11 = (F + H) * s[1, 1] - H * s[0, 0] - F * s[2, 2]
    n22 = (G + F) * s[2, 2] - G * s[0, 0] - F * s[1, 1]
    n01 = N * s[0, 1]
    n02 = M * s[0, 2]
    n12 = L * s[1, 2]
    n = torch.stack(
        [torch.stack([n00, n01, n02]), torch.stack([n01, n11, n12]), torch.stack([n02, n12, n22])]
    )
    return n / torch.maximum(hval, torch.full_like(hval, eps))


def t_embed3(c2, zz=None):
    """(2, 2, E) -> (3, 3, E) with zero off-plane couplings and zz (zero
    when None) in the corner."""
    z = torch.zeros_like(c2[0, 0])
    return torch.stack(
        [
            torch.stack([c2[0, 0], c2[0, 1], z]),
            torch.stack([c2[1, 0], c2[1, 1], z]),
            torch.stack([z, z, z if zz is None else zz]),
        ]
    )


def t_in_plane(a3):
    """The in-plane 2x2 block of a (3, 3, E) tensor."""
    return torch.stack([torch.stack([a3[0, 0], a3[0, 1]]), torch.stack([a3[1, 0], a3[1, 1]])])


class _ImplicitTwin:
    """Shared pieces of the implicit-mode twins: the local state is found
    by implicit_newton, the fused assembly condenses dxi/dgu implicitly."""

    analytic_solve = False
    plane_stress = False
    newton_iters = 16

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nc = 3 if self.dim == 2 else 6
        self.nxi = model.nxi()
        self.abs_tol = model.abs_tol

    def _mu(self, parT):
        return parT[0] / (2.0 * (1.0 + parT[1]))

    # the mixed u/p stress measures (the plane-stress twin overrides cauchy)
    def dev_cauchy(self, xiT, gu, parT):
        mu = self._mu(parT)
        ps = t_voigt_to_sym(xiT[: self.nc], self.dim)
        return 2.0 * mu * (t_dev3(t_sym(gu)) - ps)

    def cauchy(self, xiT, gu, parT, pT):
        return t_sub_diag(self.dev_cauchy(xiT, gu, parT), pT)

    def hydro_cauchy(self, xiT, gu, parT):
        Em, nu = parT[0], parT[1]
        kappa = Em / (3.0 * (1.0 - 2.0 * nu))
        return kappa * t_trace(t_sym(gu))

    def pressure_scale_factor(self, parT):
        return parT[0] / (3.0 * (1.0 - 2.0 * parT[1]))

    def first_guess(self, xipT, gu, parT):
        return xipT

    def pathfn(self, xiT, xipT, gu, parT):
        f, _ = self._f_and_n(xiT, gu, parT)
        return (f >= -self.abs_tol).to(torch.int32)

    def local_solve(self, xipT, gu, parT):
        return implicit_newton(self, xipT, gu, parT)


class BatchedSmallHill(_ImplicitTwin):
    """Twin of SmallHill: xi (7, E) = [pstrain voigt (6), alpha]; params
    (11, E) = [E, nu, Y, R00, R11, R22, R01, R02, R12, S, D]."""

    name = "small_hill"

    def _voce(self, alpha, parT):
        Y, S, D = parT[2], parT[9], parT[10]
        return Y + S * (1.0 - torch.exp(-D * alpha))

    def _f_and_n(self, xiT, gu, parT):
        mu = self._mu(parT)
        alpha = xiT[self.nc]
        hp = t_hill_params(parT, 3)
        s = self.dev_cauchy(xiT, gu, parT)
        hval = t_hill_value(s, hp)
        f = (hval - self._voce(alpha, parT)) / mu
        return f, t_hill_normal(s, hp, hval)

    def residual(self, xiT, xipT, gu, parT, path):
        """Branchwise C (small_hill.cpp); the branches blend as w a +
        (1 - w) b with w = (path == 1), as calibr8_tpu writes them."""
        ps = t_voigt_to_sym(xiT[: self.nc], 3)
        alpha = xiT[self.nc]
        ps_old = t_voigt_to_sym(xipT[: self.nc], 3)
        alpha_old = xipT[self.nc]
        f, n = self._f_and_n(xiT, gu, parT)
        dgam = alpha - alpha_old
        R_p = ps - ps_old - dgam * n
        R_e = ps - ps_old
        w = (path == 1).to(xiT.dtype)
        r22_p = t_trace(ps)  # plastic zz row: incompressibility (small_hill.cpp:240)
        rows = [
            w * R_p[0, 0] + (1.0 - w) * R_e[0, 0],
            w * R_p[1, 1] + (1.0 - w) * R_e[1, 1],
            w * r22_p + (1.0 - w) * R_e[2, 2],
            w * R_p[0, 1] + (1.0 - w) * R_e[0, 1],
            w * R_p[0, 2] + (1.0 - w) * R_e[0, 2],
            w * R_p[1, 2] + (1.0 - w) * R_e[1, 2],
            w * f + (1.0 - w) * (alpha - alpha_old),
        ]
        return torch.stack(rows)


class _SmallHill2D(_ImplicitTwin):
    """The two plane variants: params (9, E) = [E, nu, Y, S, D, R00, R11,
    R22, R01]; xi (4, E) = [pstrain voigt (3), alpha]."""

    def _voce(self, alpha, parT):
        Y, S, D = parT[2], parT[3], parT[4]
        return Y + S * (1.0 - torch.exp(-D * alpha))

    def _f_and_n(self, xiT, gu, parT):
        mu = self._mu(parT)
        alpha = xiT[self.nc]
        s3 = self._s3(xiT, gu, parT)
        hp = t_hill_params_2d(parT, 5)
        hval = t_hill_value(s3, hp)
        f = (hval - self._voce(alpha, parT)) / mu
        return f, t_in_plane(t_hill_normal(s3, hp, hval))

    def residual(self, xiT, xipT, gu, parT, path):
        ps = t_voigt_to_sym(xiT[: self.nc], 2)
        alpha = xiT[self.nc]
        ps_old = t_voigt_to_sym(xipT[: self.nc], 2)
        alpha_old = xipT[self.nc]
        f, n = self._f_and_n(xiT, gu, parT)
        dgam = alpha - alpha_old
        w = (path == 1).to(xiT.dtype)
        R_p = ps - ps_old - (w * dgam) * n
        R_a = w * f + (1.0 - w) * (alpha - alpha_old)
        return torch.cat([t_sym_to_voigt(R_p, 2), R_a[None, :]])


class BatchedSmallHillPlaneStrain(_SmallHill2D):
    """Twin of SmallHillPlaneStrain (mixed u/p): the in-plane deviator is
    embedded in 3D with s_zz = 2 mu (-tr(eps)/3 + tr(pstrain))."""

    name = "small_hill_plane_strain"

    def _s3(self, xiT, gu, parT):
        mu = self._mu(parT)
        ps = t_voigt_to_sym(xiT[: self.nc], 2)
        s2 = self.dev_cauchy(xiT, gu, parT)
        s_zz = 2.0 * mu * (-t_trace(t_sym(gu)) / 3.0 + t_trace(ps))
        return t_embed3(s2, s_zz)


class BatchedSmallHillPlaneStress(_SmallHill2D):
    """Twin of SmallHillPlaneStress (displacement only, under
    'mechanics_plane_stress'): sigma_zz = 0 eliminated through eps_zz,
    Hill yield on the 3D embedding of the in-plane Cauchy stress."""

    name = "small_hill_plane_stress"
    plane_stress = True

    def cauchy(self, xiT, gu, parT, pT=None):
        Em, nu = parT[0], parT[1]
        lam = Em * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        mu = self._mu(parT)
        ps = t_voigt_to_sym(xiT[: self.nc], 2)
        eps = t_sym(gu)
        eps_zz = -(lam * t_trace(eps) + 2.0 * mu * t_trace(ps)) / (lam + 2.0 * mu)
        return t_add_diag(2.0 * mu * (eps - ps), lam * (t_trace(eps) + eps_zz))

    def _s3(self, xiT, gu, parT):
        return t_embed3(self.cauchy(xiT, gu, parT))


def implicit_newton(bm, xipT, gu, parT):
    """The fixed-iteration local Newton of the implicit twins, per lane
    (calibr8_tpu models/batched.py:561-671, without its precompute,
    frozen-path and line-search options, which these twins do not use).
    Each iteration takes the branch from the current xi, marks a lane
    done once ||C|| < abs_tol (before its update), and adds the step
    times (1 - done) * all(isfinite(dxi)); the loop ends after
    newton_iters iterations or when every lane is done.  Returns (xiT,
    path, failed), path and failed (E,) int32, failed where ||C(xi)|| >=
    max(10 abs_tol, 1e-30) at the end."""
    nxi = bm.nxi
    xi = bm.first_guess(xipT, gu, parT)
    dtype, E = xi.dtype, xi.shape[-1]
    done = torch.zeros(E, dtype=torch.int32, device=xi.device)
    for _ in range(bm.newton_iters):
        if bool(done.min() >= 1):
            break
        path = bm.pathfn(xi, xipT, gu, parT)
        R, cols = jvp_columns(lambda z: bm.residual(z, xipT, gu, parT, path), xi)
        rnorm = torch.sqrt(usum(R * R, 0))
        done = torch.maximum(done, (rnorm < bm.abs_tol).to(torch.int32))
        J = cols.permute(1, 0, 2)  # J[i, k] = dC_i / dxi_k
        dxi = gauss_solve_T(J, -R[:, None, :])[:, 0, :]
        fin = torch.isfinite(dxi).to(dtype)
        ok = fin[0]
        for k in range(1, nxi):
            ok = ok * fin[k]
        gate = (1 - done).to(dtype) * ok
        xi = xi + gate * dxi
    path = bm.pathfn(xi, xipT, gu, parT)
    Rf = bm.residual(xi, xipT, gu, parT, path)
    rnorm = torch.sqrt(usum(Rf * Rf, 0))
    failed = (rnorm >= max(bm.abs_tol * 10.0, 1e-30)).to(torch.int32)
    return xi, path, failed


def jvp_columns(fn, v):
    """(fn(v), cols) with cols[k] = the tangent of fn along the unit seed
    k of v's first axis: the counterpart of jax.linearize followed by one
    call per seed.  v (n, E); cols (n, m, E) for fn(v) (m, E)."""
    n = v.shape[0]
    seeds = torch.eye(n, dtype=v.dtype, device=v.device)[:, :, None].expand(n, n, v.shape[-1])
    # the primal output does not depend on the seed: one copy comes back
    return torch.func.vmap(lambda t: torch.func.jvp(fn, (v,), (t,)), out_dims=(None, 0))(seeds)


BATCHED_MODELS = {
    "small_J2": BatchedSmallJ2,
    "elastic": BatchedElastic,
    "small_hill": BatchedSmallHill,
    "small_hill_plane_strain": BatchedSmallHillPlaneStrain,
    "small_hill_plane_stress": BatchedSmallHillPlaneStress,
}

# the CUDA kernels' model index (csrc/fused_assembly.cu c8_fused_assembly
# for the analytic twins, csrc/implicit_assembly.cu c8_implicit_assembly
# for the implicit ones)
KERNEL_MODEL_ID = {
    "elastic": 0, "small_J2": 1,
    "small_hill": 0, "small_hill_plane_strain": 1, "small_hill_plane_stress": 2,
}


def get_batched_model(model):
    return BATCHED_MODELS[model.name](model)
