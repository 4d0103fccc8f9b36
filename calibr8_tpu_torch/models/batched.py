"""Trailing-layout (element axis last) constitutive twins, in PyTorch.

The counterparts of calibr8_tpu's hand-batched twins (models/batched.py
there): every array is (..., E) with the element axis last, small tensor
algebra is written out over the leading axes.  They form the body of the
fused assembly's plain version (fem/fused_assembly.py), and the CUDA
kernels' model bodies (csrc/c8_element.cuh for the analytic twins,
csrc/c8_hill.cuh, c8_hyper.cuh, c8_hypo.cuh and c8_hosford.cuh (with the
eigensolver of c8_eig.cuh) for the implicit ones) follow them line by
line, so the two agree to rounding.

Analytic twins (elastic, small_J2) solve the local state in closed form;
implicit twins (the small-strain Hill family, the finite-deformation
hyper_J2 and hypo_hill families, and the eigensolver twins small_hosford,
hypo_hosford and hypo_barlat, whose local Newton freezes its branch at
the first guess and takes a line search) run implicit_newton, and the
assembly condenses dxi/dgu through their residual.  Every twin has the local residual C with the
branch forced to a given path, which the adjoint blocks
(fem/adjoint_blocks.py) differentiate.  Each twin takes grad_u (d, d, E)
and, in its local-state methods (first_guess, pathfn, local_solve,
residual), grad_u_prev, the two fields of calibr8_tpu's Kinematics.
Only the twins with finite_deformation read grad_u_prev (the relative
deformation gradient F F_prev^-1 of the hyper twins' trial state, the
hypo twins' rate (F - F_prev) F^-1); for the others it may be None.  The
stress measures read grad_u alone.  Tangent
rules follow JAX's, which the plain version reproduces under
torch.func.jvp: torch.where takes the tangent of the selected branch,
torch.maximum (and t_clip) splits the tangent evenly at a tie, t_norm
adds 1e-30 under the square root, and x ** n at n == 0 has a zero tangent
in x.
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
    finite_deformation = False

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

    def local_solve(self, xipT, gu, parT, gu_prev=None):
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

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
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
    finite_deformation = False

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nxi = 1
        self.abs_tol = model.abs_tol

    def _mu(self, parT):
        return parT[0] / (2.0 * (1.0 + parT[1]))

    def local_solve(self, xipT, gu, parT, gu_prev=None):
        path = torch.zeros(xipT.shape[-1], dtype=torch.int32, device=xipT.device)
        return torch.zeros_like(xipT), path, torch.zeros_like(path)

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
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


class BatchedIsotropicElastic:
    """Twin of IsotropicElastic (calibr8_tpu models/batched.py:2014-2072):
    displacement only, the full stress sigma = lambda tr(eps) I + 2 mu eps
    with the 1-dof dummy local slot (xi = 0, C = xi); the analytic kernel
    mode with the displacement-only momentum rows.  xi (1, E): [dummy];
    params (2, E): [E, nu]."""

    name = "isotropic_elastic"
    analytic_solve = True
    plane_stress = False
    finite_deformation = False
    displacement_only = True

    def __init__(self, model):
        self.model = model
        self.dim = model.dim
        self.nxi = 1
        self.abs_tol = model.abs_tol

    def local_solve(self, xipT, gu, parT, gu_prev=None):
        path = torch.zeros(xipT.shape[-1], dtype=torch.int32, device=xipT.device)
        return torch.zeros_like(xipT), path, torch.zeros_like(path)

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
        return xiT

    def cauchy(self, xiT, gu, parT, pT=None):
        """The full sigma (there is no pressure dof: pT is not read)."""
        Em, nu = parT[0], parT[1]
        lam = Em * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        mu = Em / (2.0 * (1.0 + nu))
        eps = t_sym(gu)
        return t_add_diag(2.0 * mu * eps, lam * t_trace(eps))


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
    finite_deformation = False
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

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        return xipT

    def pathfn(self, xiT, xipT, gu, parT, gu_prev=None):
        f, _ = self._f_and_n(xiT, gu, parT)
        return (f >= -self.abs_tol).to(torch.int32)

    def local_solve(self, xipT, gu, parT, gu_prev=None, iters=None):
        return implicit_newton(self, xipT, gu, parT, gu_prev, iters)


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

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
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

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
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


def t_mm(A, B):
    """(d, d, E) @ (d, d, E).  One einsum, not calibr8_tpu's unrolled
    sums: the order of the k sums differs by rounding only, and the plain
    version runs a third faster under torch.func."""
    return torch.einsum("ikE,kjE->ijE", A, B)


def t_transpose(a):
    return a.transpose(0, 1)


def t_det(a):
    if a.shape[0] == 2:
        return a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    return (
        a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
        - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
        + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
    )


def t_cof(a):
    """The cofactor matrix, so that inv(a) = cof(a)^T / det(a)."""
    if a.shape[0] == 2:
        return torch.stack([torch.stack([a[1, 1], -a[1, 0]]), torch.stack([-a[0, 1], a[0, 0]])])

    def m(i1, j1, i2, j2):
        return a[i1, j1] * a[i2, j2] - a[i1, j2] * a[i2, j1]

    return torch.stack([
        torch.stack([m(1, 1, 2, 2), -m(1, 0, 2, 2), m(1, 0, 2, 1)]),
        torch.stack([-m(0, 1, 2, 2), m(0, 0, 2, 2), -m(0, 0, 2, 1)]),
        torch.stack([m(0, 1, 1, 2), -m(0, 0, 1, 2), m(0, 0, 1, 1)]),
    ])


def t_inv(a):
    return t_transpose(t_cof(a)) / t_det(a)


def t_F(gu):
    """F = I + grad_u."""
    return t_add_diag(gu, 1.0)


def _sigma_yield_power(alpha, parT):
    """Y + S (1 - exp(-D alpha)) + A (alpha + 1e-12)^n + K alpha, params
    [E, nu, Y, S, D, A, n, K] (hyper_J2.cpp, hyper_J2_plane_stress.cpp)."""
    Y, S, D, A, n, K = (parT[i] for i in range(2, 8))
    return Y + S * (1.0 - torch.exp(-D * alpha)) + A * (alpha + 1e-12) ** n + K * alpha


class _HyperJ2Twin(_ImplicitTwin):
    """Shared pieces of the finite-deformation J2 twins (calibr8_tpu
    models/batched.py:304-421, 1159-1289, 1396-1573): the local state
    [zeta voigt, Ie, (lambda_z,) alpha] with zeta = dev(be_bar), Ie =
    tr(be_bar) / 3; the trial be_bar pushed forward by rF_bar = rF /
    det(rF)^(1/3), rF = F F_prev^-1 (the cube root as exp(log / 3), as
    calibr8_tpu writes it); radial return with n = s / |s|, s = mu zeta."""

    finite_deformation = True

    def _F_prev(self, gu_prev):
        if gu_prev is None:
            raise ValueError(f"{self.name!r} reads grad_u_prev: pass the previous step's state")
        return t_F(gu_prev)

    def _kappa(self, parT):
        return parT[0] / (3.0 * (1.0 - 2.0 * parT[1]))

    def _f(self, s_mag, alpha, parT):
        return (s_mag - SQRT_23 * self._sigma_yield(alpha, parT)) / self._mu(parT)

    def _blend(self, path, xiT, plastic, elastic):
        w = (path == 1).to(xiT.dtype)
        return w * plastic + (1.0 - w) * elastic

    def dev_cauchy(self, xiT, gu, parT):
        """Kirchhoff's deviator mu zeta over J = det(F)."""
        zeta = t_voigt_to_sym(xiT[: self.nc], self.dim)
        return (self._mu(parT) / t_det(t_F(gu))) * zeta

    def hydro_cauchy(self, xiT, gu, parT):
        J = t_det(t_F(gu))
        return 0.5 * self._kappa(parT) * (J - 1.0 / J)


class BatchedHyperJ2(_HyperJ2Twin):
    """Twin of HyperJ2 (3D, mixed u/p): xi (8, E) = [zeta voigt (6), Ie,
    alpha]; params (8, E) = [E, nu, Y, S, D, A, n, K]."""

    name = "hyper_J2"

    def __init__(self, model):
        if model.dim != 3:
            raise NotImplementedError(
                "hyper_J2 runs in the fused assembly in 3D only (calibr8_tpu's twin is 3D); "
                "in 2D use hyper_J2_plane_strain or hyper_J2_plane_stress"
            )
        super().__init__(model)

    def _sigma_yield(self, alpha, parT):
        return _sigma_yield_power(alpha, parT)

    def _be_bar_trial(self, xipT, gu, gu_prev):
        rF = t_mm(t_F(gu), t_inv(self._F_prev(gu_prev)))
        rF_bar = rF * torch.exp(-torch.log(t_det(rF)) / 3.0)
        zeta_old = t_voigt_to_sym(xipT[:6], 3)
        return t_mm(t_mm(rF_bar, t_add_diag(zeta_old, xipT[6])), t_transpose(rF_bar))

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        be_tr = self._be_bar_trial(xipT, gu, gu_prev)
        return torch.cat([t_sym_to_voigt(t_dev3(be_tr), 3), (t_trace(be_tr) / 3.0)[None],
                          xipT[7][None]])

    def pathfn(self, xiT, xipT, gu, parT, gu_prev=None):
        mu = self._mu(parT)
        f = self._f(t_norm(mu * t_voigt_to_sym(xiT[:6], 3)), xiT[7], parT)
        return (f >= -self.abs_tol).to(torch.int32)

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
        """Branchwise C (hyper_J2.cpp evaluate)."""
        mu = self._mu(parT)
        zeta = t_voigt_to_sym(xiT[:6], 3)
        Ie, alpha, alpha_old = xiT[6], xiT[7], xipT[7]
        be_tr = self._be_bar_trial(xipT, gu, gu_prev)
        s = mu * zeta
        s_mag = t_norm(s)
        f = self._f(s_mag, alpha, parT)
        dgam = SQRT_32 * (alpha - alpha_old)
        dev_tr = t_dev3(be_tr)
        R_z = self._blend(path, xiT, zeta - dev_tr + (2.0 * dgam * Ie) * (s / s_mag), zeta - dev_tr)
        R_Ie = self._blend(path, xiT, t_det(t_add_diag(zeta, Ie)) - 1.0, Ie - t_trace(be_tr) / 3.0)
        R_a = self._blend(path, xiT, f, alpha - alpha_old)
        return torch.cat([t_sym_to_voigt(R_z, 3), R_Ie[None], R_a[None]])


class _HyperJ22D(_HyperJ2Twin):
    """The plane variants: zeta in plane, zeta_zz = -tr(zeta)."""

    def _zeta3(self, xiT):
        zeta = t_voigt_to_sym(xiT[:3], 2)
        return t_embed3(zeta, -t_trace(zeta))

    def _trial(self, be3):
        """(zeta_tr (2, 2, E), Ie_tr) of a trial be_bar (3, 3, E)."""
        Ie_tr = t_trace(be3) / 3.0
        zeta_tr = torch.stack([torch.stack([be3[0, 0] - Ie_tr, be3[0, 1]]),
                               torch.stack([be3[1, 0], be3[1, 1] - Ie_tr])])
        return zeta_tr, Ie_tr

    def pathfn(self, xiT, xipT, gu, parT, gu_prev=None):
        s_mag = t_norm(self._mu(parT) * self._zeta3(xiT))
        f = self._f(s_mag, xiT[self.alpha_idx], parT)
        return (f >= -self.abs_tol).to(torch.int32)

    def _plastic_rows(self, xiT, xipT, parT, path, zeta_tr, Ie_tr):
        """The blended zeta, Ie and alpha rows."""
        mu = self._mu(parT)
        zeta = t_voigt_to_sym(xiT[:3], 2)
        Ie = xiT[3]
        alpha, alpha_old = xiT[self.alpha_idx], xipT[self.alpha_idx]
        zeta3 = self._zeta3(xiT)
        s_mag = t_norm(mu * zeta3)
        f = self._f(s_mag, alpha, parT)
        n2 = (mu / s_mag) * zeta
        dgam = SQRT_32 * (alpha - alpha_old)
        R_z = self._blend(path, xiT, zeta - zeta_tr + (2.0 * dgam * Ie) * n2, zeta - zeta_tr)
        R_Ie = self._blend(path, xiT, t_det(t_add_diag(zeta3, Ie)) - 1.0, Ie - Ie_tr)
        R_a = self._blend(path, xiT, f, alpha - alpha_old)
        return t_sym_to_voigt(R_z, 2), R_Ie, R_a


class BatchedHyperJ2PlaneStrain(_HyperJ22D):
    """Twin of HyperJ2PlaneStrain (2D, mixed u/p): xi (5, E) = [zeta voigt
    (3), Ie, alpha]; params (6, E) = [E, nu, K, Y, Y_inf, delta]."""

    name = "hyper_J2_plane_strain"
    alpha_idx = 4

    def _sigma_yield(self, alpha, parT):
        K, Y, Y_inf, delta = (parT[i] for i in range(2, 6))
        return Y + K * alpha + (Y_inf - Y) * (1.0 - torch.exp(-delta * alpha))

    def _be_bar_3d(self, xipT, gu, gu_prev):
        """(hyper_J2_plane_strain.cpp eval_be_bar_plane_strain)"""
        rF = t_mm(t_F(gu), t_inv(self._F_prev(gu_prev)))
        c = torch.exp(torch.log(t_det(rF)) / 3.0)
        rF_bar = rF / c
        zeta_old = t_voigt_to_sym(xipT[:3], 2)
        Ie_old = xipT[3]
        be2 = t_mm(t_mm(rF_bar, t_add_diag(zeta_old, Ie_old)), t_transpose(rF_bar))
        return t_embed3(be2, (-t_trace(zeta_old) + Ie_old) / (c * c))

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        zeta_tr, Ie_tr = self._trial(self._be_bar_3d(xipT, gu, gu_prev))
        return torch.cat([t_sym_to_voigt(zeta_tr, 2), Ie_tr[None], xipT[4][None]])

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
        zeta_tr, Ie_tr = self._trial(self._be_bar_3d(xipT, gu, gu_prev))
        R_z, R_Ie, R_a = self._plastic_rows(xiT, xipT, parT, path, zeta_tr, Ie_tr)
        return torch.cat([R_z, R_Ie[None], R_a[None]])


class BatchedHyperJ2PlaneStress(_HyperJ22D):
    """Twin of HyperJ2PlaneStress (2D, displacement only, under
    'mechanics_plane_stress'): the out-of-plane stretch lambda_z is local
    state enforcing sigma_zz = 0, and the rows are z_stretch sigma cof(F).
    xi (6, E) = [zeta voigt (3), Ie, lambda_z, alpha]; params (8, E) =
    [E, nu, Y, S, D, A, n, K]."""

    name = "hyper_J2_plane_stress"
    plane_stress = True
    z_stretch_idx = 4
    alpha_idx = 5
    newton_iters = 20

    def _sigma_yield(self, alpha, parT):
        return _sigma_yield_power(alpha, parT)

    def _be_bar_3d(self, xipT, gu, gu_prev, lam_z):
        """(hyper_J2_plane_stress.cpp eval_be_bar_plane_stress) with the
        current lambda_z in F3 and the previous one in Fp3."""
        F3 = t_embed3(t_F(gu), lam_z)
        Fp3 = t_embed3(self._F_prev(gu_prev), xipT[4])
        rF = t_mm(F3, t_inv(Fp3))
        rF_bar = rF * torch.exp(-torch.log(t_det(rF)) / 3.0)
        zeta_old = t_voigt_to_sym(xipT[:3], 2)
        zeta3 = t_embed3(zeta_old, -t_trace(zeta_old))
        return t_mm(t_mm(rF_bar, t_add_diag(zeta3, xipT[3])), t_transpose(rF_bar))

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        zeta_tr, Ie_tr = self._trial(self._be_bar_3d(xipT, gu, gu_prev, xipT[4]))
        return torch.cat([t_sym_to_voigt(zeta_tr, 2), Ie_tr[None], xipT[4:6]])

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
        mu = self._mu(parT)
        lam_z = xiT[4]
        zeta_tr, Ie_tr = self._trial(self._be_bar_3d(xipT, gu, gu_prev, lam_z))
        R_z, R_Ie, R_a = self._plastic_rows(xiT, xipT, parT, path, zeta_tr, Ie_tr)
        # the plane-stress constraint on the out-of-plane stretch
        zeta_zz = -t_trace(t_voigt_to_sym(xiT[:3], 2))
        J_2D = t_det(t_F(gu))
        q = (1.0 - zeta_zz / (self._kappa(parT) / (2.0 * mu))) / (J_2D * J_2D)
        R_lam = lam_z - torch.sqrt(torch.maximum(q, torch.full_like(q, 1e-30)))
        return torch.cat([R_z, R_Ie[None], R_lam[None], R_a[None]])

    def cauchy(self, xiT, gu, parT, pT=None):
        """The full in-plane Cauchy stress, J = det(F) lambda_z."""
        zeta = t_voigt_to_sym(xiT[:3], 2)
        J = t_det(t_F(gu)) * xiT[4]
        return t_add_diag((self._mu(parT) / J) * zeta, 0.5 * self._kappa(parT) * (J - 1.0 / J))


class BatchedHybridHyperJ2PlaneStress(BatchedHyperJ2PlaneStress):
    """Twin of HybridHyperJ2PlaneStress (calibr8_tpu models/batched.py:
    1956-2011): the hyper_J2_plane_stress twin with the hardening curve
    replaced by the embedded feed-forward network, sigma_yield(alpha) = Y +
    out_scale (NN(in_scale alpha) - NN(0)).  params (3 + n_nn, E) = [E, nu,
    Y, network weights in FFNN's flat packing]: the parent twin reads
    parT[0:2] (mu, kappa) and, through _sigma_yield alone, the rest, so
    rows 3 and up are the network's here.  The forward pass runs per unit
    over lane vectors, its sums in index order, as calibr8_tpu's does."""

    name = "hybrid_hyper_J2_plane_stress"

    def __init__(self, model):
        super().__init__(model)
        self.nn = model.nn
        self.n_base = len(model.base_param_names)
        self.in_scale = model.nn_input_scale
        self.out_scale = model.nn_output_scale

    def _nn_eval(self, x, parT):
        """The network over lane vectors, x (E,) -> (E,), the weights rows
        of parT."""
        act, idx, h = self.nn.act, self.n_base, [x]
        n_layers = len(self.nn.shapes)
        for li, (r, c) in enumerate(self.nn.shapes):
            W = parT[idx:idx + r * c]
            b = parT[idx + r * c:idx + r * c + r]
            idx += r * c + r
            out = []
            for i in range(r):
                acc = W[i * c] * h[0] + b[i]
                for j in range(1, c):
                    acc = acc + W[i * c + j] * h[j]
                out.append(acc if li == n_layers - 1 else act(acc))
            h = out
        return h[0]

    def _sigma_yield(self, alpha, parT):
        dnn = self._nn_eval(self.in_scale * alpha, parT) - self._nn_eval(torch.zeros_like(alpha),
                                                                          parT)
        return parT[2] + self.out_scale * dnn


def t_polar(F, iters: int = 6):
    """The rotation R of F = R U by Higham's scaled Newton iteration,
    R <- (s R + R^-T / s) / 2 with s = |det R|^(-1/d) (calibr8_tpu
    models/batched.py:677-693): 6 iterations, the scale written exp(-log(|det
    R| + 1e-300) / d) (0 in float32, as there) and set to 1 where it is not
    finite.  R^-T = cof(R) / det(R)."""
    d = F.shape[0]
    R = F
    for _ in range(iters):
        det = t_det(R)
        s = torch.exp(-torch.log(torch.abs(det) + 1e-300) / d)
        s = torch.where(torch.isfinite(s), s, torch.ones_like(s))
        R = 0.5 * (s * R + (t_cof(R) / det) / s)
    return R


def t_unrotated_rate(gu, gu_prev):
    """(d, R): d = R^T sym((F - F_prev) F^-1) R, R = t_polar(F)
    (hypo_kinematics.hpp:10-17; calibr8_tpu models/batched.py:696-704)."""
    F = t_F(gu)
    L = t_mm(F - t_F(gu_prev), t_inv(F))
    R = t_polar(F)
    return t_mm(t_mm(t_transpose(R), t_sym(L)), R), R


class _HypoTwin(_ImplicitTwin):
    """Shared pieces of the hypo_hill family (calibr8_tpu models/batched.py:
    707-822, 1038-1157, 1290-1393): the unrotated Cauchy stress TC is
    updated by the unrotated rate d (t_unrotated_rate), which reads
    grad_u_prev and does not depend on xi.  So the twin splits its residual
    in two: precompute (d) and residual_aux (C given d); implicit_newton
    forms d once per call, and residual (the condensation's and the
    adjoint's C) forms it from its arguments.  The stress is rotated back
    by the polar factor of the current F, so it depends on grad_u through
    R.  Hill yield with Voce hardening; branches blend as w a + (1 - w) b."""

    finite_deformation = True
    newton_iters = 20

    def _lam(self, parT):
        Em, nu = parT[0], parT[1]
        return Em * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    def _rate(self, gu, gu_prev):
        if gu_prev is None:
            raise ValueError(f"{self.name!r} reads grad_u_prev: pass the previous step's state")
        d, _ = t_unrotated_rate(gu, gu_prev)
        return d

    def precompute(self, gu, parT, gu_prev=None):
        return self._rate(gu, gu_prev)

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
        return self.residual_aux(xiT, xipT, self.precompute(gu, parT, gu_prev), parT, path)

    def pathfn(self, xiT, xipT, gu, parT, gu_prev=None):
        f, _ = self._f_and_n(xiT, parT)
        return (f >= -self.abs_tol).to(torch.int32)

    def _rotated(self, xiT, gu):
        """R TC R^T, R the polar factor of F."""
        R = t_polar(t_F(gu))
        return t_mm(t_mm(R, t_voigt_to_sym(xiT[: self.nc], self.dim)), t_transpose(R))

    def hydro_cauchy(self, xiT, gu, parT):
        return self._hydro(self._rotated(xiT, gu), xiT)

    def cauchy(self, xiT, gu, parT, pT):
        RC = self._rotated(xiT, gu)
        return t_sub_diag(RC, self._hydro(RC, xiT) + pT)


class BatchedHypoHill(_HypoTwin):
    """Twin of HypoHill (3D, mixed u/p), residual scaled by 1/mu
    (hypo_hill.cpp:266-268): xi (7, E) = [TC voigt (6), alpha]; params
    (11, E) = [E, nu, Y, R00, R11, R22, R01, R02, R12, S, D]."""

    name = "hypo_hill"

    def _voce(self, alpha, parT):
        Y, S, D = parT[2], parT[9], parT[10]
        return Y + S * (1.0 - torch.exp(-D * alpha))

    def _elastic_update(self, TC_old, d, parT):
        return t_add_diag(TC_old + 2.0 * self._mu(parT) * d, self._lam(parT) * t_trace(d))

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        TC = self._elastic_update(t_voigt_to_sym(xipT[:6], 3), self._rate(gu, gu_prev), parT)
        return torch.cat([t_sym_to_voigt(TC, 3), xipT[6][None]])

    def _f_and_n(self, xiT, parT):
        TC = t_voigt_to_sym(xiT[:6], 3)
        hp = t_hill_params(parT, 3)
        hval = t_hill_value(TC, hp)
        f = (hval - self._voce(xiT[6], parT)) / self._mu(parT)
        return f, t_hill_normal(TC, hp, hval)

    def residual_aux(self, xiT, xipT, d, parT, path):
        mu = self._mu(parT)
        TC = t_voigt_to_sym(xiT[:6], 3)
        alpha, alpha_old = xiT[6], xipT[6]
        R_TC = (TC - self._elastic_update(t_voigt_to_sym(xipT[:6], 3), d, parT)) / mu
        f, n = self._f_and_n(xiT, parT)
        w = (path == 1).to(xiT.dtype)
        R_out = R_TC + (w * 2.0 * (alpha - alpha_old)) * n
        R_a = w * f + (1.0 - w) * (alpha - alpha_old)
        return torch.cat([t_sym_to_voigt(R_out, 3), R_a[None]])

    def _hydro(self, RC, xiT):
        return t_trace(RC) / 3.0


class BatchedHypoHillPlaneStrain(_HypoTwin):
    """Twin of HypoHillPlaneStrain (2D, mixed u/p): the in-plane rotation,
    TC_zz as local state.  xi (5, E) = [TC voigt (3), alpha, TC_zz]; params
    (9, E) = [E, nu, Y, S, D, R00, R11, R22, R01]."""

    name = "hypo_hill_plane_strain"

    def _voce(self, alpha, parT):
        Y, S, D = parT[2], parT[3], parT[4]
        return Y + S * (1.0 - torch.exp(-D * alpha))

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        lam, mu = self._lam(parT), self._mu(parT)
        d = self.precompute(gu, parT, gu_prev)
        TC = t_add_diag(t_voigt_to_sym(xipT[:3], 2) + 2.0 * mu * d, lam * t_trace(d))
        TC_zz = xipT[4] + lam * t_trace(d)
        return torch.cat([t_sym_to_voigt(TC, 2), xipT[3][None], TC_zz[None]])

    def _zz(self, xiT):
        """The out-of-plane component of Hill's argument."""
        return xiT[4]

    def _f_and_n(self, xiT, parT):
        TC3 = t_embed3(t_voigt_to_sym(xiT[:3], 2), self._zz(xiT))
        hp = t_hill_params_2d(parT, 5)
        hval = t_hill_value(TC3, hp)
        f = (hval - self._voce(xiT[3], parT)) / self._mu(parT)
        return f, t_in_plane(t_hill_normal(TC3, hp, hval))

    def residual_aux(self, xiT, xipT, d, parT, path):
        lam, mu = self._lam(parT), self._mu(parT)
        TC = t_voigt_to_sym(xiT[:3], 2)
        alpha, alpha_old = xiT[3], xipT[3]
        R_TC = t_sub_diag(TC - t_voigt_to_sym(xipT[:3], 2) - 2.0 * mu * d, lam * t_trace(d))
        R_zz = xiT[4] - xipT[4] - lam * t_trace(d)
        f, n2 = self._f_and_n(xiT, parT)
        dp2 = (alpha - alpha_old) * n2
        w = (path == 1).to(xiT.dtype)
        R_out = R_TC + (w * 2.0 * mu) * dp2
        R_zz_out = R_zz + w * 2.0 * mu * -t_trace(dp2)
        R_a = w * f + (1.0 - w) * (alpha - alpha_old)
        return torch.cat([t_sym_to_voigt(R_out, 2), R_a[None], R_zz_out[None]])

    def _hydro(self, RC, xiT):
        return (t_trace(RC) + xiT[4]) / 3.0


class BatchedHypoHillPlaneStress(BatchedHypoHillPlaneStrain):
    """Twin of HypoHillPlaneStress (2D, displacement only, under
    'mechanics_plane_stress'): a material rotation Q in the rate (Q^T d Q)
    and the stress (R Q TC Q^T R^T), lambda_z = lambda_z_old / (1 - (d_zz +
    corr)).  xi (5, E) = [TC voigt (3), alpha, lambda_z]; params (13, E) =
    [E, nu, Y, S, D, R00, R11, R22, R01, Q00, Q01, Q10, Q11]."""

    name = "hypo_hill_plane_stress"
    plane_stress = True
    z_stretch_idx = 4

    def _Q(self, parT):
        return torch.stack([torch.stack([parT[9], parT[10]]), torch.stack([parT[11], parT[12]])])

    def precompute(self, gu, parT, gu_prev=None):
        Q = self._Q(parT)
        return t_mm(t_mm(t_transpose(Q), self._rate(gu, gu_prev)), Q)

    def first_guess(self, xipT, gu, parT, gu_prev=None):
        lam, mu = self._lam(parT), self._mu(parT)
        d = self.precompute(gu, parT, gu_prev)
        d_zz = -lam * t_trace(d) / (lam + 2.0 * mu)
        TC = t_add_diag(t_voigt_to_sym(xipT[:3], 2) + 2.0 * mu * d, lam * (t_trace(d) + d_zz))
        lam_z = xipT[4] / (1.0 - d_zz)
        return torch.cat([t_sym_to_voigt(TC, 2), xipT[3][None], lam_z[None]])

    def _zz(self, xiT):
        return None

    def residual_aux(self, xiT, xipT, d, parT, path):
        lam, mu = self._lam(parT), self._mu(parT)
        TC = t_voigt_to_sym(xiT[:3], 2)
        alpha, alpha_old = xiT[3], xipT[3]
        lam_z, lam_z_old = xiT[4], xipT[4]
        d_zz = -lam * t_trace(d) / (lam + 2.0 * mu)
        R_TC = t_sub_diag(TC - t_voigt_to_sym(xipT[:3], 2) - 2.0 * mu * d,
                          lam * (t_trace(d) + d_zz))
        f, n2 = self._f_and_n(xiT, parT)
        dp2 = (alpha - alpha_old) * n2
        corr = 2.0 * mu * -t_trace(dp2) / (2.0 * mu + lam)
        w = (path == 1).to(xiT.dtype)
        # plastic in-plane rows: + 2 mu dp2 - lam corr on the diagonal, all
        # over mu (hypo_hill_plane_stress.cpp:325)
        R_p = t_sub_diag(R_TC + 2.0 * mu * dp2, lam * corr) / mu
        R_TC_out = w * R_p + (1.0 - w) * R_TC
        R_lam = (w * (lam_z - lam_z_old / (1.0 - (d_zz + corr)))
                 + (1.0 - w) * (lam_z - lam_z_old / (1.0 - d_zz)))
        R_a = w * f + (1.0 - w) * (alpha - alpha_old)
        return torch.cat([t_sym_to_voigt(R_TC_out, 2), R_a[None], R_lam[None]])

    def cauchy(self, xiT, gu, parT, pT=None):
        """The full in-plane Cauchy stress R Q TC Q^T R^T."""
        RQ = t_mm(t_polar(t_F(gu)), self._Q(parT))
        return t_mm(t_mm(RQ, t_voigt_to_sym(xiT[:3], 2)), t_transpose(RQ))

    def hydro_cauchy(self, xiT, gu, parT):
        return t_trace(self.cauchy(xiT, gu, parT)) / 3.0

    def pressure_scale_factor(self, parT):
        return torch.zeros_like(parT[0])


def t_outer(v):
    """(3, E) -> v v^T (3, 3, E)."""
    return torch.stack([torch.stack([v[i] * v[j] for j in range(3)]) for i in range(3)])


def t_powa(x, e, tiny=1e-300):
    """|x|^e with a per-lane exponent, written exp(e log(|x| + tiny)) as
    calibr8_tpu writes it (tiny is 0 in float32, as there)."""
    return torch.exp(e * torch.log(torch.abs(x) + tiny))


def t_clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi) = min(max(x, lo), hi), with JAX's tangent: half
    of it at a tie with either bound (torch.clamp would pass all of it)."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _mm_unrolled(A, B):
    """(3, 3, E) @ (3, 3, E), each entry summed in k order, as calibr8_tpu's
    t_mm and c8::mat_mul sum it: the eigenvector's column pick compares
    the entries' norms."""
    return torch.stack([torch.stack([A[i, 0] * B[0, j] + A[i, 1] * B[1, j] + A[i, 2] * B[2, j]
                                     for j in range(3)]) for i in range(3)])


def t_eig_sym33(A, eps=1e-12):
    """Eigenvalues (descending) and eigenvectors of a symmetric (3, 3, E):
    ((lam0, lam1, lam2), (v0, v1, v2)), each (E,) / (3, E) (calibr8_tpu
    models/batched.py:1618-1667).  The closed trigonometric form: r =
    det(B / p) / 2 clipped to [-1 + 1e-14, 1 - 1e-14] (a zero tangent
    where the clip is active, half at a tie), phi = acos(r) / 3.  Each
    eigenvector is the largest column of (A - lam_j I)(A - lam_k I),
    picked branchlessly (strict >: the first of equal norms), e0 where
    that column's norm is <= 1e3 eps; v1 is orthogonalized against v0 and
    v2 = v0 x v1.  calibr8_tpu computes acos by a polynomial with two
    Newton corrections (t_acos, for Mosaic); the port calls torch.acos,
    whose value agrees within 1e-13 and whose tangent is -1 / sqrt(1 -
    r^2)."""
    q = t_trace(A) / 3.0
    B = t_sub_diag(A, q)
    p2 = usum(usum(B * B, 0), 0) / 6.0
    p = torch.sqrt(p2 + eps * eps)
    Bn = B / p
    r = t_clip(t_det(Bn) / 2.0, -1.0 + 1e-14, 1.0 - 1e-14)
    phi = torch.acos(r) / 3.0
    lam0 = q + 2.0 * p * torch.cos(phi)
    lam2 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)
    lam1 = 3.0 * q - lam0 - lam2

    def vec(lam_j, lam_k):
        M = _mm_unrolled(t_sub_diag(A, lam_j), t_sub_diag(A, lam_k))
        cols = [M[:, m] for m in range(3)]
        norms = [usum(c * c, 0) for c in cols]
        # arithmetic blends, as calibr8_tpu writes its selects
        pick1 = (norms[1] > norms[0]).to(A.dtype)
        va = pick1 * cols[1] + (1.0 - pick1) * cols[0]
        na = pick1 * norms[1] + (1.0 - pick1) * norms[0]
        pick2 = (norms[2] > na).to(A.dtype)
        v = pick2 * cols[2] + (1.0 - pick2) * va
        nmax = pick2 * norms[2] + (1.0 - pick2) * na
        ok = (torch.sqrt(nmax) > 1e3 * eps).to(A.dtype)
        one, zero = torch.ones_like(v[0]), torch.zeros_like(v[0])
        v = ok * v + (1.0 - ok) * torch.stack([one, zero, zero])
        return v / torch.sqrt(usum(v * v, 0) + eps * eps)

    v0 = vec(lam1, lam2)
    v1r = vec(lam2, lam0)
    v1r = v1r - usum(v1r * v0, 0) * v0
    v1 = v1r / torch.sqrt(usum(v1r * v1r, 0) + eps * eps)
    v2 = torch.stack([v0[1] * v1[2] - v0[2] * v1[1],
                      v0[2] * v1[0] - v0[0] * v1[2],
                      v0[0] * v1[1] - v0[1] * v1[0]])
    return (lam0, lam1, lam2), (v0, v1, v2)


def _phi_from_total(vm, total, a, eps):
    return vm * torch.exp(torch.log(torch.maximum(total, torch.full_like(total, eps))) / a)


def t_hosford_phi_n(sigma, dev_sigma, a, eps=1e-30):
    """Hosford's effective stress phi and flow normal n (calibr8_tpu
    models/batched.py:1670-1695; reference small_hosford.cpp:226-266):
    phi = vm (sum_ij |l_i - l_j|^a / 2)^(1/a) over the eigenvalue
    differences of sigma scaled by vm = sqrt(3/2 |dev|^2), each clipped
    to [-4, 4]; n = sum_i c_i v_i v_i^T."""
    vm = torch.sqrt(1.5 * usum(usum(dev_sigma * dev_sigma, 0), 0) + eps)
    (l0, l1, l2), (v0, v1, v2) = t_eig_sym33(sigma)
    sl0, sl1, sl2 = l0 / vm, l1 / vm, l2 / vm
    d01 = t_clip(sl0 - sl1, -4.0, 4.0)
    d12 = t_clip(sl1 - sl2, -4.0, 4.0)
    d20 = t_clip(sl2 - sl0, -4.0, 4.0)
    total = 0.5 * (t_powa(d01, a) + t_powa(d12, a) + t_powa(d20, a))
    phi = _phi_from_total(vm, total, a, eps)
    ps = torch.maximum(phi, torch.full_like(phi, eps))
    p01 = t_clip(l0 / ps - l1 / ps, -4.0, 4.0)
    p12 = t_clip(l1 / ps - l2 / ps, -4.0, 4.0)
    p20 = t_clip(l2 / ps - l0 / ps, -4.0, 4.0)
    f01 = p01 * t_powa(p01, a - 2.0)
    f12 = p12 * t_powa(p12, a - 2.0)
    f20 = p20 * t_powa(p20, a - 2.0)
    n = 0.5 * ((f01 - f20) * t_outer(v0) + (f12 - f01) * t_outer(v1)
               + (f20 - f12) * t_outer(v2))
    return phi, n


def t_flatten_stress(s):
    """(3, 3, E) -> the 6 components [00, 11, 22, 01, 12, 20]."""
    return (s[0, 0], s[1, 1], s[2, 2], s[0, 1], s[1, 2], s[2, 0])


def t_unflatten_stress(v):
    return torch.stack([torch.stack([v[0], v[3], v[5]]), torch.stack([v[3], v[1], v[4]]),
                        torch.stack([v[5], v[4], v[2]])])


def t_barlat_L_apply(p, s):
    """The Yld2004-18p linear transform of a flattened stress; p = the 9
    coefficients [c01, c02, c10, c12, c20, c21, c33, c44, c55]."""
    p01, p02, p10, p12, p20, p21, p33, p44, p55 = p
    s0, s1, s2, s3, s4, s5 = s
    o0 = ((p01 + p02) * s0 + (-2.0 * p01 + p02) * s1 + (p01 - 2.0 * p02) * s2) / 3.0
    o1 = ((-2.0 * p10 + p12) * s0 + (p10 + p12) * s1 + (p10 - 2.0 * p12) * s2) / 3.0
    o2 = ((-2.0 * p20 + p21) * s0 + (p20 - 2.0 * p21) * s1 + (p20 + p21) * s2) / 3.0
    return (o0, o1, o2, p33 * s3, p44 * s4, p55 * s5)


def t_barlat_phi_n(TC, sp, dp, a, eps=1e-30):
    """Barlat Yld2004-18p effective stress and flow normal (calibr8_tpu
    models/batched.py:1722-1765; reference yield_functions.hpp:104-330):
    the eigenvalues s_i, d_j of the two transformed stresses L'(TC),
    L''(TC); phi = vm (sum_ij |s_i - d_j|^a / 4)^(1/a) over differences
    scaled by vm and clipped to [-8, 8]; n = L'^T(sum_i c'_i v'_i v'_i^T)
    + L''^T(sum_j c''_j v''_j v''_j^T)."""
    dev = t_dev3(TC)
    vm = torch.sqrt(1.5 * usum(usum(dev * dev, 0), 0) + eps)
    flat = t_flatten_stress(TC)
    s_lam, s_V = t_eig_sym33(t_unflatten_stress(t_barlat_L_apply(sp, flat)))
    d_lam, d_V = t_eig_sym33(t_unflatten_stress(t_barlat_L_apply(dp, flat)))
    total = None
    for i in range(3):
        for j in range(3):
            term = t_powa(t_clip(s_lam[i] / vm - d_lam[j] / vm, -8.0, 8.0), a)
            total = term if total is None else total + term
    phi = _phi_from_total(vm, 0.25 * total, a, eps)
    ps = torch.maximum(phi, torch.full_like(phi, eps))
    fac = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            dm = t_clip(s_lam[i] / ps - d_lam[j] / ps, -8.0, 8.0)
            fac[i][j] = dm * t_powa(dm, a - 2.0)
    sp_n = dp_n = None
    for i in range(3):
        so = (0.25 * (fac[i][0] + fac[i][1] + fac[i][2])) * t_outer(s_V[i])
        do = (-0.25 * (fac[0][i] + fac[1][i] + fac[2][i])) * t_outer(d_V[i])
        sp_n = so if sp_n is None else sp_n + so
        dp_n = do if dp_n is None else dp_n + do
    out = tuple(x + y for x, y in zip(t_barlat_L_apply(sp, t_flatten_stress(sp_n)),
                                      t_barlat_L_apply(dp, t_flatten_stress(dp_n))))
    return phi, t_unflatten_stress(out)


class BatchedSmallHosford(_ImplicitTwin):
    """Twin of SmallHosford (3D, mixed u/p; calibr8_tpu models/batched.py:
    1768-1851, reference small_hosford.cpp:160-266): Hosford yield on the
    deviatoric stress, hardening Y + K a + S (1 - exp(-D a)), f scaled by
    2 mu.  Its local Newton freezes the branch at the first guess and
    takes the line search (freeze_path).  xi (7, E) = [pstrain voigt (6),
    alpha]; params (7, E) = [E, nu, Y, a, K, S, D]."""

    name = "small_hosford"
    freeze_path = True
    newton_iters = 30

    def __init__(self, model):
        if model.dim != 3:
            raise NotImplementedError("small_hosford is a 3D model (calibr8_tpu's twin is 3D)")
        super().__init__(model)

    def _flow(self, alpha, parT):
        Y, K, S, D = parT[2], parT[4], parT[5], parT[6]
        return Y + K * alpha + S * (1.0 - torch.exp(-D * alpha))

    def _f_and_n(self, xiT, gu, parT):
        # the yield is read on the deviator (calibr8_tpu small_strain.py
        # cauchy_full: pressure-insensitive through the eigen differences)
        s = self.dev_cauchy(xiT, gu, parT)
        phi, n = t_hosford_phi_n(s, s, parT[3])
        return (phi - self._flow(xiT[6], parT)) / (2.0 * self._mu(parT)), n

    def residual(self, xiT, xipT, gu, parT, path, gu_prev=None):
        ps = t_voigt_to_sym(xiT[:6], 3)
        ps_old = t_voigt_to_sym(xipT[:6], 3)
        f, n = self._f_and_n(xiT, gu, parT)
        dgam = xiT[6] - xipT[6]
        w = (path == 1).to(xiT.dtype)
        R_s = (ps - ps_old) - (w * dgam) * n
        R_a = w * f + (1.0 - w) * dgam
        return torch.cat([t_sym_to_voigt(R_s, 3), R_a[None]])


class BatchedHypoHosford(BatchedHypoHill):
    """Twin of HypoHosford (3D, mixed u/p; calibr8_tpu models/batched.py:
    1854-1901, reference hypo_hosford.cpp): Hosford yield on the unrotated
    stress TC, hardening Y + S (1 - exp(-D a)) (K unused, as there),
    residual scaled by 1 / (2 mu), the frozen branch and the line search;
    the hypo kinematics of BatchedHypoHill.  xi (7, E) = [TC voigt (6),
    alpha]; params (7, E) = [E, nu, Y, a, K, S, D]."""

    name = "hypo_hosford"
    freeze_path = True
    newton_iters = 30

    def __init__(self, model):
        if model.dim != 3:
            raise NotImplementedError(f"{model.name} is a 3D model (calibr8_tpu's twin is 3D)")
        super().__init__(model)

    def _flow(self, alpha, parT):
        Y, S, D = parT[2], parT[5], parT[6]
        return Y + S * (1.0 - torch.exp(-D * alpha))

    def _phi_n(self, TC, parT):
        return t_hosford_phi_n(TC, t_dev3(TC), parT[3])

    def _f_and_n(self, xiT, parT):
        phi, n = self._phi_n(t_voigt_to_sym(xiT[:6], 3), parT)
        return (phi - self._flow(xiT[6], parT)) / (2.0 * self._mu(parT)), n

    def residual_aux(self, xiT, xipT, d, parT, path):
        TC = t_voigt_to_sym(xiT[:6], 3)
        R_TC = (TC - self._elastic_update(t_voigt_to_sym(xipT[:6], 3), d, parT)) / (
            2.0 * self._mu(parT))
        f, n = self._f_and_n(xiT, parT)
        dgam = xiT[6] - xipT[6]
        w = (path == 1).to(xiT.dtype)
        R_a = w * f + (1.0 - w) * dgam
        return torch.cat([t_sym_to_voigt(R_TC + (w * dgam) * n, 3), R_a[None]])


class BatchedHypoBarlat(BatchedHypoHosford):
    """Twin of HypoBarlat (3D, mixed u/p; calibr8_tpu models/batched.py:
    1904-1953, reference hypo_barlat.cpp): Barlat Yld2004-18p yield on TC
    (two linear transforms and two eigendecompositions per evaluation),
    hardening Y + K a + S (1 - exp(-D a)).  xi (7, E); params (25, E) =
    [E, nu, Y, a, K, S, D, sp_* (9), dp_* (9)]."""

    name = "hypo_barlat"

    def _flow(self, alpha, parT):
        Y, K, S, D = parT[2], parT[4], parT[5], parT[6]
        return Y + K * alpha + S * (1.0 - torch.exp(-D * alpha))

    def _phi_n(self, TC, parT):
        return t_barlat_phi_n(TC, tuple(parT[7 + k] for k in range(9)),
                              tuple(parT[16 + k] for k in range(9)), parT[3])


def implicit_newton(bm, xipT, gu, parT, gu_prev=None, iters=None, trials=None):
    """The fixed-iteration local Newton of the implicit twins, per lane
    (calibr8_tpu models/batched.py:561-671).  It starts from the twin's
    first_guess (xi_prev, or the finite-deformation twins' elastic trial
    state, batched.py:582).  A twin with `precompute` (the hypo family)
    has its xi-independent kinematics formed once per call and its
    residual read through residual_aux (batched.py:594-603).  Each
    iteration takes the branch from the current xi, or, for a twin with
    `freeze_path` (the Hosford / Barlat family), the branch chosen once at
    the first guess, which is also the path returned; it marks a lane
    done once ||C|| < abs_tol (before its update), and adds the step
    times (1 - done) * all(isfinite(dxi)).  The frozen-branch twins also
    take the line search (calibr8_tpu's `local_line_search` defaults to
    `freeze_path`, and no twin sets it; batched.py:586, 621-647): the
    step is alpha dxi: four trials at xi + alpha ok dxi, alpha halved
    until one has 1/2 ||C||^2 <= phi0 (1 - 2e-4 alpha) with every C
    finite, phi0 = 1/2 ||C(xi)||^2, and kept from then on (1/16 if none
    was accepted).  The loop ends after newton_iters iterations or when
    every lane is done.  Returns (xiT, path, failed), path and failed (E,)
    int32, failed where ||C(xi)|| >= max(10 abs_tol, 1e-30) at the end.
    With `iters` an (E,) int32 tensor, each lane's number of iterations
    before it was done (the CUDA kernel's count) is written there; with
    `trials` one, each lane's line-search trials up to the accepted one
    (all four where none was) over those iterations: the trials that the
    sequential search needs, which the operations bound of the CUDA
    kernel counts."""
    nxi = bm.nxi
    xi = bm.first_guess(xipT, gu, parT, gu_prev)
    dtype, E = xi.dtype, xi.shape[-1]
    if hasattr(bm, "precompute"):
        aux = bm.precompute(gu, parT, gu_prev)

        def resid(z, path):
            return bm.residual_aux(z, xipT, aux, parT, path)
    else:
        def resid(z, path):
            return bm.residual(z, xipT, gu, parT, path, gu_prev)

    freeze = getattr(bm, "freeze_path", False)
    path0 = bm.pathfn(xi, xipT, gu, parT, gu_prev) if freeze else None
    done = torch.zeros(E, dtype=torch.int32, device=xi.device)
    count = torch.zeros_like(done)
    n_trials = torch.zeros_like(done)
    for _ in range(bm.newton_iters):
        if bool(done.min() >= 1):
            break
        path = path0 if freeze else bm.pathfn(xi, xipT, gu, parT, gu_prev)
        R, cols = jvp_columns(lambda z: resid(z, path), xi)
        rnorm = torch.sqrt(usum(R * R, 0))
        done = torch.maximum(done, (rnorm < bm.abs_tol).to(torch.int32))
        count += 1 - done
        J = cols.permute(1, 0, 2)  # J[i, k] = dC_i / dxi_k
        dxi = gauss_solve_T(J, -R[:, None, :])[:, 0, :]
        fin = torch.isfinite(dxi).to(dtype)
        ok = fin[0]
        for k in range(1, nxi):
            ok = ok * fin[k]
        if freeze:
            phi0 = 0.5 * rnorm * rnorm
            alpha = torch.ones(E, dtype=dtype, device=xi.device)
            accepted = torch.zeros_like(done)
            for _ in range(4):
                if trials is not None:
                    n_trials += (1 - done) * (1 - accepted)
                Rt = resid(xi + (alpha * ok) * dxi, path)
                phit = 0.5 * usum(Rt * Rt, 0)
                good = ((phit <= phi0 * (1.0 - 2.0 * 1e-4 * alpha))
                        & torch.isfinite(Rt).all(0)).to(torch.int32)
                keep = torch.maximum(good, accepted).to(dtype)
                alpha = keep * alpha + (1.0 - keep) * (0.5 * alpha)
                accepted = torch.maximum(accepted, good)
            dxi = alpha * dxi
        gate = (1 - done).to(dtype) * ok
        xi = xi + gate * dxi
    path = path0 if freeze else bm.pathfn(xi, xipT, gu, parT, gu_prev)
    Rf = resid(xi, path)
    rnorm = torch.sqrt(usum(Rf * Rf, 0))
    failed = (rnorm >= max(bm.abs_tol * 10.0, 1e-30)).to(torch.int32)
    if iters is not None:
        iters.copy_(count)
    if trials is not None:
        trials.copy_(n_trials)
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
    "isotropic_elastic": BatchedIsotropicElastic,
    "small_hill": BatchedSmallHill,
    "small_hill_plane_strain": BatchedSmallHillPlaneStrain,
    "small_hill_plane_stress": BatchedSmallHillPlaneStress,
    "hyper_J2": BatchedHyperJ2,
    "hyper_J2_plane_strain": BatchedHyperJ2PlaneStrain,
    "hyper_J2_plane_stress": BatchedHyperJ2PlaneStress,
    "hybrid_hyper_J2_plane_stress": BatchedHybridHyperJ2PlaneStress,
    "hypo_hill": BatchedHypoHill,
    "hypo_hill_plane_strain": BatchedHypoHillPlaneStrain,
    "hypo_hill_plane_stress": BatchedHypoHillPlaneStress,
    "small_hosford": BatchedSmallHosford,
    "hypo_hosford": BatchedHypoHosford,
    "hypo_barlat": BatchedHypoBarlat,
}

# the CUDA kernels' model index (csrc/fused_assembly.cu c8_fused_assembly
# for the analytic twins; for the implicit ones csrc/implicit_assembly.cu
# c8_implicit_assembly, ids 0-8, and, for the eigensolver twins,
# csrc/implicit_eig.cu (9, 10) and csrc/implicit_barlat.cu (11); the
# hybrid, csrc/implicit_hybrid.cu (12))
KERNEL_MODEL_ID = {
    "elastic": 0, "small_J2": 1, "isotropic_elastic": 2,
    "small_hill": 0, "small_hill_plane_strain": 1, "small_hill_plane_stress": 2,
    "hyper_J2": 3, "hyper_J2_plane_strain": 4, "hyper_J2_plane_stress": 5,
    "hypo_hill": 6, "hypo_hill_plane_strain": 7, "hypo_hill_plane_stress": 8,
    "small_hosford": 9, "hypo_hosford": 10, "hypo_barlat": 11,
    "hybrid_hyper_J2_plane_stress": 12,
}


def get_batched_model(model):
    return BATCHED_MODELS[model.name](model)
