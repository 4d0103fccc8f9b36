"""Local (constitutive) models of this slice: their metadata.

The analog of create_local_residual (reference:
source/calibr8/src/local_residual.cpp:893-935), registry strings as in
the reference decks.  The port runs each model through the fused
assembly (fem/fused_assembly.py): the CUDA kernel on the card, the
trailing-layout twin of models/batched.py on the CPU.  So a model here
carries only what the rest of the system needs to know about it: its
parameter order, the size and initial value of its local state, and its
local-solve tolerance.

Every model of calibr8_tpu's registry is here; a name outside it raises
NotImplementedError naming the port's registry.  The hybrid model takes
its network from the local residual's `embedded model` sublist (the
`config` of create_local_model), as calibr8_tpu's does.
"""

from __future__ import annotations

import numpy as np

from calibr8_tpu_torch.models.nn import FFNN


class Elastic:
    """Mixed u/p linear elasticity with the reference's 1-dof dummy local
    slot (reference: elastic.cpp:28-44)."""

    name = "elastic"
    param_names = ("E", "nu", "cte", "delta_T")

    def __init__(self, dim: int, config=None):
        self.dim = dim
        self.abs_tol = 1e-12

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    def nxi(self) -> int:
        return 1

    def init_xi(self) -> np.ndarray:
        return np.zeros(1)


class IsotropicElastic(Elastic):
    """Displacement-formulation isotropic elasticity, sigma = lambda tr(eps)
    I + 2 mu eps, with the 1-dof dummy local slot (reference:
    isotropic_elastic.cpp; calibr8_tpu models/elastic.py:68-110).  Under
    'mechanics' it runs with 'mixed formulation: false'."""

    name = "isotropic_elastic"
    param_names = ("E", "nu")


class _SmallStrainPlastic(Elastic):
    """xi = [pstrain voigt, alpha], zero at the start."""

    def nxi(self) -> int:
        return (3 if self.dim == 2 else 6) + 1

    def init_xi(self) -> np.ndarray:
        return np.zeros(self.nxi())


class SmallJ2(_SmallStrainPlastic):
    """Radial-return J2 with linear hardening sigma_y = Y + K alpha
    (reference: small_J2.cpp:186-246)."""

    name = "small_J2"
    param_names = ("E", "nu", "K", "Y", "cte", "delta_T")


class SmallHill(_SmallStrainPlastic):
    """3D Hill yield on the deviatoric stress with Voce hardening
    Y + S (1 - exp(-D alpha)); the plastic zz row is incompressibility
    (reference: small_hill.cpp:195-275).  xi = [pstrain voigt (6), alpha]."""

    name = "small_hill"
    param_names = ("E", "nu", "Y", "R00", "R11", "R22", "R01", "R02", "R12", "S", "D")


class SmallHillPlaneStrain(_SmallStrainPlastic):
    """2D mixed plane strain Hill (small_hill_plane_strain.cpp), four
    ratios (R02 = R12 = 1).  xi = [pstrain voigt (3), alpha]."""

    name = "small_hill_plane_strain"
    param_names = ("E", "nu", "Y", "S", "D", "R00", "R11", "R22", "R01")


class SmallHillPlaneStress(SmallHillPlaneStrain):
    """2D plane stress Hill (small_hill_plane_stress.cpp): displacement
    only, under 'mechanics_plane_stress'."""

    name = "small_hill_plane_stress"


class HyperJ2(Elastic):
    """Finite-deformation multiplicative J2 on the isochoric elastic left
    Cauchy-Green tensor, hardening Y + S (1 - exp(-D alpha)) + A (alpha +
    1e-12)^n + K alpha (reference: hyper_J2.cpp).  xi = [zeta voigt, Ie,
    alpha], Ie = 1 at the start."""

    name = "hyper_J2"
    param_names = ("E", "nu", "Y", "S", "D", "A", "n", "K")

    def nxi(self) -> int:
        return (3 if self.dim == 2 else 6) + 2

    def init_xi(self) -> np.ndarray:
        xi = np.zeros(self.nxi())
        xi[self.nxi() - 2] = 1.0
        return xi


class HyperJ2PlaneStrain(Elastic):
    """2D mixed plane strain (hyper_J2_plane_strain.cpp): zeta_zz =
    -tr(zeta), hardening Y + K alpha + (Y_inf - Y)(1 - exp(-delta alpha)).
    xi = [zeta voigt (3), Ie, alpha]."""

    name = "hyper_J2_plane_strain"
    param_names = ("E", "nu", "K", "Y", "Y_inf", "delta")

    def nxi(self) -> int:
        return 5

    def init_xi(self) -> np.ndarray:
        return np.array([0.0, 0.0, 0.0, 1.0, 0.0])


class HyperJ2PlaneStress(Elastic):
    """2D plane stress (hyper_J2_plane_stress.cpp), displacement only under
    'mechanics_plane_stress': the out-of-plane stretch lambda_z is local
    state.  xi = [zeta voigt (3), Ie, lambda_z, alpha]."""

    name = "hyper_J2_plane_stress"
    param_names = ("E", "nu", "Y", "S", "D", "A", "n", "K")

    def nxi(self) -> int:
        return 6

    def init_xi(self) -> np.ndarray:
        return np.array([0.0, 0.0, 0.0, 1.0, 1.0, 0.0])


class HybridHyperJ2PlaneStress(HyperJ2PlaneStress):
    """hyper_J2_plane_stress with the hardening curve replaced by an
    embedded feed-forward network (reference:
    hybrid_hyper_J2_plane_stress.cpp; calibr8_tpu models/hybrid.py),
    sigma_yield(alpha) = Y + out_scale (NN(in_scale alpha) - NN(0)).  The
    parameters are (E, nu, Y) then the network's weights nn_<i> in FFNN's
    flat packing; the deck gives the physical ones, and default_params()
    the initial weights."""

    name = "hybrid_hyper_J2_plane_stress"
    base_param_names = ("E", "nu", "Y")

    def __init__(self, dim: int, config=None):
        super().__init__(dim, config)
        cfg = (config or {}).get("embedded model", {}) or {}
        self.nn = FFNN(cfg.get("activation function", "sigmoid"),
                       list(cfg.get("topology", [1, 4, 1])),
                       positive_weights=bool(cfg.get("positive weights", False)))
        self.nn_input_scale = float(cfg.get("input scale", 1.0))
        self.nn_output_scale = float(cfg.get("output scale", 1.0))
        self.param_names = self.base_param_names + tuple(
            f"nn_{i}" for i in range(self.nn.n_params))

    def default_params(self) -> np.ndarray:
        """The initial parameter vector: physical zeros, then the network's
        initial weights."""
        p = np.zeros(len(self.param_names))
        p[len(self.base_param_names):] = self.nn.init_params
        return p


class HypoHill(_SmallStrainPlastic):
    """Hypoelastic update of the unrotated Cauchy stress TC under the
    unrotated rate d = R^T sym((F - F_prev) F^-1) R, R the polar factor of
    F, with Hill yield and Voce hardening (reference: hypo_hill.cpp).
    xi = [TC voigt (6), alpha], zero at the start."""

    name = "hypo_hill"
    param_names = SmallHill.param_names

    def __init__(self, dim: int, config=None):
        if dim != 3:
            raise ValueError("hypo_hill is a 3D model; use the plane variants in 2D")
        super().__init__(dim, config)


class HypoHillPlaneStrain(_SmallStrainPlastic):
    """2D mixed plane strain (hypo_hill_plane_strain.cpp): the in-plane
    rotation, TC_zz as local state.  xi = [TC voigt (3), alpha, TC_zz]."""

    name = "hypo_hill_plane_strain"
    param_names = SmallHillPlaneStrain.param_names

    def nxi(self) -> int:
        return 5


class HypoHillPlaneStress(HypoHillPlaneStrain):
    """2D plane stress (hypo_hill_plane_stress.cpp), displacement only under
    'mechanics_plane_stress': a material rotation Q = [[Q00, Q01], [Q10,
    Q11]] in the rate and the stress, the out-of-plane stretch lambda_z as
    local state.  xi = [TC voigt (3), alpha, lambda_z], lambda_z = 1 at the
    start."""

    name = "hypo_hill_plane_stress"
    param_names = SmallHillPlaneStrain.param_names + ("Q00", "Q01", "Q10", "Q11")

    def init_xi(self) -> np.ndarray:
        return np.array([0.0, 0.0, 0.0, 0.0, 1.0])


class SmallHosford(_SmallStrainPlastic):
    """3D Hosford yield on the deviatoric stress with combined hardening Y
    + K alpha + S (1 - exp(-D alpha)), f scaled by 2 mu; the local Newton
    keeps the branch of its first guess and takes a line search
    (reference: small_hosford.cpp:160-266).  xi = [pstrain voigt (6),
    alpha]."""

    name = "small_hosford"
    param_names = ("E", "nu", "Y", "a", "K", "S", "D")

    def __init__(self, dim: int, config=None):
        if dim != 3:
            raise ValueError(f"{self.name} is a 3D model")
        super().__init__(dim, config)


class HypoHosford(SmallHosford):
    """The hypoelastic update of HypoHill with Hosford yield on TC and
    hardening Y + S (1 - exp(-D alpha)) (K is not read), the frozen branch
    and the line search (reference: hypo_hosford.cpp).  xi = [TC voigt
    (6), alpha]."""

    name = "hypo_hosford"


class HypoBarlat(SmallHosford):
    """The hypoelastic update of HypoHill with Barlat Yld2004-18p yield on
    TC (the two linear transforms' coefficients sp_* and dp_*), hardening
    Y + K alpha + S (1 - exp(-D alpha)), the frozen branch and the line
    search (reference: hypo_barlat.cpp).  xi = [TC voigt (6), alpha]."""

    name = "hypo_barlat"
    param_names = SmallHosford.param_names + tuple(
        f"{t}_{c}" for t in ("sp", "dp") for c in ("01", "02", "10", "12", "20", "21", "33", "44", "55"))


_REGISTRY = {
    cls.name: cls
    for cls in (Elastic, IsotropicElastic, SmallJ2, SmallHill, SmallHillPlaneStrain,
                SmallHillPlaneStress, HyperJ2, HyperJ2PlaneStrain, HyperJ2PlaneStress,
                HybridHyperJ2PlaneStress, HypoHill, HypoHillPlaneStrain, HypoHillPlaneStress,
                SmallHosford, HypoHosford, HypoBarlat)
}


def create_local_model(name: str, dim: int, config=None):
    """The model `name` in dimension dim; `config`, the local residual's
    sublist, goes to every model, and the hybrid reads its `embedded
    model`."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"local residual type {name!r} is not a model of calibr8_tpu's registry; "
            f"the port has all of them: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](dim, config)
