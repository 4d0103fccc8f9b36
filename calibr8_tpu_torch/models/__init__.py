"""Local (constitutive) models of this slice: their metadata.

The analog of create_local_residual (reference:
source/calibr8/src/local_residual.cpp:893-935), registry strings as in
the reference decks.  The port runs each model through the fused
assembly (fem/fused_assembly.py): the CUDA kernel on the card, the
trailing-layout twin of models/batched.py on the CPU.  So a model here
carries only what the rest of the system needs to know about it: its
parameter order, the size and initial value of its local state, and its
local-solve tolerance.

Models outside the port so far (hyper_J2 and its plane variants, the
hypo, hosford and barlat families, the NN hybrid, isotropic_elastic)
raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np


class Elastic:
    """Mixed u/p linear elasticity with the reference's 1-dof dummy local
    slot (reference: elastic.cpp:28-44)."""

    name = "elastic"
    param_names = ("E", "nu", "cte", "delta_T")

    def __init__(self, dim: int):
        self.dim = dim
        self.abs_tol = 1e-12

    @property
    def n_params(self) -> int:
        return len(self.param_names)

    def nxi(self) -> int:
        return 1

    def init_xi(self) -> np.ndarray:
        return np.zeros(1)


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


_REGISTRY = {
    cls.name: cls
    for cls in (Elastic, SmallJ2, SmallHill, SmallHillPlaneStrain, SmallHillPlaneStress)
}

# the models the port has not got yet, and the fused-assembly twin each
# one needs (calibr8_tpu models/batched.py)
_QUEUED = {
    "hyper_J2": "the implicit twin with finite-deformation kinematics and grad_u_prev",
    "hyper_J2_plane_strain": "the implicit twin with finite-deformation kinematics",
    "hyper_J2_plane_stress": "the implicit twin with the z-stretch PK1 rows",
    "hypo_hill": "the implicit twin with the polar rotation",
    "hypo_hill_plane_strain": "the implicit twin with the polar rotation",
    "hypo_hill_plane_stress": "the implicit twin with the polar rotation",
    "small_hosford": "the implicit twin with the eigensolver and the frozen path",
    "hypo_hosford": "the implicit twin with the eigensolver and the polar rotation",
    "hypo_barlat": "the implicit twin with the Barlat eigensolver",
    "hybrid_hyper_J2_plane_stress": "the implicit twin with the embedded network",
    "isotropic_elastic": "the displacement-only analytic twin",
}


def create_local_model(name: str, dim: int):
    if name not in _REGISTRY:
        need = _QUEUED.get(name, "a model of calibr8_tpu's registry")
        raise NotImplementedError(
            f"local residual type {name!r} is not ported yet: it needs {need} in the "
            f"fused assembly (kernel 1b, implicit mode); the port has {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](dim)
