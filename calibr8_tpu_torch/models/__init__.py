"""Local (constitutive) models of this slice: their metadata.

The analog of create_local_residual (reference:
source/calibr8/src/local_residual.cpp:893-935), registry strings as in
the reference decks.  The port runs each model through the fused
assembly (fem/fused_assembly.py): the CUDA kernel on the card, the
trailing-layout twin of models/batched.py on the CPU.  So a model here
carries only what the rest of the system needs to know about it: its
parameter order, the size and initial value of its local state, and its
local-solve tolerance.

Models outside this slice (hyper_J2, the hill / hosford / barlat / hypo
families, the NN hybrids, isotropic_elastic) raise NotImplementedError.
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


class SmallJ2(Elastic):
    """Radial-return J2 with linear hardening sigma_y = Y + K alpha
    (reference: small_J2.cpp:186-246); xi = [pstrain voigt, alpha]."""

    name = "small_J2"
    param_names = ("E", "nu", "K", "Y", "cte", "delta_T")

    def nxi(self) -> int:
        return (3 if self.dim == 2 else 6) + 1

    def init_xi(self) -> np.ndarray:
        return np.zeros(self.nxi())


_REGISTRY = {cls.name: cls for cls in (Elastic, SmallJ2)}


def create_local_model(name: str, dim: int):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"local residual type {name!r} is not ported yet: the port has "
            f"{sorted(_REGISTRY)}; its fused-assembly twin (implicit mode, "
            "kernel 1b) comes in a later slice"
        )
    return _REGISTRY[name](dim)
