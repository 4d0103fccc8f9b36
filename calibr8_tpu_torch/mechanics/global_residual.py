"""The 'mechanics' global residual: its static configuration.

Quasi-static balance of linear momentum, mixed u/p with GLS-type
pressure stabilization (reference: source/calibr8/src/mechanics.cpp).
The element residual itself lives in the fused assembly
(fem/fused_assembly.py: the CUDA kernel and its plain PyTorch version);
this module keeps what the rest of the port needs to agree on: the
parent-element measures and the element dof packing.

Element DOF packing: x_e = [u (npe*d), p (npe)] node-interleaved, i.e.
x_e.reshape(npe, ndpn) with columns [u_0..u_{d-1}, p].
"""

from __future__ import annotations

from dataclasses import dataclass

PARENT_MEASURE = {2: 0.5, 3: 1.0 / 6.0}


@dataclass(frozen=True)
class MechanicsSpec:
    """Static configuration of the mechanics residual."""

    dim: int
    mixed: bool = True
    stab_multiplier: float = 1.0

    @property
    def npe(self) -> int:
        return self.dim + 1

    @property
    def ndofs_per_node(self) -> int:
        return self.dim + (1 if self.mixed else 0)

    @property
    def ndofs_elem(self) -> int:
        return self.npe * self.ndofs_per_node

    def unpack(self, x_e):
        """Split element dofs (..., nde) into (u_e (..., npe, d),
        p_e (..., npe) or None)."""
        xm = x_e.reshape(*x_e.shape[:-1], self.npe, self.ndofs_per_node)
        u = xm[..., : self.dim]
        p = xm[..., self.dim] if self.mixed else None
        return u, p
