"""Dirichlet and traction boundary conditions.

Dirichlet (reference: source/calibr8/src/dbcs.cpp): expression-based
`[resid_idx, eq, node_set, value_expr]` and field-based (measured data)
DBCs.  The reference zeroes the Jacobian row, keeps the diagonal, and
sets R_row = diag * (sol - value) (dbcs.cpp:88-105); the port applies
the same modification to the residual vector and to the operator rows.

Traction (reference: source/calibr8/src/tbcs.cpp:18-84):
`[resid_idx, side_set, tx, ty(, tz)]`; for P1 facets with the order-1
rule the nodal force is T(centroid) * area / nodes_per_facet.

BC values are evaluated on the host per load step (they depend only on
coordinates and time) and moved to the Disc's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from calibr8_tpu_torch.expression import Expression
from calibr8_tpu_torch.fem.geometry import compute_facet_geom


@dataclass
class DirichletSpec:
    resid_idx: int
    eq: int
    node_set: str
    value: str  # expression in x, y, z, t


@dataclass
class FieldDirichletSpec:
    """Measured-data DBC: the value comes from the nodal field
    `<prefix>_<step>` (reference: dbcs.cpp apply_field_primal_dbcs)."""

    resid_idx: int
    eq: int
    node_set: str
    prefix: str = "measured"


@dataclass
class TractionSpec:
    resid_idx: int
    side_set: str
    values: tuple[str, ...]  # dim expressions


class DirichletBCs:
    def __init__(self, disc, specs: list[DirichletSpec], field_specs=None):
        self.disc = disc
        self.specs = specs
        self.field_specs = field_specs or []
        mesh = disc.mesh
        self._entries = []
        for s in specs:
            nodes = np.asarray(mesh.node_sets[s.node_set])
            dofs = disc.dof(s.resid_idx, nodes, s.eq)
            self._entries.append((dofs, mesh.coords[nodes], Expression(s.value)))
        self._field_entries = []
        for s in self.field_specs:
            nodes = np.asarray(mesh.node_sets[s.node_set])
            dofs = disc.dof(s.resid_idx, nodes, s.eq)
            self._field_entries.append((dofs, nodes, s.eq, s.prefix))
        all_dofs = [e[0] for e in self._entries] + [e[0] for e in self._field_entries]
        dofs = np.concatenate(all_dofs) if all_dofs else np.zeros(0, dtype=np.int64)
        # de-duplicate (a corner node can appear in two bc sets), keeping
        # the LAST occurrence: the reference applies entries in deck order
        rev_first = np.unique(dofs[::-1], return_index=True)[1]
        keep_rev = np.zeros(dofs.size, dtype=bool)
        keep_rev[rev_first] = True
        self._keep = keep_rev[::-1].copy()
        self.dofs = dofs[self._keep]

    def values(self, t: float, step: int = 0) -> np.ndarray:
        """Prescribed values aligned with self.dofs (expressions at time
        t; field entries read <prefix>_<step>)."""
        out = []
        for dofs, coords, expr in self._entries:
            x = coords[:, 0]
            y = coords[:, 1]
            z = coords[:, 2] if coords.shape[1] > 2 else np.zeros_like(x)
            v = expr(x=x, y=y, z=z, t=t)
            out.append(np.broadcast_to(np.asarray(v, dtype=np.float64), x.shape))
        for dofs, nodes, eq, prefix in self._field_entries:
            field = self.disc.mesh.fields.get(f"{prefix}_{step}")
            if field is None:
                raise ValueError(f"field DBC needs the nodal field {prefix}_{step}")
            out.append(np.asarray(field)[nodes, eq])
        vals = np.concatenate(out) if out else np.zeros(0, dtype=np.float64)
        return vals[self._keep] if vals.size else vals

    def arrays(self, t: float, step: int = 0):
        """(bc_dofs int64, bc_vals) on the Disc's device."""
        disc = self.disc
        return (
            torch.as_tensor(self.dofs, dtype=torch.int64, device=disc.device),
            torch.as_tensor(self.values(t, step), dtype=disc.dtype, device=disc.device),
        )


def apply_dbcs_residual(R, diag, x, bc_dofs, bc_vals):
    """R_row <- diag * (x_row - g)  (dbcs.cpp:100-101); returns a copy."""
    R = R.clone()
    R[bc_dofs] = diag[bc_dofs] * (x[bc_dofs] - bc_vals)
    return R


def zero_dbc_rows(R, bc_dofs):
    """The adjoint variant: constrained rows zeroed (dbcs.cpp:102-104);
    returns a copy."""
    return R.clone().index_fill_(0, bc_dofs, 0.0)


def apply_dbcs_matvec(Jv, diag, v, bc_dofs):
    """(J v)_row <- diag * v_row for constrained rows, in place on Jv
    (a fresh operator output in every caller)."""
    Jv[bc_dofs] = diag[bc_dofs] * v[bc_dofs]
    return Jv


def apply_dbcs_dense(A, diag, bc_dofs):
    """Zero the constrained rows of a dense matrix and put the assembled
    diagonal back on them, in place (index_fill_ passes the value to the
    kernel, which a CUDA graph can hold)."""
    A.index_fill_(0, bc_dofs, 0.0)
    A[bc_dofs, bc_dofs] = diag[bc_dofs]
    return A


class TractionBCs:
    def __init__(self, disc, specs: list[TractionSpec]):
        self.disc = disc
        self.specs = specs
        mesh = disc.mesh
        d = disc.spec.dim
        self._entries = []
        for s in specs:
            fg = compute_facet_geom(mesh, s.side_set)
            nfn = fg.nodes.shape[1]
            # nodal dof ids for each facet node, each eq: (n_faces, nfn, d)
            dofs = np.stack([disc.u_dof(fg.nodes, eq) for eq in range(d)], axis=-1)
            centroids = mesh.coords[fg.nodes].mean(axis=1)
            exprs = [Expression(v) for v in s.values]
            self._entries.append((dofs, fg.area, centroids, exprs, nfn))

    def force_vector(self, t: float) -> np.ndarray:
        """Global T with T[dof] = integral of traction * basis; the
        residual update is R -= T (tbcs.cpp:77-80)."""
        out = np.zeros(self.disc.n_dofs)
        for dofs, area, centroids, exprs, nfn in self._entries:
            x = centroids[:, 0]
            y = centroids[:, 1]
            z = centroids[:, 2] if centroids.shape[1] > 2 else np.zeros_like(x)
            for eq, expr in enumerate(exprs):
                tvals = np.broadcast_to(
                    np.asarray(expr(x=x, y=y, z=z, t=t), dtype=np.float64), x.shape
                )
                np.add.at(out, dofs[:, :, eq].reshape(-1), np.repeat(tvals * area / nfn, nfn))
        return out

    def array(self, t: float) -> torch.Tensor:
        disc = self.disc
        return torch.as_tensor(self.force_vector(t), dtype=disc.dtype, device=disc.device)
