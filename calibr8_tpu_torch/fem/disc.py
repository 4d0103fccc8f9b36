"""Discretization container: static device tensors + DOF maps.

The counterpart of calibr8_tpu's Disc (reference: disc.hpp:72-483).  The
mesh is lowered once to

  * conn / edofs   (n_elem, npe) / (n_elem, nde) gather indices
  * grad_N, detJ, h  per-element geometry (fem/geometry.py)
  * es_ids         (n_elem,) element-set index per element
  * node/side sets  index arrays (host)

plus the trailing (element-last) copies the CUDA kernels read with the
element index fastest: gN_T (npe, d, E) and edofs_T (nde, E) int32.

DOF layout (flat): u block first (node-major, eq-minor), then p block.
Element dofs are NODE-INTERLEAVED: per node [u_0..u_{d-1}, p].
"""

from __future__ import annotations

import numpy as np
import torch

from calibr8_tpu_torch.fem.geometry import compute_elem_geom
from calibr8_tpu_torch.mechanics.global_residual import MechanicsSpec
from calibr8_tpu_torch.mesh.mesh import Mesh


class Disc:
    def __init__(self, mesh: Mesh, spec: MechanicsSpec, device, dtype=torch.float64):
        mesh.validate()
        sorted_mesh, ranges = mesh.sorted_by_elem_set()
        if mesh.dim != spec.dim:
            raise ValueError(f"mesh is {mesh.dim}D, residual is {spec.dim}D")
        self.mesh = sorted_mesh
        self.spec = spec
        # canonical form (cuda -> cuda:<current>), as tensors report it
        self.device = torch.empty(0, device=device).device
        self.dtype = dtype
        self.elem_set_names = list(ranges.keys())

        d = spec.dim
        n_nodes = sorted_mesh.n_nodes
        n_elem = sorted_mesh.n_elems
        self.n_nodes = n_nodes
        self.n_elem = n_elem
        self.n_dofs_u = n_nodes * d
        self.n_dofs = self.n_dofs_u + (n_nodes if spec.mixed else 0)
        self.ndpn = spec.ndofs_per_node

        def dev(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.device)

        geom = compute_elem_geom(sorted_mesh)
        self.grad_N = dev(geom.grad_N, dtype)  # (E, npe, d)
        self.gN_T = dev(np.moveaxis(geom.grad_N, 0, -1), dtype)  # (npe, d, E)
        self.detJ = dev(geom.detJ, dtype)
        self.h = dev(geom.h, dtype)

        conn = sorted_mesh.conn
        self.conn = dev(conn, torch.int64)
        # element dof map, node-interleaved: per node [u_0..u_{d-1}, p]
        node_dofs = conn[:, :, None] * d + np.arange(d)[None, None, :]
        if spec.mixed:
            edofs = np.concatenate([node_dofs, (self.n_dofs_u + conn)[:, :, None]], axis=2)
        else:
            edofs = node_dofs
        edofs = edofs.reshape(n_elem, -1)
        self.edofs = dev(edofs, torch.int64)  # (E, nde)
        self.edofs_T = dev(edofs.T, torch.int32)  # (nde, E), kernel layout

        es_ids = np.zeros(n_elem, dtype=np.int64)
        for i, (start, stop) in enumerate(ranges.values()):
            es_ids[start:stop] = i
        self.es_ids = dev(es_ids, torch.int64)
        self.es_ids32 = dev(es_ids, torch.int32)

    # -- dof helpers (host) -------------------------------------------
    def u_dof(self, nodes: np.ndarray, eq: int) -> np.ndarray:
        return np.asarray(nodes) * self.spec.dim + eq

    def p_dof(self, nodes: np.ndarray) -> np.ndarray:
        if not self.spec.mixed:
            raise ValueError("no pressure dofs in a displacement-only residual")
        return self.n_dofs_u + np.asarray(nodes)

    def dof(self, resid_idx: int, nodes: np.ndarray, eq: int) -> np.ndarray:
        if resid_idx == 0:
            return self.u_dof(nodes, eq)
        if resid_idx != 1 or eq != 0:
            raise ValueError(f"no residual {resid_idx} equation {eq}")
        return self.p_dof(nodes)

    def zero_x(self) -> torch.Tensor:
        return torch.zeros(self.n_dofs, dtype=self.dtype, device=self.device)

    # -- node-matrix layout --------------------------------------------
    def nodemat(self, x: torch.Tensor) -> torch.Tensor:
        """Flat dofs -> (n_nodes, ndpn) node matrix [u | p]."""
        u = x[: self.n_dofs_u].reshape(self.n_nodes, self.spec.dim)
        if not self.spec.mixed:
            return u
        return torch.cat([u, x[self.n_dofs_u :].reshape(self.n_nodes, 1)], dim=1)

    def nodemat_to_flat(self, X: torch.Tensor) -> torch.Tensor:
        d = self.spec.dim
        parts = [X[:, :d].reshape(-1)]
        if self.spec.mixed:
            parts.append(X[:, d])
        return torch.cat(parts)

    def scatter_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """(n_elem*npe, c) per-element-node rows -> (n_nodes, c) assembled
        node values (the Export-ADD analog, linear_alg.hpp:38-53).
        calibr8_tpu uses segment_sum; an in-place index_add_ into fresh
        zeros is PyTorch's form of the same sum and allocates nothing
        else."""
        out = torch.zeros(self.n_nodes, rows.shape[-1], dtype=rows.dtype, device=rows.device)
        return out.index_add_(0, self.conn.reshape(-1), rows)
