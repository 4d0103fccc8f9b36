"""The calibration QoI (full-field displacement mismatch plus a load
mismatch) and the reaction-mismatch QoI.

The counterpart of calibr8_tpu's qoi/calibration.py (reference
calibration.cpp, load_mismatch.cpp, reaction_mismatch.hpp):

  calibration, per step:  J = J_disp + J_forc
    J_disp = sum over the included elements (2D) or side-set facets (3D)
             of 1/2 sum_d weights[d] (u_d - u_meas,d)^2 w dv, order-2
             quadrature, / area * dt / total_time   (calibration.cpp:66-214)
    J_forc = 1/2 balance_factor dt / total_time (load - load_meas)^2
  reaction mismatch:      J = 1/2 (load - load_meas)^2

where load = sum over the load dofs L (the reaction component at the
nodes on the plane coord[idx] == value) of the assembled element residual
R (calibration.cpp:306-346).

Neither is a sum of element terms: J_forc is the square of a global sum.
So both override QoI.evaluate and QoI.partials with their global forms.
The load is the element residual of mechanics/global_residual.py
(make_elem_residual, the function fem/adjoint_blocks.py linearizes) at
the trajectory's own xi, on the elements that touch a load dof only, and
its x / xi / p partials are one torch.func.vjp of those elements' rows
with the selection of the load rows as cotangent.  Plain PyTorch on the
problem's device, as calibr8_tpu computes it with XLA.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from calibr8_tpu_torch.fem import basis
from calibr8_tpu_torch.fem.geometry import compute_facet_geom
from calibr8_tpu_torch.mechanics.global_residual import PARENT_MEASURE, make_elem_residual
from calibr8_tpu_torch.qoi.base import QoI


def load_node_dofs(disc, coord_idx, coord_value, coord_tol, force_comp):
    """Dof ids of the reaction component at the nodes on the coordinate
    plane (setup_coord_based_node_mapping)."""
    coords = disc.mesh.coords
    nodes = np.where(np.abs(coords[:, coord_idx] - coord_value) < coord_tol)[0]
    return disc.u_dof(nodes, force_comp)


def read_load_file(path):
    with open(path) as f:
        return [float(line) for line in f if line.strip()]


class LoadSum:
    """The reaction at the load dofs: the sum of the element residual rows
    that land on them, over the elements that touch one."""

    def __init__(self, disc, cfg):
        self.disc = disc
        dofs = load_node_dofs(disc, int(cfg["coordinate index"]), float(cfg["coordinate value"]),
                              float(cfg.get("coordinate tolerance", 1e-12)),
                              int(cfg["reaction force component"]))
        edofs = disc.edofs.cpu().numpy()
        on_load = np.isin(edofs, dofs)  # (E, nde)
        elems = np.nonzero(on_load.any(axis=1))[0]
        dev = disc.device
        self.elems = torch.as_tensor(elems, dtype=torch.int64, device=dev)
        # (nde, E_L): 1 where an element row is a load dof
        self.sel_T = torch.as_tensor(np.ascontiguousarray(on_load[elems].T), dtype=disc.dtype,
                                     device=dev)
        self.edofs = disc.edofs[self.elems]  # (E_L, nde)
        self.geom = (disc.gN_T[..., self.elems], disc.detJ[self.elems], disc.h[self.elems])
        self.es_ids = disc.es_ids[self.elems]

    def _rows(self, elem_res, x_prev):
        xp_eT = x_prev[self.edofs].T

        def rows(x_eT, xiT, parT):
            return elem_res(x_eT, xp_eT, xiT, self.geom, parT)

        return rows

    def _inputs(self, x, xi, params_all):
        return x[self.edofs].T, xi[self.elems].T, params_all[self.es_ids].T

    def value(self, elem_res, x, x_prev, xi, params_all):
        """The load, a 0-d tensor."""
        return (self._rows(elem_res, x_prev)(*self._inputs(x, xi, params_all)) * self.sel_T).sum()

    def partials(self, elem_res, x, x_prev, xi, params_all, dJ_dload):
        """(s dload/dx (n_dofs,), s dload/dxi (E, nxi), s dload/dp
        (n_sets, n_params)) with s = dJ_dload(load), a function of the
        0-d load tensor."""
        R_T, vjp = torch.func.vjp(self._rows(elem_res, x_prev), *self._inputs(x, xi, params_all))
        dx_eT, dxiT, dpT = vjp(self.sel_T * dJ_dload((R_T * self.sel_T).sum()))
        dx = torch.zeros_like(x).index_add_(0, self.edofs.reshape(-1), dx_eT.T.reshape(-1))
        dxi = torch.zeros_like(xi)
        dxi[self.elems] = dxiT.T
        dp = torch.zeros_like(params_all).index_add_(0, self.es_ids, dpT.T)
        return dx, dxi, dp


class _ReactionQoI(QoI):
    """A QoI that reads the assembled residual: Problem attaches its
    assembler (calibr8_tpu problem.py:218-225), whose twin gives the
    element residual."""

    def __init__(self, disc, config=None):
        super().__init__(disc, config)
        cfg = self.config
        self.load_out_file = cfg.get("load out file", None)
        self.load_in_file = cfg.get("load input file", None)
        # the measured load, one value per step (steps 1..N)
        self.load_data = read_load_file(self.load_in_file) if self.load_in_file else None
        self.assembler = None
        self._load = LoadSum(disc, cfg)
        self._elem_res = None

    def _load_meas(self, step):
        return self.load_data[step - 1] if self.load_data is not None else 0.0

    @property
    def elem_res(self):
        if self._elem_res is None:
            if self.assembler is None:
                raise RuntimeError(f"the {self.name!r} QoI needs the problem's assembler")
            self._elem_res = make_elem_residual(self.assembler.bmodel, self.disc.spec)
        return self._elem_res

    def compute_load(self, x, x_prev, xi, params_all):
        return self._load.value(self.elem_res, x, x_prev, xi, params_all)


class Calibration(_ReactionQoI):
    name = "calibration"

    def __init__(self, disc, config=None):
        super().__init__(disc, config)
        cfg = self.config
        self.balance_factor = float(cfg["balance factor"])
        self.weights = np.asarray(cfg.get("displacement weights", [1.0] * disc.spec.dim),
                                  dtype=float)
        self.distance_threshold = cfg.get("distance threshold", None)
        self.side_set_disp = cfg.get("displacement side set", None)
        self._setup_geometry()

    def _setup_geometry(self):
        """The integration cells of J_disp: the elements (2D) or the facets
        of the displacement side set (3D) whose centroid's `distance` is
        above the threshold, each with its nodes, its measure (zero where
        masked out) and the order-2 rule's shape values and weights."""
        disc = self.disc
        mesh = disc.mesh
        dist = mesh.fields.get("distance", None)
        if self.distance_threshold is not None and dist is None:
            raise ValueError("'distance threshold' needs a 'distance' field on the mesh")
        if disc.spec.dim == 2:
            conn = mesh.conn
            if self.distance_threshold is not None:
                keep = np.asarray(dist)[conn].mean(axis=1) > float(self.distance_threshold)
            else:
                keep = np.ones(disc.n_elem, dtype=bool)
            detJ = disc.detJ.cpu().numpy()
            self.area = float(np.sum(np.where(keep, detJ * PARENT_MEASURE[2], 0.0)))
            nodes, measure = conn, np.where(keep, detJ, 0.0)
            q_pts, q_wts = basis.quadrature(2, 2)
            N = basis.shape_values(2, q_pts)
        else:
            if not self.side_set_disp:
                raise ValueError("3D calibration needs 'displacement side set'")
            fg = compute_facet_geom(mesh, self.side_set_disp)
            if self.distance_threshold is not None:
                keep = np.asarray(dist)[fg.nodes].mean(axis=1) > float(self.distance_threshold)
            else:
                keep = np.ones(fg.nodes.shape[0], dtype=bool)
            nodes, measure = fg.nodes[keep], fg.area[keep]
            self.area = float(np.sum(measure))
            q_pts, q_wts = basis.facet_quadrature(3, 2)
            N = basis.facet_shape_values(3, q_pts)
            # the facet rule's weights sum to the parent measure 1/2; dv = 2A
            q_wts = q_wts * 2.0
        opts = dict(dtype=disc.dtype, device=disc.device)
        self._nodes = torch.as_tensor(np.ascontiguousarray(nodes), dtype=torch.int64,
                                      device=disc.device)
        self._measure = torch.as_tensor(measure, **opts)
        self._N = torch.as_tensor(N, **opts)  # (nq, nodes per cell)
        self._q_wts = torch.as_tensor(q_wts, **opts)
        self._w = torch.as_tensor(self.weights, **opts)

    def setup_step(self, step, t, dt, total_time):
        meas = self.disc.mesh.fields.get(f"measured_{step}")
        if meas is None:
            raise ValueError(f"measured_{step} field missing")
        return dict(measured=torch.as_tensor(meas, dtype=self.disc.dtype, device=self.disc.device),
                    load_meas=self._load_meas(step), dt_frac=dt / total_time)

    def _disp_diff_q(self, x, aux):
        """The mismatch at the quadrature points, (cells, nq, dim)."""
        disc = self.disc
        u = x[: disc.n_dofs_u].reshape(disc.n_nodes, disc.spec.dim)
        return torch.einsum("qn,cnd->cqd", self._N, (u - aux["measured"])[self._nodes])

    def _disp_scale(self, aux):
        return aux["dt_frac"] / self.area

    def disp_mismatch(self, x, aux):
        diff_q = self._disp_diff_q(x, aux)
        per_q = 0.5 * torch.einsum("d,cqd->cq", self._w, diff_q * diff_q)
        per_c = torch.einsum("cq,q->c", per_q, self._q_wts) * self._measure
        return per_c.sum() * self._disp_scale(aux)

    def evaluate(self, x, x_prev, xi, params_all, aux=()):
        load = self.compute_load(x, x_prev, xi, params_all)
        mism = load - aux["load_meas"]
        return (self.disp_mismatch(x, aux)
                + 0.5 * self.balance_factor * aux["dt_frac"] * mism * mism)

    def partials(self, x, x_prev, xi, params_all, aux=()):
        disc = self.disc
        # J_disp: dJ/du at the cells' nodes, scattered to the u dofs
        diff_q = self._disp_diff_q(x, aux)
        g_q = diff_q * self._w * (self._q_wts[None, :, None] * self._measure[:, None, None])
        g_n = torch.einsum("qn,cqd->cnd", self._N, g_q) * self._disp_scale(aux)
        du = torch.zeros(disc.n_nodes, disc.spec.dim, dtype=x.dtype, device=x.device)
        du.index_add_(0, self._nodes.reshape(-1), g_n.reshape(-1, disc.spec.dim))
        # J_forc: b dt/T (load - load_meas) dload/d(x, xi, p)
        b = self.balance_factor * aux["dt_frac"]
        dx, dxi, dp = self._load.partials(self.elem_res, x, x_prev, xi, params_all,
                                          lambda load: b * (load - aux["load_meas"]))
        dx[: disc.n_dofs_u] += du.reshape(-1)
        return dx, dxi, dp


class ReactionMismatch(_ReactionQoI):
    """The reaction at the coordinate-plane nodes against a measured load,
    J = 1/2 (load - load_meas)^2 (reaction_mismatch.hpp); with `load out
    file` it records the load history, the synthetic load.dat."""

    name = "reaction mismatch"

    def __init__(self, disc, config=None):
        super().__init__(disc, config)
        self.load_history = {}

    def setup_step(self, step, t, dt, total_time):
        return dict(load_meas=self._load_meas(step))

    def evaluate(self, x, x_prev, xi, params_all, aux=()):
        mism = self.compute_load(x, x_prev, xi, params_all) - aux["load_meas"]
        return 0.5 * mism * mism

    def partials(self, x, x_prev, xi, params_all, aux=()):
        return self._load.partials(self.elem_res, x, x_prev, xi, params_all,
                                   lambda load: load - aux["load_meas"])

    def after_step(self, x, x_prev, xi, params_all, step):
        """Record the step's load and, with `load out file`, write it as
        one `{load:.17e}` line (mode w at step 1, a after;
        calibration.cpp:351-366)."""
        load = float(self.compute_load(x, x_prev, xi, params_all))
        self.load_history[step] = load
        if self.load_out_file:
            os.makedirs(os.path.dirname(self.load_out_file) or ".", exist_ok=True)
            with open(self.load_out_file, "w" if step == 1 else "a") as f:
                f.write(f"{load:.17e}\n")
