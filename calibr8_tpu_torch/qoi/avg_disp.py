"""`average displacement` (reference: source/calibr8/src/avg_disp.cpp):
J = integral of (sum_i u_i) / ndims dv, at the element centroids."""

from __future__ import annotations

from calibr8_tpu_torch.mechanics.global_residual import PARENT_MEASURE
from calibr8_tpu_torch.qoi.base import QoI


class AvgDisp(QoI):
    name = "average displacement"

    def elem_value(self, x_e, x_prev_e, xi, geom, params, aux):
        spec = self.disc.spec
        _, detJ, _ = geom
        u_e, _ = spec.unpack(x_e)  # (npe, d)
        wdv = detJ * PARENT_MEASURE[spec.dim]
        u_ip = u_e.mean(dim=0)  # P1 centroid interpolation
        return u_ip.sum() / spec.dim * wdv
