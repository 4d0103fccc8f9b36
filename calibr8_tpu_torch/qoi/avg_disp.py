"""`average displacement` (reference: source/calibr8/src/avg_disp.cpp):
J = integral of (sum_i u_i) / ndims dv, at the element centroids."""

from __future__ import annotations

from calibr8_tpu_torch.mechanics.global_residual import PARENT_MEASURE
from calibr8_tpu_torch.qoi.base import QoI


class AvgDisp(QoI):
    name = "average displacement"

    def elem_values(self, x_e, x_prev_e, xi, params):
        disc = self.disc
        spec = disc.spec
        u_e, _ = spec.unpack(x_e)  # (E, npe, d)
        wdv = disc.detJ * PARENT_MEASURE[spec.dim]
        u_ip = u_e.mean(dim=1)  # P1 centroid interpolation
        return u_ip.sum(dim=1) / spec.dim * wdv
