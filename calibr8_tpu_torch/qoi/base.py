"""Quantity-of-interest base: per-element values summed over elements.

The counterpart of calibr8_tpu's qoi/base.py (reference QoI<T>,
qoi.hpp:20-94): a QoI is a scalar function of the element state
accumulated over elements at the ip-set-0 points.  Subclasses write
`elem_values` over all elements at once, element axis first.  QoI
derivatives (dJ/dx, dJ/dxi, dJ/dp) and the per-step data hooks of the
calibration QoIs belong to the adjoint slice.
"""

from __future__ import annotations


class QoI:
    name = "base"

    def __init__(self, disc, config=None):
        self.disc = disc
        self.config = config or {}

    def elem_values(self, x_e, x_prev_e, xi, params):
        """(n_elem,) contributions, already weighted by w*dv; x_e
        (n_elem, nde), params (n_elem, n_params)."""
        raise NotImplementedError

    def evaluate(self, x, x_prev, xi, params_all):
        """J = sum over elements (a 0-d tensor)."""
        disc = self.disc
        vals = self.elem_values(x[disc.edofs], x_prev[disc.edofs], xi, params_all[disc.es_ids])
        return vals.sum()
