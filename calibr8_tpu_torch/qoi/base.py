"""Quantity-of-interest base: per-element values summed over elements.

The counterpart of calibr8_tpu's qoi/base.py (reference QoI<T>,
qoi.hpp:20-94): a QoI is a scalar function of one element's state,

    elem_value(x_e (nde,), x_prev_e, xi (nxi,), geom, params (n_params,), aux)

with geom = (grad_N (npe, d), detJ, h), accumulated over elements at
the ip-set-0 points.  `evaluate` maps it over the elements with
torch.func.vmap; `partials` maps torch.func.grad of it over the
elements for the adjoint: dJ/dx, dJ/dxi, dJ/dp (the QoI<FADT> seeded
evaluations, qoi.cpp:226-233).  Step-dependent data arrives through
`aux`, prepared per step by setup_step.
"""

from __future__ import annotations

import torch


class QoI:
    name = "base"

    def __init__(self, disc, config=None):
        self.disc = disc
        self.config = config or {}

    def setup_step(self, step: int, t: float, dt: float, total_time: float):
        """The aux data of this step (none for the QoIs ported so far)."""
        return ()

    def elem_value(self, x_e, x_prev_e, xi, geom, params, aux):
        """Scalar contribution of one element, already weighted by w*dv."""
        raise NotImplementedError

    def _elem_args(self, x, x_prev, xi, params_all):
        disc = self.disc
        return (x[disc.edofs], x_prev[disc.edofs], xi, disc.grad_N, disc.detJ, disc.h,
                params_all[disc.es_ids])

    def evaluate(self, x, x_prev, xi, params_all, aux=()):
        """J = sum over elements (a 0-d tensor)."""

        def one(x_e, xp_e, xi_e, gN, dJ, h, par):
            return self.elem_value(x_e, xp_e, xi_e, (gN, dJ, h), par, aux)

        return torch.func.vmap(one)(*self._elem_args(x, x_prev, xi, params_all)).sum()

    def partials(self, x, x_prev, xi, params_all, aux=()):
        """(dJ/dx (n_dofs,), dJ/dxi (n_elem, nxi), dJ/dp (n_sets,
        n_params)): the element gradients, scattered to the dofs and
        summed over each element set (index_add_, PyTorch's
        segment_sum)."""
        disc = self.disc

        def one(x_e, xp_e, xi_e, gN, dJ, h, par):
            return self.elem_value(x_e, xp_e, xi_e, (gN, dJ, h), par, aux)

        grads = torch.func.vmap(torch.func.grad(one, argnums=(0, 2, 6)))
        dx_e, dxi, dp_e = grads(*self._elem_args(x, x_prev, xi, params_all))
        dJdx = torch.zeros_like(x).index_add_(0, disc.edofs.reshape(-1), dx_e.reshape(-1))
        dJdp = torch.zeros_like(params_all).index_add_(0, disc.es_ids, dp_e)
        return dJdx, dxi, dJdp
