"""Element derivative blocks of the adjoint sweep.

The counterpart of calibr8_tpu's Assembler.make_adjoint_blocks_kernel
(fem/assembly.py:298-427) with parts="all": ONE linearization of
G = [C; R] (the local residual of the model twin with its branch forced
to the primal's `path`, and the generic element residual of
mechanics/global_residual.py) over the seed vector

    v = [xi, x_e, xp_e, xi_prev, p]     (2 nxi + 2 nde + n_params seeds)

gives every block the backward step needs (the x_prev blocks are
nonzero for the finite-deformation twins, whose C reads grad_u_prev),
and static condensation in trailing layout gives the condensed Jacobian:

    dxi_dx    = -(dC/dxi)^-1 dC/dx
    J_total   = dR/dx + dR/dxi dxi_dx

Tangents come from jvp_columns (torch.func.vmap over torch.func.jvp),
the counterpart of jax.linearize.  This is plain PyTorch on the
solve's device: calibr8_tpu computes it with XLA, not a Pallas kernel.
The elements are taken in chunks so that the tangent temporaries
(seeds x rows x elements) stay bounded.  calibr8_tpu's two-pass
"solve" / "post" split (solve/adjoint.py:155-167) served a 16 GB HBM and
is not carried over.
"""

from __future__ import annotations

import torch

from calibr8_tpu_torch.mechanics.global_residual import elem_kinematics
from calibr8_tpu_torch.models.batched import jvp_columns
from calibr8_tpu_torch.utils.smallsolve import gauss_solve_T

BLOCK_NAMES = ("dC_dxi_T", "dC_dxprev_T", "dC_dxiprev_T", "dC_dp_T", "dR_dxi_T", "dR_dp_T",
               "dxi_dx_T", "J_total_T")

# elements per linearization: at 3D mixed u/p (up to 57 seeds, 23 rows)
# the tangent temporaries of one chunk stay near a few GB in float64
ELEM_CHUNK = 1 << 16


def blocks_kernel(bmodel, spec, elem_res, x_eT, xp_eT, xiT, xipT, path, gNT, detJ, h, parT):
    """The 8 trailing-layout blocks of make_adjoint_blocks_kernel("all")
    for the elements of the given (already sliced) arrays; each block
    (rows, cols, E)."""
    nxi, nde = xiT.shape[0], x_eT.shape[0]
    geom = (gNT, detJ, h)
    c0, c1, c2, c3 = nxi, nxi + nde, nxi + 2 * nde, 2 * nxi + 2 * nde

    def G(v):
        xi_, xe, xpe, xip, p = v[:c0], v[c0:c1], v[c1:c2], v[c2:c3], v[c3:]
        C = bmodel.residual(xi_, xip, elem_kinematics(spec, xe, gNT), p, path,
                            elem_kinematics(spec, xpe, gNT))
        return torch.cat([C, elem_res(xe, xpe, xi_, geom, p)])

    _, cols = jvp_columns(G, torch.cat([xiT, x_eT, xp_eT, xipT, parT]))
    JG = cols.permute(1, 0, 2)  # JG[i, k] = dG_i / dv_k
    dC_dxi_T = JG[:nxi, :c0]
    dR_dxi_T = JG[nxi:, :c0]
    dxi_dx_T = -gauss_solve_T(dC_dxi_T, JG[:nxi, c0:c1])
    J_total_T = JG[nxi:, c0:c1] + torch.einsum("ike,kje->ije", dR_dxi_T, dxi_dx_T)
    return dict(
        dC_dxi_T=dC_dxi_T,
        dC_dxprev_T=JG[:nxi, c1:c2],
        dC_dxiprev_T=JG[:nxi, c2:c3],
        dC_dp_T=JG[:nxi, c3:],
        dR_dxi_T=dR_dxi_T,
        dR_dp_T=JG[nxi:, c3:],
        dxi_dx_T=dxi_dx_T,
        J_total_T=J_total_T,
    )


def adjoint_blocks(disc, bmodel, elem_res, x, x_prev, xi, xi_prev, path, params_all,
                   chunk: int = ELEM_CHUNK):
    """The blocks for every element of `disc` from the global state: x,
    x_prev (n_dofs,), xi, xi_prev (E, nxi), path (E,), params_all
    (n_sets, n_params).  Returns {name: (rows, cols, E) contiguous}."""
    return adjoint_blocks_elems(
        bmodel, disc.spec, elem_res, x[disc.edofs].T, x_prev[disc.edofs].T, xi.T, xi_prev.T,
        path, disc.gN_T, disc.detJ, disc.h, params_all[disc.es_ids].T, chunk=chunk,
    )


def adjoint_blocks_elems(bmodel, spec, elem_res, x_eT, xp_eT, xiT, xipT, path, gNT, detJ, h,
                         parT, chunk: int = ELEM_CHUNK):
    """blocks_kernel over gathered elements (the domain-decomposed
    solver's parts laid end to end, or a Disc's elements), `chunk`
    elements at a time.  Returns {name: (rows, cols, E) contiguous}."""
    args = (x_eT, xp_eT, xiT, xipT, path, gNT, detJ, h, parT)
    E = x_eT.shape[-1]
    if E <= chunk:
        return {k: v.contiguous() for k, v in
                blocks_kernel(bmodel, spec, elem_res, *args).items()}
    out = None
    for s in range(0, E, chunk):
        part = blocks_kernel(bmodel, spec, elem_res, *(a[..., s:s + chunk] for a in args))
        if out is None:
            out = {k: torch.empty(*v.shape[:-1], E, dtype=v.dtype, device=v.device)
                   for k, v in part.items()}
        for k, v in part.items():
            out[k][..., s:s + chunk] = v
    return out
