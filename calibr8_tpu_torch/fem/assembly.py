"""Operators on the unassembled element Jacobians.

The counterpart of calibr8_tpu's fem/assembly.py:465-562: the layout
test, the element-by-element matvec in either layout, and the dense
scatter for small problems.  The port's own element Jacobians come from
the fused assembly (fem/fused_assembly.py) and are always trailing,
J_T (nde, nde, E).
"""

from __future__ import annotations

import torch

from calibr8_tpu_torch.fem.ebe_matvec import ebe_matvec


def jac_is_trailing(J_e, disc) -> bool:
    """True for the trailing layout (nde, nde, E), False for elem-first
    (n_elem, nde, nde).  When n_elem == nde the two cannot be told apart
    by shape and elem-first wins, as in calibr8_tpu; the port's own
    callers pass J_T to ebe_matvec_T directly and never ask."""
    nde = disc.edofs.shape[1]
    s = tuple(J_e.shape)
    if len(s) != 3:
        raise ValueError(f"element Jacobian must be rank-3, got {s}")
    if s == (disc.n_elem, nde, nde):
        return False
    if s[0] == nde and s[1] == nde and s[2] == disc.n_elem:
        return True
    raise ValueError(f"unrecognized element-Jacobian layout {s} (n_elem={disc.n_elem}, nde={nde})")


def ebe_matvec_T(J_T, disc, v):
    """y = sum_e P_e^T J_e P_e v, J_T (nde, nde, E): the EBE kernel on
    the card, its plain version on the CPU."""
    return ebe_matvec(J_T, v, disc.edofs_T, disc.n_dofs)


def ebe_matvec_disc(J_e, disc, v):
    """Element-by-element J @ v for either layout."""
    if jac_is_trailing(J_e, disc):
        return ebe_matvec_T(J_e, disc, v)
    return ebe_matvec_T(J_e.permute(1, 2, 0).contiguous(), disc, v)


def dense_matrix(J_e, edofs, n_dofs: int):
    """Scatter elem-first Jacobians (n_elem, nde, nde) into a dense
    (n_dofs, n_dofs) matrix (small problems and direct solves only);
    index_add_ is PyTorch's segment_sum."""
    nde = edofs.shape[1]
    rows = edofs[:, :, None].expand(-1, nde, nde)
    cols = edofs[:, None, :].expand(-1, nde, nde)
    flat = (rows * n_dofs + cols).reshape(-1)
    A = torch.zeros(n_dofs * n_dofs, dtype=J_e.dtype, device=J_e.device)
    return A.index_add_(0, flat, J_e.reshape(-1)).reshape(n_dofs, n_dofs)
