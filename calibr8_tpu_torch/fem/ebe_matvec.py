"""Element-by-element matvec: the CUDA kernel and its plain version.

    y = sum_e P_e^T J_e P_e v,   J_T (nde, nde, E) in trailing layout

The counterpart of calibr8_tpu's fem/pallas_matvec.py
(make_ebe_matvec_T, pallas_call at :49).  The kernel
(csrc/ebe_matvec.cu) fuses the element gather and the scatter-add that
calibr8_tpu left to XLA, so one call takes the flat v to the flat y.
Its adds into y are atomic, in an order that changes from run to run:
it matches the plain version to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from calibr8_tpu_torch import kernels

_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5


def ebe_matvec(J_T, v, edofs_T, n_dofs: int):
    """y (n_dofs,) = sum_e P_e^T J_e P_e v with J_T (nde, nde, E) and
    edofs_T (nde, E) int32.  On CUDA tensors this launches the kernel
    (or raises); on CPU tensors it runs the plain version."""
    if not v.is_cuda:
        return ebe_matvec_plain(J_T, v, edofs_T, n_dofs)
    req = kernels.require
    nde, E = edofs_T.shape
    req(J_T.shape == (nde, nde, E), f"J_T has shape {tuple(J_T.shape)}, want ({nde}, {nde}, {E})")
    req(v.shape == (n_dofs,), f"v has shape {tuple(v.shape)}, want ({n_dofs},)")
    req(J_T.dtype == v.dtype, f"J_T is {J_T.dtype}, v is {v.dtype}")
    req(edofs_T.dtype == torch.int32, "edofs_T must be int32")
    for name, t in (("J_T", J_T), ("v", v), ("edofs_T", edofs_T)):
        req(t.device == v.device, f"{name} is on {t.device}, v on {v.device}")
        req(t.is_contiguous(), f"{name} is not contiguous")
    # zeros, not empty: the kernel adds into y
    y = torch.zeros(n_dofs, dtype=v.dtype, device=v.device)
    fn = kernels.function("ebe_matvec", "c8_ebe_matvec", _ARGTYPES)
    err = fn(
        v.device.index, kernels.dtype_code(v.dtype), nde, E, J_T.data_ptr(), v.data_ptr(),
        edofs_T.data_ptr(), y.data_ptr(), kernels.stream_ptr(v.device),
    )
    kernels.check("ebe_matvec", err)
    kernels.launches["ebe_matvec"] += 1
    return y


def ebe_matvec_plain(J_T, v, edofs_T, n_dofs: int):
    """The plain PyTorch version: gather, per-element product, scatter.
    index_add_ is PyTorch's segment_sum."""
    idx = edofs_T.long()
    y_eT = torch.einsum("ijE,jE->iE", J_T, v[idx])
    y = torch.zeros(n_dofs, dtype=v.dtype, device=v.device)
    return y.index_add_(0, idx.reshape(-1), y_eT.reshape(-1))
