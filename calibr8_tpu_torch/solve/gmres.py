"""GMRES(m) cycle and preconditioned CG with early exit.

The counterpart of calibr8_tpu's solve/gmres.py.  The Krylov basis and
every vector operation live on the solve's device; orthogonalization is
classical Gram-Schmidt applied twice (CGS2), as matrix products against
the basis.  In float32 on the card these products run in full float32:
PyTorch's default torch.backends.cuda.matmul.allow_tf32 = False is
required here, since TF32 would cost the basis its orthogonality.

In JAX the early-exit test was traced control flow.  In eager PyTorch
it is a device-to-host read each iteration, so the small Hessenberg
column comes to the host with it (one read of k + 2 numbers) and the
Givens rotations, the residual estimate and the back substitution run
there, in the solve's precision.  The semantics are calibr8_tpu's: exit
when the recurrence residual |g_{k+1}| <= atol, on happy breakdown, or
after m iterations; the caller applies the right preconditioner to dy
and re-checks the true residual.
"""

from __future__ import annotations

import numpy as np
import torch


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _nrm(v):
    return torch.sqrt(torch.dot(v, v))


def gmres_cycle(opM, r0, restart: int, atol: float):
    """One right-preconditioned GMRES(m) cycle from the residual r0.

    Minimizes ||r0 - opM(dy)|| over the Krylov space of opM and r0.
    Returns (dy, res_est (float), k_used (int))."""
    m = int(restart)
    ndt = _np_dtype(r0.dtype)
    tiny = ndt(1e-30 if r0.dtype == torch.float32 else 1e-290)
    atol = ndt(atol)

    beta_t = _nrm(r0)
    beta = ndt(beta_t.item())
    V = torch.empty((m + 1,) + tuple(r0.shape), dtype=r0.dtype, device=r0.device)
    V[0] = r0 / torch.clamp_min(beta_t, float(tiny))
    RT = np.zeros((m, m), ndt)  # RT[k] = column k of the rotated Hessenberg R
    g = np.zeros(m + 1, ndt)
    g[0] = beta
    cs = np.zeros(m, ndt)
    sn = np.zeros(m, ndt)
    k = 0
    res = beta
    brk = beta <= tiny
    while k < m and res > atol and not brk:
        Vk = V[: k + 1]
        w = opM(V[k])
        h1 = Vk @ w
        w = w - h1 @ Vk
        h2 = Vk @ w
        w = w - h2 @ Vk
        hk1_t = _nrm(w)
        V[k + 1] = w / torch.clamp_min(hk1_t, float(tiny))
        h = torch.cat([h1 + h2, hk1_t[None]]).cpu().numpy().astype(ndt)  # (k + 2,)
        hk1 = h[k + 1]
        # previous Givens rotations on the new column
        for i in range(k):
            t = cs[i] * h[i] + sn[i] * h[i + 1]
            h[i + 1] = -sn[i] * h[i] + cs[i] * h[i + 1]
            h[i] = t
        hk, hk1r = h[k], h[k + 1]
        den = np.sqrt(hk * hk + hk1r * hk1r)
        if den > tiny:
            c_k, s_k = hk / max(den, tiny), hk1r / max(den, tiny)
        else:
            c_k, s_k = ndt(1.0), ndt(0.0)
        cs[k], sn[k] = c_k, s_k
        h[k] = den
        RT[k, : k + 1] = h[: k + 1]
        gk = g[k]
        g[k + 1] = -s_k * gk
        g[k] = c_k * gk
        res = abs(-s_k * gk)
        brk = hk1 <= tiny
        k += 1

    # back substitution on the k x k upper-triangular R; a column whose
    # diagonal vanished gets 1 added to it, as calibr8_tpu pads it
    R = RT[:k, :k].T.copy()
    for j in range(k):
        if not abs(R[j, j]) > tiny:
            R[j, j] = R[j, j] + ndt(1.0)
    y = np.zeros(k, ndt)
    for j in range(k - 1, -1, -1):
        y[j] = (g[j] - R[j, j + 1 :] @ y[j + 1 :]) / R[j, j]
    dy = torch.as_tensor(y, dtype=r0.dtype, device=r0.device) @ V[:k] if k else torch.zeros_like(r0)
    return dy, float(res), k


def pcg(op, b, M, tol: float, maxiter: int, atol: float = 0.0, x0=None):
    """Preconditioned conjugate gradients with early exit on
    ||r|| <= max(tol * ||b||, atol).  Returns (x, relres (float))."""
    norm_b = float(_nrm(b))
    target = max(tol * norm_b, atol)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - op(x)
    z = M(r) if M is not None else r
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter and float(_nrm(r)) > target:
        Ap = op(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r) if M is not None else r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, float(_nrm(b - op(x))) / max(norm_b, 1e-300)
