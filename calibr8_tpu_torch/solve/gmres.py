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

GmresCycle is the same cycle with no host read inside it, for the jitted
step solver (solve/jit_newton.py), whose pieces CUDA graphs replay:
every quantity lives in a fixed-shape device buffer, iteration k is
Python code with k static, and the early exit is a mask (`active`): once
it is off, no iteration changes anything.  `run` takes the iterations in
chunks of CHUNK and reads `active` once per chunk.
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


# GMRES iterations between two reads of a sync-free cycle's `active` flag
CHUNK = 8


class GmresCycle:
    """calibr8_tpu's gmres_cycle (its while_loop body, solve/gmres.py:
    57-157 there) over fixed-shape device buffers: the basis V (m + 1, n),
    the rotated Hessenberg columns RT (m, m), the residual recurrence g,
    and 0-d tensors k_used, res and active.

    The k previous Givens rotations that calibr8_tpu sweeps over the new
    Hessenberg column one scalar step at a time are kept as their product
    Q, an (m + 1)-square orthogonal matrix, and applied as one
    (k + 2)-square product; the new rotation then updates two rows of Q.
    That is a fixed handful of launches an iteration where the sweep is k.
    It rounds differently: each entry of the rotated column is one dot
    product of Q's row with h instead of k nested rotations, an
    O(k eps ||h||) difference."""

    def __init__(self, m: int, n: int, dtype, device):
        self.m = m
        self.tiny = 1e-30 if dtype == torch.float32 else 1e-290
        z = dict(dtype=dtype, device=device)
        self.V = torch.zeros((m + 1, n), **z)
        self.Q = torch.zeros((m + 1, m + 1), **z)
        self.RT = torch.zeros((m, m), **z)
        self.g = torch.zeros(m + 1, **z)
        self.res = torch.zeros((), **z)
        self.atol = torch.zeros((), **z)
        self.k_used = torch.zeros((), dtype=torch.int32, device=device)
        self.active = torch.zeros((), dtype=torch.bool, device=device)
        self._eye = torch.eye(m + 1, **z)

    def start(self, r0, atol, live=None):
        """Begin a cycle from the residual r0 with target atol (0-d
        tensors both); `live`, a 0-d bool, masks the whole cycle off."""
        tiny = self.tiny
        beta = _nrm(r0)
        self.V.zero_()
        self.V[0] = r0 / torch.clamp_min(beta, tiny)
        self.Q.copy_(self._eye)
        self.RT.zero_()
        self.g.zero_()
        self.g[0] = beta
        self.res.copy_(beta)
        self.atol.copy_(atol)
        self.k_used.zero_()
        act = (beta > self.atol) & (beta > tiny)
        self.active.copy_(act if live is None else act & live)

    def step(self, opM, k: int):
        """Iteration k (static) of the cycle: a no-op once inactive."""
        tiny, a = self.tiny, self.active
        V, Q = self.V, self.Q
        Vk = V[: k + 1]
        w = opM(V[k])
        # CGS2 against the first k + 1 basis vectors
        h1 = Vk @ w
        w = w - h1 @ Vk
        h2 = Vk @ w
        w = w - h2 @ Vk
        hk1 = _nrm(w)
        V[k + 1] = torch.where(a, w / torch.clamp_min(hk1, tiny), V[k + 1])
        # the k previous rotations at once: Q's row k + 1 is still e_{k+1}
        hr = Q[: k + 2, : k + 2] @ torch.cat([h1 + h2, hk1[None]])
        hk, hk1r = hr[k], hr[k + 1]
        den = torch.sqrt(hk * hk + hk1r * hk1r)
        ok = den > tiny
        c = torch.where(ok, hk / torch.clamp_min(den, tiny), 1.0)
        s = torch.where(ok, hk1r / torch.clamp_min(den, tiny), 0.0)
        rows = Q[k : k + 2, : k + 2]
        rot = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
        Q[k : k + 2, : k + 2] = torch.where(a, rot @ rows, rows)
        col = torch.cat([hr[:k], den[None]])
        self.RT[k, : k + 1] = torch.where(a, col, self.RT[k, : k + 1])
        gk = self.g[k]
        res_new = torch.abs(-s * gk)
        self.g[k : k + 2] = torch.where(a, torch.stack([c * gk, -s * gk]), self.g[k : k + 2])
        self.res.copy_(torch.where(a, res_new, self.res))
        self.k_used.add_(a.to(torch.int32))
        self.active.copy_(a & (hk1 > tiny) & (res_new > self.atol) & (k + 1 < self.m))

    def run(self, opM, runner):
        """The iterations after `start`, CHUNK at a time through
        runner.run(("chunk", k0, n), fn), with one runner.read of `active`
        after each chunk: at most CHUNK - 1 iterations run masked off."""
        for k0 in range(0, self.m, CHUNK):
            n = min(CHUNK, self.m - k0)

            def iterations(k0=k0, n=n):
                for k in range(k0, k0 + n):
                    self.step(opM, k)

            runner.run(("chunk", k0, n), iterations)
            if not runner.read(self.active):
                break

    def finish(self):
        """dy from the back substitution on the m x m R, padded to identity
        on the columns the cycle never reached (calibr8_tpu's padding)."""
        m, tiny = self.m, self.tiny
        R = self.RT.T
        mask = torch.arange(m, device=R.device) < self.k_used
        d = torch.diagonal(R)
        R = R + torch.diag(torch.where(mask & (d.abs() > tiny), 0.0, 1.0).to(R.dtype))
        gm = torch.where(mask, self.g[:m], 0.0)
        y = torch.linalg.solve_triangular(R, gm[:, None], upper=True)[:, 0]
        return y @ self.V[:m]


class EagerRunner:
    """Runs each piece of a sync-free solve as it comes and reads flags
    with .item() (the CPU route; on the card solve/jit_newton.py's
    GraphRunner captures and replays the pieces instead)."""

    def __init__(self):
        self.reads = 0
        self.n_replays = 0

    def run(self, key, fn):
        fn()

    def read(self, t):
        self.reads += 1
        return t.item()

