"""The smoother pieces of calibr8_tpu's solve/amg.py that its recursive
geometric multigrid uses (solve/mg.py): the power-iteration bound on the
spectrum of D^-1 A and the Chebyshev polynomial smoother (the Ifpack2
recurrence, the reference's AMG smoother family, linear_solve.cpp).

The aggregation AMG of that module (AMGPrecondFactory) is not ported:
decks that ask for it raise NotImplementedError (problem.py).
"""

from __future__ import annotations

import torch


def power_lmax(matvec, dinv_apply, n: int, dtype, device, iters: int = 10) -> float:
    """Largest eigenvalue estimate of D^-1 A by `iters` power iterations
    from calibr8_tpu's deterministic start sin(12.9898 i + 0.5)
    (amg.py:251 _power_lmax), then one more product."""
    v = torch.sin(torch.arange(n, dtype=dtype, device=device) * 12.9898 + 0.5)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = dinv_apply(matvec(v))
        v = w / torch.linalg.vector_norm(w).clamp(min=1e-30)
    w = dinv_apply(matvec(v))
    return max(float(torch.linalg.vector_norm(w)), 1e-12)


def chebyshev(matvec, dinv_apply, lmax: float, degree: int = 6, ratio: float = 12.0):
    """Chebyshev smoother of the given degree on [lmax / ratio, 1.1 lmax]
    of D^-1 A (amg.py:269 _chebyshev): degree products with A per call.
    calibr8_tpu's loop also updates the residual after its last step,
    which nothing reads; that product is not made here."""
    beta = 1.1 * lmax
    alpha = lmax / ratio
    theta = 0.5 * (beta + alpha)
    delta = 0.5 * (beta - alpha)
    sigma = theta / delta

    def smooth(b):
        x = dinv_apply(b) / theta
        r = b - matvec(x)
        d, rho = x, 1.0 / sigma
        for k in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * dinv_apply(r)
            x = x + d
            if k < degree - 2:
                r = r - matvec(d)
            rho = rho_new
        return x

    return smooth
