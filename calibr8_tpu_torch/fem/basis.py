"""Simplex P1 basis functions and quadrature tables.

TPU-first design note: the reference evaluates basis functions through
apf::getBF / apf::getGradBF per integration point per element inside the
assembly loop (reference: source/calibr8/src/weight.cpp:10-13,
evaluations.cpp:77-85).  Here the parent-element tables are tiny static
numpy constants; the per-element physical gradients and measures are
precomputed once as dense device arrays (see fem/geometry.py) so the hot
assembly kernels are pure batched tensor contractions.

Quadrature rules match the apf integration rules used by the reference
(apf::countIntPoints/getIntPoint/getIntWeight with "ip sets" of order 1
and 2 — reference: source/calibr8/src/mechanics.cpp:41-47): weights sum
to the parent simplex measure and are multiplied by |det J| at use sites.
"""

from __future__ import annotations

import numpy as np

# ----------------------------------------------------------------------
# Parent-element shape functions (barycentric P1 on tri / tet)
# ----------------------------------------------------------------------


def shape_values(dim: int, pts: np.ndarray) -> np.ndarray:
    """P1 shape function values at parent points.

    pts: (npts, dim) parent coordinates (xi, eta[, zeta]).
    Returns (npts, dim+1) with node 0 at the origin-opposite vertex
    ordering N0 = 1 - sum(xi), N_i = xi_{i-1}.
    """
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, dim)
    n0 = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([n0, pts], axis=1)


def shape_grads_parent(dim: int) -> np.ndarray:
    """Constant parent-space gradients dN/dxi, shape (dim+1, dim)."""
    g = np.zeros((dim + 1, dim))
    g[0, :] = -1.0
    g[1:, :] = np.eye(dim)
    return g


# ----------------------------------------------------------------------
# Quadrature rules on the parent simplex
# ----------------------------------------------------------------------

# Parent measures: triangle area 1/2, tet volume 1/6.


def quadrature(dim: int, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (points (npts, dim), weights (npts,)) on the parent simplex.

    Weights sum to the parent measure; multiply by |det J| for physical
    integration (the apf convention: getIntWeight * getDV).
    """
    if dim == 2:
        if order <= 1:
            pts = np.array([[1.0 / 3.0, 1.0 / 3.0]])
            wts = np.array([0.5])
        elif order == 2:
            pts = np.array(
                [
                    [1.0 / 6.0, 1.0 / 6.0],
                    [2.0 / 3.0, 1.0 / 6.0],
                    [1.0 / 6.0, 2.0 / 3.0],
                ]
            )
            wts = np.full(3, 1.0 / 6.0)
        elif order == 3:
            # 6-point degree-3 rule
            a = 0.659027622374092
            b = 0.231933368553031
            c = 0.109039009072877
            pts = np.array(
                [[a, b], [b, a], [a, c], [c, a], [b, c], [c, b]]
            )
            wts = np.full(6, 0.5 / 6.0)
        else:
            raise NotImplementedError(f"tri quadrature order {order}")
    elif dim == 3:
        if order <= 1:
            pts = np.array([[0.25, 0.25, 0.25]])
            wts = np.array([1.0 / 6.0])
        elif order == 2:
            a = 0.5854101966249685  # (5 + 3*sqrt(5)) / 20
            b = 0.1381966011250105  # (5 - sqrt(5)) / 20
            pts = np.array(
                [
                    [b, b, b],
                    [a, b, b],
                    [b, a, b],
                    [b, b, a],
                ]
            )
            wts = np.full(4, 1.0 / 24.0)
        elif order == 3:
            # 5-point degree-3 rule (with negative centroid weight)
            pts = np.array(
                [
                    [0.25, 0.25, 0.25],
                    [0.5, 1.0 / 6.0, 1.0 / 6.0],
                    [1.0 / 6.0, 0.5, 1.0 / 6.0],
                    [1.0 / 6.0, 1.0 / 6.0, 0.5],
                    [1.0 / 6.0, 1.0 / 6.0, 1.0 / 6.0],
                ]
            )
            wts = np.array([-4.0 / 30.0, 0.075, 0.075, 0.075, 0.075])
        else:
            raise NotImplementedError(f"tet quadrature order {order}")
    else:
        raise ValueError(f"unsupported dim {dim}")
    return pts, wts


def facet_quadrature(dim: int, order: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the parent facet (edge for 2D, tri for 3D)."""
    if dim == 2:
        # edge [0, 1]
        if order <= 1:
            return np.array([[0.5]]), np.array([1.0])
        # 2-pt Gauss
        g = 0.5 / np.sqrt(3.0)
        return np.array([[0.5 - g], [0.5 + g]]), np.array([0.5, 0.5])
    elif dim == 3:
        return quadrature(2, order)
    raise ValueError(f"unsupported dim {dim}")


def facet_shape_values(dim: int, pts: np.ndarray) -> np.ndarray:
    """P1 shape values on the parent facet: (npts, dim) facet nodes."""
    return shape_values(dim - 1, pts)
