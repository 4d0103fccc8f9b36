"""Per-element geometric quantities, precomputed on the host.

For affine P1 simplices the physical shape gradients and |det J| are
constant per element (reference: source/calibr8/src/evaluations.cpp:77-85
recomputes them per integration point), so they are computed once into
dense (n_elem, ...) numpy arrays that the Disc moves to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from calibr8_tpu_torch.fem import basis
from calibr8_tpu_torch.mesh.mesh import Mesh, local_facets


@dataclass
class ElemGeom:
    """grad_N (n_elem, npe, dim) physical shape-fn gradients; detJ
    (n_elem,) |det J|; h (n_elem,) stabilization size
    (mechanics.cpp:104-115)."""

    grad_N: np.ndarray
    detJ: np.ndarray
    h: np.ndarray


def compute_elem_geom(mesh: Mesh) -> ElemGeom:
    x = mesh.coords[mesh.conn]  # (n_elem, npe, dim)
    # J[e, i, j] = d x_i / d xi_j = sum_n x[n, i] * dN_n/dxi_j
    gp = basis.shape_grads_parent(mesh.dim)  # (npe, dim)
    J = np.einsum("enk,nj->ekj", x, gp)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    grad_N = np.einsum("nj,eji->eni", gp, Jinv)
    return ElemGeom(grad_N=grad_N, detJ=detJ, h=mesh.element_h())


@dataclass
class FacetGeom:
    """Per-facet geometry for side-set integrals (traction BCs,
    reference: source/calibr8/src/tbcs.cpp): nodes (n_faces, dim),
    area (n_faces,), outward unit normal (n_faces, dim), adjacent elem
    (n_faces,)."""

    nodes: np.ndarray
    area: np.ndarray
    normal: np.ndarray
    elem: np.ndarray


def compute_facet_geom(mesh: Mesh, side_set: str) -> FacetGeom:
    ss = np.asarray(mesh.side_sets[side_set])
    lf = local_facets(mesh.dim)
    fnodes = mesh.conn[ss[:, 0][:, None], lf[ss[:, 1]]]
    p = mesh.coords[fnodes]  # (n_faces, dim, dim)
    if mesh.dim == 2:
        t = p[:, 1] - p[:, 0]
        area = np.linalg.norm(t, axis=1)
        normal = np.stack([t[:, 1], -t[:, 0]], axis=1) / area[:, None]
    else:
        c = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        nrm = np.linalg.norm(c, axis=1)
        area = 0.5 * nrm
        normal = c / nrm[:, None]
    # orient outward: flip if pointing toward the element centroid
    cent_e = mesh.coords[mesh.conn[ss[:, 0]]].mean(axis=1)
    cent_f = p.mean(axis=1)
    flip = np.einsum("fd,fd->f", normal, cent_f - cent_e) < 0
    normal[flip] *= -1.0
    return FacetGeom(nodes=fnodes, area=area, normal=normal, elem=ss[:, 0])
