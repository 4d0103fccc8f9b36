"""Uniform nested refinement: the multigrid hierarchy of a builtin mesh.

The counterpart of calibr8_tpu's mesh/refine.py (the reference's
NestedDisc, nested.{hpp,cpp}): every edge gets a midpoint node, each
triangle splits into 4 children, each tet into 8 (4 corner tets and the
octahedron split along its m01-m23 diagonal), children are oriented
positively, and the sets follow the children.  When the fine nodes form
a full regular lattice (refined builtin cubes and squares) they are
renumbered lexicographically, x fastest.

The fine mesh is the same as calibr8_tpu's, array for array (coords,
conn, node_parents, elem_parent, sets): the multigrid transfers and
every parity check rest on that numbering.  calibr8_tpu builds the edge
table and the children with two native helpers (native/src/
calibr8_native.cpp: c8_unique_edges, c8_refine_children); here they are
vectorised numpy with the same output order.

Returns the fine Mesh plus
  node_parents : (n_fine_nodes, 2)  the two nodes averaged to make each
                 fine node, (a, a) for an original vertex
  elem_parent  : (n_fine_elems,)    the parent element of each child
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from calibr8_tpu_torch.mesh.mesh import Mesh, local_facets

# local node pairs in the order of the edge-midpoint table (refine.py and
# c8_refine_children): (0,1),(0,2),(1,2) in 2D; (0,1),(0,2),(0,3),(1,2),
# (1,3),(2,3) in 3D
_PAIRS = {2: [(0, 1), (0, 2), (1, 2)], 3: [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]}

# children per slot: a parent vertex (int) or the midpoint of edge "ij"
_CHILDREN = {
    2: [(0, "01", "02"), (1, "12", "01"), (2, "02", "12"), ("01", "12", "02")],
    3: [
        (0, "01", "02", "03"),
        (1, "01", "12", "13"),
        (2, "02", "12", "23"),
        (3, "03", "13", "23"),
        # octahedron split along the m01-m23 diagonal
        ("01", "12", "02", "23"),
        ("01", "12", "23", "13"),
        ("01", "02", "03", "23"),
        ("01", "03", "13", "23"),
    ],
}


@dataclass
class Refinement:
    fine: Mesh
    node_parents: np.ndarray  # (n_fine_nodes, 2)
    elem_parent: np.ndarray  # (n_fine_elems,)


def uniform_refine(mesh: Mesh) -> Refinement:
    dim = mesh.dim
    conn = np.asarray(mesh.conn, dtype=np.int64)
    n_nodes = mesh.n_nodes
    pairs = _PAIRS[dim]
    n_elem = conn.shape[0]

    # unique edges, lexicographic (np.unique(axis=0), as c8_unique_edges)
    edges = np.concatenate([np.sort(conn[:, [i, j]], axis=1) for (i, j) in pairs], axis=0)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mids = n_nodes + inv.reshape(len(pairs), n_elem)  # midpoint node ids

    coords = np.concatenate(
        [mesh.coords, 0.5 * (mesh.coords[uniq[:, 0]] + mesh.coords[uniq[:, 1]])], axis=0
    )
    node_parents = np.concatenate([np.stack([np.arange(n_nodes)] * 2, axis=1), uniq], axis=0)

    # children (n_elem, nchild, npe), then flip slots 1 and 2 of any
    # child with a negative orientation (c8_refine_children)
    def col(tok):
        if isinstance(tok, int):
            return conn[:, tok]
        return mids[pairs.index((int(tok[0]), int(tok[1])))]

    ch = np.stack([np.stack([col(t) for t in c], axis=1) for c in _CHILDREN[dim]], axis=1)
    p = coords[ch]  # (n_elem, nchild, npe, dim)
    det = np.linalg.det(p[:, :, 1:] - p[:, :, :1])
    flip = det < 0.0
    ch[flip, 1], ch[flip, 2] = ch[flip, 2], ch[flip, 1]
    npe = dim + 1
    fine_conn = ch.reshape(-1, npe)
    elem_parent = np.repeat(np.arange(n_elem, dtype=np.int64), len(_CHILDREN[dim]))
    return _finish_refine(mesh, coords, node_parents, uniq, fine_conn, elem_parent)


def _finish_refine(mesh, coords, node_parents, uniq, fine_conn, elem_parent):
    """Propagate node, side and element sets to the refined mesh."""
    dim = mesh.dim
    conn = np.asarray(mesh.conn)
    n_nodes = mesh.n_nodes

    # node sets: the originals, then the midpoints whose both endpoints
    # are members
    node_sets = {}
    for name, nodes in mesh.node_sets.items():
        member = np.zeros(n_nodes, dtype=bool)
        member[np.asarray(nodes)] = True
        mid_in = member[uniq[:, 0]] & member[uniq[:, 1]]
        node_sets[name] = np.concatenate([np.asarray(nodes), n_nodes + np.where(mid_in)[0]])

    # side sets: the facets of the side's parent elements' children whose
    # nodes all lie on a parent facet of the side (its nodes and their
    # edge midpoints), in (child, facet) order
    lf = local_facets(dim)
    edge_key = uniq[:, 0] * coords.shape[0] + uniq[:, 1]
    side_sets = {}
    for name, ss in mesh.side_sets.items():
        ss = np.asarray(ss).reshape(-1, 2)
        allowed = np.zeros(coords.shape[0], dtype=bool)
        fnodes = conn[ss[:, 0][:, None], lf[ss[:, 1]]]  # (n_sides, dim)
        allowed[fnodes.reshape(-1)] = True
        for i in range(dim):
            for j in range(i + 1, dim):
                a = np.minimum(fnodes[:, i], fnodes[:, j])
                b = np.maximum(fnodes[:, i], fnodes[:, j])
                allowed[n_nodes + np.searchsorted(edge_key, a * coords.shape[0] + b)] = True
        in_parent = np.isin(elem_parent, np.unique(ss[:, 0]))
        hit = np.stack([allowed[fine_conn[:, lf[f]]].all(axis=1) for f in range(lf.shape[0])],
                       axis=1) & in_parent[:, None]
        fe, f = np.nonzero(hit)
        side_sets[name] = np.stack([fe, f], axis=1).astype(np.int64).reshape(-1, 2)

    elem_sets = {name: np.where(np.isin(elem_parent, np.asarray(idx)))[0]
                 for name, idx in mesh.elem_sets.items()}

    # lattice renumbering: on a full regular lattice the fine nodes are
    # renumbered lexicographically (x fastest); consumers index
    # node_parents / coords / conn by fine node id, so the permutation is
    # transparent to them
    order = _lattice_order(coords)
    if order is not None:
        old2new = np.empty(coords.shape[0], dtype=np.int64)
        old2new[order] = np.arange(coords.shape[0])
        coords = coords[order]
        fine_conn = old2new[fine_conn]
        node_parents = node_parents[order]
        node_sets = {k: old2new[v] for k, v in node_sets.items()}

    fine = Mesh(dim=dim, coords=coords, conn=fine_conn, elem_sets=elem_sets,
                node_sets=node_sets, side_sets=side_sets, fields={})
    return Refinement(fine=fine, node_parents=node_parents, elem_parent=elem_parent)


def _lattice_order(coords: np.ndarray):
    """Old-id order (new id -> old id) of the lexicographic (..., z, y, x)
    numbering when the nodes form a full regular lattice; None otherwise
    (unstructured meshes keep the append-midpoints numbering)."""
    n, dim = coords.shape
    idx, sizes = [], []
    for d in range(dim):
        c = coords[:, d]
        lo, span = c.min(), c.max() - c.min()
        if span <= 0.0:
            return None
        # quantized against float fuzz: midpoints are exact averages of
        # generator linspace values, 2^-40 of the box is far below any
        # node spacing
        q = np.round((c - lo) / span * (1 << 40)).astype(np.int64)
        u = np.unique(q)
        idx.append(np.searchsorted(u, q))
        sizes.append(len(u))
    if int(np.prod(sizes)) != n:
        return None
    key = idx[dim - 1]
    for d in range(dim - 2, -1, -1):
        key = key * sizes[d] + idx[d]
    if len(np.unique(key)) != n:
        return None
    return np.argsort(key)
