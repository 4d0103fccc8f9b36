"""Host-side mesh topology: static numpy index arrays.

  * coords      (n_nodes, dim)     nodal coordinates
  * conn        (n_elem, dim+1)    element -> node connectivity (P1 simplex)
  * elem_sets   name -> element index array (material blocks)
  * node_sets   name -> node index array (Dirichlet BCs)
  * side_sets   name -> (n_faces, 2) array of (elem, local_facet)

Elements are sorted so each elem set is a contiguous range
(`sorted_by_elem_set`), the same order calibr8_tpu uses, so element
arrays carry across the two packages unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# local facet -> facet node tuple (outward orientation), per dim.
# tri nodes (0,1,2): facet f is opposite node f.
TRI_FACETS = np.array([[1, 2], [2, 0], [0, 1]])
# tet nodes (0,1,2,3): facet f opposite node f, ordered for outward normals.
TET_FACETS = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]])


def local_facets(dim: int) -> np.ndarray:
    return TRI_FACETS if dim == 2 else TET_FACETS


@dataclass
class Mesh:
    dim: int
    coords: np.ndarray
    conn: np.ndarray
    elem_sets: dict[str, np.ndarray] = field(default_factory=dict)
    node_sets: dict[str, np.ndarray] = field(default_factory=dict)
    side_sets: dict[str, np.ndarray] = field(default_factory=dict)
    # optional nodal fields attached to the mesh (measured data)
    fields: dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.conn.shape[0]

    @property
    def nodes_per_elem(self) -> int:
        return self.conn.shape[1]

    def sorted_by_elem_set(self) -> tuple["Mesh", dict[str, tuple[int, int]]]:
        """Reorder elements so each elem set is contiguous.

        Returns the new mesh and name -> (start, stop) ranges.  Elements
        not in any set are dropped.
        """
        order = []
        ranges: dict[str, tuple[int, int]] = {}
        for name, idx in self.elem_sets.items():
            start = len(order)
            order.extend(np.asarray(idx, dtype=np.int64).tolist())
            ranges[name] = (start, len(order))
        order = np.asarray(order, dtype=np.int64)
        old_to_new = -np.ones(self.n_elems, dtype=np.int64)
        old_to_new[order] = np.arange(order.size)
        new_side_sets = {}
        for name, ss in self.side_sets.items():
            ss = np.asarray(ss)
            keep = old_to_new[ss[:, 0]] >= 0
            new_ss = ss[keep].copy()
            new_ss[:, 0] = old_to_new[new_ss[:, 0]]
            new_side_sets[name] = new_ss
        m = Mesh(
            dim=self.dim,
            coords=self.coords,
            conn=self.conn[order],
            elem_sets={
                name: np.arange(r[0], r[1], dtype=np.int64)
                for name, r in ranges.items()
            },
            node_sets=dict(self.node_sets),
            side_sets=new_side_sets,
            fields=dict(self.fields),
        )
        return m, ranges

    def element_h(self) -> np.ndarray:
        """Stabilization length per element: sqrt(mean of squared edge
        lengths) (reference: mechanics.cpp:104-115 get_size)."""
        conn = self.conn
        x = self.coords[conn]  # (n_elem, npe, dim)
        npe = conn.shape[1]
        pairs = [(i, j) for i in range(npe) for j in range(i + 1, npe)]
        l2 = np.stack(
            [((x[:, i] - x[:, j]) ** 2).sum(axis=1) for (i, j) in pairs], axis=1
        )
        return np.sqrt(l2.mean(axis=1))

    def validate(self) -> None:
        if self.conn.min() < 0 or self.conn.max() >= self.n_nodes:
            raise ValueError("mesh connectivity refers to a missing node")
        if self.conn.shape[1] != self.dim + 1:
            raise ValueError(
                f"expected P1 simplices with {self.dim + 1} nodes, got "
                f"{self.conn.shape[1]}"
            )
        for name, idx in self.node_sets.items():
            if np.asarray(idx).ndim != 1:
                raise ValueError(f"node set {name!r} is not a flat index list")
