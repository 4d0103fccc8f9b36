"""Built-in mesh generators for the reference test geometries.

The reference ships pre-built PUMI meshes for three geometries
(reference: source/calibr8/test/mesh/{cube,notch2D,notch}): a unit cube,
a 2D unit square with a quarter-circle notch of radius 0.2 at the origin
(reference: source/calibr8/test/mesh/notch2D/notch2D.cpp), and its 3D
extrusion.  These generators produce the same geometries with the same
named node/side/elem sets so the reference test decks run unmodified.

Pure numpy, host-side; the element loops are vectorized, and every
array matches calibr8_tpu's generators exactly.
"""

from __future__ import annotations

import numpy as np

from calibr8_tpu_torch.mesh.mesh import Mesh, local_facets

_TOL = 1e-9


def _build_side_set(mesh_dim, conn, coords, predicate):
    """Find boundary facets whose nodes all satisfy a predicate.

    Returns (n_faces, 2) (elem, local_facet) pairs sorted by (elem,
    facet).  A boundary facet is one that no other element shares.
    """
    lf = local_facets(mesh_dim)
    fn = conn[:, lf].reshape(-1, lf.shape[1])  # (n_elem * n_facets, nfn)
    key = np.sort(fn, axis=1)
    _, inv, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    boundary = counts[inv.reshape(-1)] == 1
    inside = np.asarray(predicate(coords[key.reshape(-1)])).reshape(key.shape)
    ids = np.nonzero(boundary & inside.all(axis=1))[0]
    return np.stack([ids // lf.shape[0], ids % lf.shape[0]], axis=1).astype(
        np.int64
    ).reshape(-1, 2)


def cube(n: int = 2) -> Mesh:
    """Structured tet mesh of the unit cube, 6 tets per hex cell.

    Node/side sets: xmin, ymin, zmin, ymax (+ xmax, zmax), elem set 'body'
    (reference: source/calibr8/test/mesh/cube/cube.txt).
    """
    d = np.linspace(0.0, 1.0, n + 1)
    X, Y, Z = np.meshgrid(d, d, d, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (n + 1) + j) * (n + 1) + k

    # 6-tet (Kuhn) decomposition of each cell — all share the main diagonal
    kuhn = [
        (0, 1, 3, 7),
        (0, 1, 5, 7),
        (0, 2, 3, 7),
        (0, 2, 6, 7),
        (0, 4, 5, 7),
        (0, 4, 6, 7),
    ]
    corner_off = [
        (0, 0, 0),
        (0, 0, 1),
        (0, 1, 0),
        (0, 1, 1),
        (1, 0, 0),
        (1, 0, 1),
        (1, 1, 0),
        (1, 1, 1),
    ]
    ijk = np.stack(
        np.meshgrid(np.arange(n), np.arange(n), np.arange(n), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)  # cells in (i, j, k) lexicographic order
    cell = np.stack(
        [nid(ijk[:, 0] + o[0], ijk[:, 1] + o[1], ijk[:, 2] + o[2]) for o in corner_off],
        axis=1,
    )  # (n_cells, 8)
    conn = cell[:, np.asarray(kuhn)].reshape(-1, 4)  # (n_cells * 6, 4)
    # fix orientation (positive volume)
    p = coords[conn]
    v = np.linalg.det(p[:, 1:] - p[:, :1])
    neg = v < 0
    conn[neg, 1], conn[neg, 2] = conn[neg, 2].copy(), conn[neg, 1].copy()
    conn = conn.astype(np.int64)

    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    node_sets = {
        "xmin": np.where(x < _TOL)[0],
        "xmax": np.where(x > 1 - _TOL)[0],
        "ymin": np.where(y < _TOL)[0],
        "ymax": np.where(y > 1 - _TOL)[0],
        "zmin": np.where(z < _TOL)[0],
        "zmax": np.where(z > 1 - _TOL)[0],
    }
    side_sets = {
        "xmin": _build_side_set(3, conn, coords, lambda p: p[:, 0] < _TOL),
        "xmax": _build_side_set(3, conn, coords, lambda p: p[:, 0] > 1 - _TOL),
        "ymin": _build_side_set(3, conn, coords, lambda p: p[:, 1] < _TOL),
        "ymax": _build_side_set(3, conn, coords, lambda p: p[:, 1] > 1 - _TOL),
        "zmin": _build_side_set(3, conn, coords, lambda p: p[:, 2] < _TOL),
        "zmax": _build_side_set(3, conn, coords, lambda p: p[:, 2] > 1 - _TOL),
    }
    return Mesh(
        dim=3,
        coords=coords,
        conn=conn,
        elem_sets={"body": np.arange(conn.shape[0])},
        node_sets=node_sets,
        side_sets=side_sets,
    )


def square(n: int = 8, lx: float = 1.0, ly: float = 1.0) -> Mesh:
    """Structured triangle mesh of a rectangle (2 tris per quad)."""
    dx = np.linspace(0.0, lx, n + 1)
    dy = np.linspace(0.0, ly, n + 1)
    X, Y = np.meshgrid(dx, dy, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (n + 1) + j

    conn = []
    for i in range(n):
        for j in range(n):
            a, b = nid(i, j), nid(i + 1, j)
            c, d = nid(i + 1, j + 1), nid(i, j + 1)
            conn.append([a, b, c])
            conn.append([a, c, d])
    conn = np.asarray(conn, dtype=np.int64)
    x, y = coords[:, 0], coords[:, 1]
    node_sets = {
        "xmin": np.where(x < _TOL)[0],
        "xmax": np.where(x > lx - _TOL)[0],
        "ymin": np.where(y < _TOL)[0],
        "ymax": np.where(y > ly - _TOL)[0],
    }
    side_sets = {
        "xmin": _build_side_set(2, conn, coords, lambda p: p[:, 0] < _TOL),
        "xmax": _build_side_set(2, conn, coords, lambda p: p[:, 0] > lx - _TOL),
        "ymin": _build_side_set(2, conn, coords, lambda p: p[:, 1] < _TOL),
        "ymax": _build_side_set(2, conn, coords, lambda p: p[:, 1] > ly - _TOL),
    }
    return Mesh(
        dim=2,
        coords=coords,
        conn=conn,
        elem_sets={"body": np.arange(conn.shape[0])},
        node_sets=node_sets,
        side_sets=side_sets,
    )


def notch2d(h: float = 0.075, radius: float = 0.2) -> Mesh:
    """Unit square with a quarter-circle notch of given radius at the
    origin (reference geometry: source/calibr8/test/mesh/notch2D/notch2D.cpp:
    points (0.2,0)-(1,0)-(1,1)-(0,1)-(0,0.2) closed by an arc about the
    origin, target size 0.075).

    Delaunay-based unstructured generator: boundary points at spacing ~h,
    interior points on an offset grid, scipy Delaunay, triangles filtered
    to the domain.
    """
    from scipy.spatial import Delaunay

    r = radius
    pts = []

    def seg(p0, p1, include_start=False):
        p0, p1 = np.asarray(p0), np.asarray(p1)
        L = np.linalg.norm(p1 - p0)
        n = max(1, int(round(L / h)))
        ts = np.linspace(0.0, 1.0, n + 1)
        if not include_start:
            ts = ts[1:]
        for t in ts[:-1]:
            pts.append(p0 + t * (p1 - p0))
        pts.append(p1)

    # boundary loop: (r,0) -> (1,0) -> (1,1) -> (0,1) -> (0,r) -> arc -> (r,0)
    pts.append(np.array([r, 0.0]))
    seg([r, 0], [1, 0])
    seg([1, 0], [1, 1])
    seg([1, 1], [0, 1])
    seg([0, 1], [0, r])
    # arc from (0, r) to (r, 0), excluding endpoints
    arc_len = 0.5 * np.pi * r
    na = max(2, int(round(arc_len / h)))
    thetas = np.linspace(0.5 * np.pi, 0.0, na + 1)[1:-1]
    for th in thetas:
        pts.append(np.array([r * np.cos(th), r * np.sin(th)]))

    boundary = np.asarray(pts)
    nb = boundary.shape[0]

    # interior: hex-offset grid clipped to the domain, away from boundary
    interior = []
    ny = int(round(1.0 / (h * np.sqrt(3) / 2)))
    nx = int(round(1.0 / h))
    for j in range(1, ny + 1):
        yv = j * h * np.sqrt(3) / 2
        if yv >= 1.0 - 0.4 * h:
            continue
        off = 0.5 * h if j % 2 else 0.0
        for i in range(0, nx + 2):
            xv = off + i * h
            if xv <= 0.4 * h or xv >= 1.0 - 0.4 * h:
                continue
            if xv * xv + yv * yv < (r + 0.6 * h) ** 2:
                continue
            d = np.min(np.linalg.norm(boundary - [xv, yv], axis=1))
            if d < 0.55 * h:
                continue
            interior.append([xv, yv])
    coords = np.vstack([boundary, np.asarray(interior)])

    tri = Delaunay(coords)
    cells = tri.simplices
    cents = coords[cells].mean(axis=1)
    keep = (cents**2).sum(axis=1) > r * r
    # drop slivers along the arc (all three nodes on boundary arc)
    conn = cells[keep]
    # enforce positive orientation
    p = coords[conn]
    det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    flip = det < 0
    conn[flip, 1], conn[flip, 2] = conn[flip, 2].copy(), conn[flip, 1].copy()
    conn = conn.astype(np.int64)

    x, y = coords[:, 0], coords[:, 1]
    tol = 1e-8
    node_sets = {
        "xmin": np.where(x < tol)[0],
        "xmax": np.where(x > 1 - tol)[0],
        "ymin": np.where(y < tol)[0],
        "ymax": np.where(y > 1 - tol)[0],
    }
    side_sets = {
        "xmin": _build_side_set(2, conn, coords, lambda p_: p_[:, 0] < tol),
        "xmax": _build_side_set(2, conn, coords, lambda p_: p_[:, 0] > 1 - tol),
        "ymin": _build_side_set(2, conn, coords, lambda p_: p_[:, 1] < tol),
        "ymax": _build_side_set(2, conn, coords, lambda p_: p_[:, 1] > 1 - tol),
    }
    return Mesh(
        dim=2,
        coords=coords,
        conn=conn,
        elem_sets={"body": np.arange(conn.shape[0])},
        node_sets=node_sets,
        side_sets=side_sets,
    )


def notch3d(h: float = 0.15, radius: float = 0.2, lz: float = 0.2, nz: int = 2) -> Mesh:
    """3D extrusion of the notch2D geometry (reference:
    source/calibr8/test/mesh/notch/notch.cpp), tets from extruded prisms."""
    m2 = notch2d(h=h, radius=radius)
    n2 = m2.n_nodes
    zs = np.linspace(0.0, lz, nz + 1)
    coords = np.concatenate(
        [
            np.concatenate([m2.coords, np.full((n2, 1), z)], axis=1)
            for z in zs
        ],
        axis=0,
    )
    conn = []
    for k in range(nz):
        lo, hi = k * n2, (k + 1) * n2
        for t in m2.conn:
            # Dompierre et al. prism split: rotate so the smallest global
            # index is vertex 0, then pick the diagonal template by
            # comparing indices — quad-face diagonals always pass through
            # each face's smallest vertex, so adjacent prisms conform.
            v = [int(t[0]) + lo, int(t[1]) + lo, int(t[2]) + lo,
                 int(t[0]) + hi, int(t[1]) + hi, int(t[2]) + hi]
            rot = int(np.argmin(v[:3]))
            perm = {
                0: [0, 1, 2, 3, 4, 5],
                1: [1, 2, 0, 4, 5, 3],
                2: [2, 0, 1, 5, 3, 4],
            }[rot]
            w = [v[p] for p in perm]
            if min(w[1], w[5]) < min(w[2], w[4]):
                prism_tets = [(0, 1, 2, 5), (0, 1, 5, 4), (0, 4, 5, 3)]
            else:
                prism_tets = [(0, 1, 2, 4), (0, 4, 2, 5), (0, 4, 5, 3)]
            for tt in prism_tets:
                tet = [w[i] for i in tt]
                p = coords[tet]
                d = np.linalg.det(p[1:] - p[0])
                if abs(d) < 1e-14:
                    continue
                if d < 0:
                    tet[1], tet[2] = tet[2], tet[1]
                conn.append(tet)
    conn = np.asarray(conn, dtype=np.int64)
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    tol = 1e-8
    node_sets = {
        "xmin": np.where(x < tol)[0],
        "xmax": np.where(x > 1 - tol)[0],
        "ymin": np.where(y < tol)[0],
        "ymax": np.where(y > 1 - tol)[0],
        "zmin": np.where(z < tol)[0],
        "zmax": np.where(z > lz - tol)[0],
    }
    side_sets = {
        "ymin": _build_side_set(3, conn, coords, lambda p: p[:, 1] < tol),
        "ymax": _build_side_set(3, conn, coords, lambda p: p[:, 1] > 1 - tol),
        "zmin": _build_side_set(3, conn, coords, lambda p: p[:, 2] < tol),
        "zmax": _build_side_set(3, conn, coords, lambda p: p[:, 2] > lz - tol),
    }
    return Mesh(
        dim=3,
        coords=coords,
        conn=conn,
        elem_sets={"body": np.arange(conn.shape[0])},
        node_sets=node_sets,
        side_sets=side_sets,
    )
