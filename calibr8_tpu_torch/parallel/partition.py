"""Host-side domain decomposition: element partition, node ownership,
halo index maps.

The port's own copy of calibr8_tpu's parallel/partition.py (numpy only;
the port imports nothing of calibr8_tpu), array for array the same:

  * elements -> parts by recursive coordinate bisection of centroids;
  * node ownership: a node shared by several parts is OWNED by the
    lowest-numbered part that touches it;
  * every part's LOCAL node space is [owned block | ghost block], both
    padded to static sizes;
  * pairwise halo maps (send_slots/recv_slots) give, for every ordered
    part pair (k, j), which of k's owned slots part j needs as ghosts:
    one exchange over these maps is the Tpetra Import (owned -> ghost
    copy), and in reverse the Export-ADD (ghost contributions reduced
    onto owners), as in the reference's Disc::build_data
    (source/calibr8/src/disc.cpp:293-321, linear_alg.hpp:15-53);
  * per-part node-block ELLPACK maps over the local node space
    (build_local_ell).

parallel/dist.py consumes only the index arrays of Partition.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Partition:
    n_parts: int
    n_nodes: int
    npe: int
    # -- elements -------------------------------------------------------
    E_loc: int  # padded element count per part
    elems: np.ndarray  # (n_parts, E_loc) global element id, -1 = padding
    # -- nodes ----------------------------------------------------------
    N_own: int  # padded owned-node slots per part
    N_loc: int  # padded local slots per part ([owned | ghost])
    n_own: np.ndarray  # (n_parts,) actual owned counts
    own_nodes: np.ndarray  # (n_parts, N_own) global node id, -1 = padding
    local_nodes: np.ndarray  # (n_parts, N_loc) global node id, -1 = padding
    owner_of: np.ndarray  # (n_nodes,) owning part per node
    own_slot_of: np.ndarray  # (n_nodes,) slot within the owner's block
    conn_local: np.ndarray  # (n_parts, E_loc, npe) local slots; pad elems -> 0
    # -- halo exchange ----------------------------------------------------
    H: int  # padded per-pair exchange count
    # send_slots[k, j, :]: owned slots (in part k) that part j needs as
    # ghosts; padding = N_own (a dummy zero row device-side).
    send_slots: np.ndarray  # (n_parts, n_parts, H)
    # recv_slots[k, j, :]: local slots (in part k, ghost block) where the
    # values received from part j land; padding = N_loc (dummy row).
    recv_slots: np.ndarray  # (n_parts, n_parts, H)

    @property
    def n_elem_total(self) -> int:
        return int((self.elems >= 0).sum())


def rcb(points: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: split the longest axis at the
    load-balanced quantile.  Returns a part id per point."""
    n = points.shape[0]
    parts = np.zeros(n, dtype=np.int32)

    def rec(ids: np.ndarray, p0: int, count: int):
        if count == 1:
            parts[ids] = p0
            return
        c = points[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, ax], kind="stable")
        left = count // 2
        split = len(ids) * left // count
        rec(ids[order[:split]], p0, left)
        rec(ids[order[split:]], p0 + left, count - left)

    rec(np.arange(n), 0, n_parts)
    return parts


def build_partition(
    conn: np.ndarray,
    coords: np.ndarray,
    n_parts: int,
    pad_multiple: int = 8,
) -> Partition:
    """Build the full decomposition from element connectivity + node
    coordinates.  `pad_multiple` rounds the static sizes up, as
    calibr8_tpu does, so that the two packages' arrays are equal."""
    conn = np.asarray(conn)
    n_elem, npe = conn.shape
    n_nodes = coords.shape[0]
    centroids = coords[conn].mean(axis=1)
    part = rcb(centroids, n_parts) if n_parts > 1 else np.zeros(n_elem, np.int32)

    # node ownership: lowest part id touching the node
    owner_of = np.full(n_nodes, n_parts, dtype=np.int32)
    np.minimum.at(owner_of, conn.reshape(-1), np.repeat(part, npe))
    assert owner_of.max() < n_parts, "mesh has nodes untouched by any element"

    def pad_to(x: int) -> int:
        return -(-x // pad_multiple) * pad_multiple

    elems_per = [np.where(part == k)[0] for k in range(n_parts)]
    E_loc = pad_to(max(len(e) for e in elems_per))

    owned_per, ghosts_per = [], []
    for k in range(n_parts):
        touched = np.unique(conn[elems_per[k]])
        owned_per.append(touched[owner_of[touched] == k])
        g = touched[owner_of[touched] != k]
        # ghost block ordered by (owner part, global id) so the per-pair
        # recv slots are contiguous and consistent with the sender
        ghosts_per.append(g[np.lexsort((g, owner_of[g]))])

    n_own = np.array([len(o) for o in owned_per], dtype=np.int32)
    assert int(n_own.sum()) == n_nodes, "every node must be owned exactly once"
    N_own = pad_to(int(n_own.max()))
    N_ghost = pad_to(max(1, max(len(g) for g in ghosts_per)))
    N_loc = N_own + N_ghost

    own_slot_of = np.full(n_nodes, -1, dtype=np.int32)
    own_nodes = np.full((n_parts, N_own), -1, dtype=np.int32)
    local_nodes = np.full((n_parts, N_loc), -1, dtype=np.int32)
    for k in range(n_parts):
        own_nodes[k, : n_own[k]] = owned_per[k]
        own_slot_of[owned_per[k]] = np.arange(n_own[k], dtype=np.int32)
        local_nodes[k, : n_own[k]] = owned_per[k]
        local_nodes[k, N_own : N_own + len(ghosts_per[k])] = ghosts_per[k]

    # local connectivity (padding elements -> slot 0; their geometry is
    # zeroed downstream so their contributions vanish)
    elems = np.full((n_parts, E_loc), -1, dtype=np.int32)
    conn_local = np.zeros((n_parts, E_loc, npe), dtype=np.int32)
    for k in range(n_parts):
        glob2loc = np.full(n_nodes, -1, dtype=np.int32)
        glob2loc[local_nodes[k, : n_own[k]]] = np.arange(n_own[k])
        ng = len(ghosts_per[k])
        glob2loc[ghosts_per[k]] = N_own + np.arange(ng)
        ne = len(elems_per[k])
        elems[k, :ne] = elems_per[k]
        conn_local[k, :ne] = glob2loc[conn[elems_per[k]]]
        assert (conn_local[k, :ne] >= 0).all()

    # pairwise halo maps: G[k][j] = ghosts of k owned by j (sorted by id,
    # matching the ghost block order above)
    H = 1
    G = [[None] * n_parts for _ in range(n_parts)]
    for k in range(n_parts):
        g = ghosts_per[k]
        for j in range(n_parts):
            G[k][j] = np.sort(g[owner_of[g] == j])
            H = max(H, len(G[k][j]))
    send_slots = np.full((n_parts, n_parts, H), N_own, dtype=np.int32)
    recv_slots = np.full((n_parts, n_parts, H), N_loc, dtype=np.int32)
    for k in range(n_parts):
        glob2loc = np.full(n_nodes, -1, dtype=np.int32)
        ng = len(ghosts_per[k])
        glob2loc[ghosts_per[k]] = N_own + np.arange(ng)
        for j in range(n_parts):
            nodes = G[k][j]
            if len(nodes) == 0:
                continue
            # sender j -> receiver k
            send_slots[j, k, : len(nodes)] = own_slot_of[nodes]
            recv_slots[k, j, : len(nodes)] = glob2loc[nodes]

    part = Partition(
        n_parts=n_parts,
        n_nodes=n_nodes,
        npe=npe,
        E_loc=E_loc,
        elems=elems,
        N_own=N_own,
        N_loc=N_loc,
        n_own=n_own,
        own_nodes=own_nodes,
        local_nodes=local_nodes,
        owner_of=owner_of,
        own_slot_of=own_slot_of,
        conn_local=conn_local,
        H=H,
        send_slots=send_slots,
        recv_slots=recv_slots,
    )
    part.nbr_local, part.ell_idx_local, part.K_ell = build_local_ell(part)
    return part


def build_local_ell(part: Partition):
    """Per-part node-block ELLPACK maps over the LOCAL node space
    (the sharded analog of solve/ellpack.build_ell_maps): rows AND
    columns are local slots; ghost-row partial sums are reduced onto
    owners by the usual Export-ADD halo exchange after the apply.

    Returns (nbr (n_parts, N_loc, K), ell_idx (n_parts, E_loc, npe, npe),
    K); nbr pads with N_loc (a zero row device-side), ell_idx routes
    padding-element entries to a dummy trailing ELL slot."""
    P, E, npe = part.n_parts, part.E_loc, part.npe
    N_loc = part.N_loc
    per_part = []
    K = 1
    for k in range(P):
        mask = part.elems[k] >= 0
        conn = part.conn_local[k][mask]  # (n_real, npe)
        i = np.repeat(conn, npe, axis=1).reshape(-1).astype(np.int64)
        j = np.tile(conn, (1, npe)).reshape(-1).astype(np.int64)
        key = i * N_loc + j
        uniq, inv = np.unique(key, return_inverse=True)
        u_i = uniq // N_loc
        row_start = np.searchsorted(u_i, np.arange(N_loc))
        slot = np.arange(len(uniq)) - row_start[u_i]
        K = max(K, int(slot.max()) + 1 if len(slot) else 1)
        per_part.append((mask, conn.shape[0], uniq, inv, u_i, slot))

    nbr = np.full((P, N_loc, K), N_loc, dtype=np.int32)
    # dummy slot index = N_loc * K (an extra trailing row device-side)
    ell_idx = np.full((P, E, npe, npe), N_loc * K, dtype=np.int32)
    for k, (mask, n_real, uniq, inv, u_i, slot) in enumerate(per_part):
        nbr[k][u_i, slot] = (uniq % N_loc).astype(np.int32)
        flat = (u_i * K + slot)[inv].astype(np.int32)
        ell_idx[k][mask] = flat.reshape(n_real, npe, npe)
    return nbr, ell_idx, K
