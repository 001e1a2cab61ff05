"""Vectorized coboundary enumeration (Dory §4.2).

Port of ``src/repro/core/coboundary.py``: host numpy, unchanged semantics
(the keys it returns are what the packed engine ranks into bit blocks).

The paper enumerates coboundaries *lazily in filtration order* with
``FindSmallestt/FindNextt/FindGEQt`` — per-element binary searches and pointer
walks over sorted neighborhoods.  That shape of computation (data-dependent
early exit) has no efficient vector analogue, so we adapt the insight rather than
port the mechanics: the coboundary of an edge ``{a,b}`` is *one triangle per
common neighbor* ``v``, whose paired-index is a closed-form function of three
edge orders::

    kp = max(O_ab, O_av, O_bv)
    ks = v   if kp == O_ab        (paper's case 1: diameter = ab)
       = b   if kp == O_av        (case 2, diameter = av)
       = a   if kp == O_bv        (case 2, diameter = bv)

so the whole coboundary materializes as gathers + elementwise ops + one sort —
``O(max_deg)`` vectorized work per edge, batched over columns.  Same story for
triangles (one tetrahedron per common neighbor of the three vertices, key from
six edge orders).  ``FindGEQ``-style skipping survives as a *mask* over the
eagerly-enumerated keys.

Two lookup structures mirror the paper's two builds:
* ``ns``     — dense order-matrix gathers (DoryNS; ``O(n^2)`` memory),
* ``sparse`` — searchsorted intersection of padded sorted neighborhoods
               (Dory;   ``O(n_e)``   memory).
"""
from __future__ import annotations

import numpy as np

from .filtration import Filtration
from .pairing import EMPTY_KEY, pack_np

INT32_MAX = np.iinfo(np.int32).max


# ---------------------------------------------------------------------------
# Edge coboundaries (triangles)
# ---------------------------------------------------------------------------

def edge_cobdy_ns(filt: Filtration, e_orders: np.ndarray) -> np.ndarray:
    """Coboundary keys of a batch of edges, dense-order-matrix path.

    Returns (B, n) int64 packed keys, ascending, EMPTY_KEY padded.

    Near-clique fast path: with the dense order matrix the candidate
    third-vertices already arrive in ascending ``v`` order, and a case-1
    triangle's key is ``<o_ab, v>`` — so the case-1 keys of a row are
    *born sorted*, and every one of them precedes every case-2 key
    (``<m, a|b>`` with ``m > o_ab``, edge orders being globally unique).
    Instead of sorting the whole (B, n) row we compact case 1 with a
    cumsum scatter and lexsort only the case-2 subset, which is exactly
    the part that vanishes as the neighborhood approaches a clique whose
    diameter is the column's own edge (the H1* hot shape).
    """
    e_orders = np.asarray(e_orders, dtype=np.int64)
    a = filt.edges[e_orders, 0].astype(np.int64)
    b = filt.edges[e_orders, 1].astype(np.int64)
    oa = filt.order[a].astype(np.int64)           # (B, n)
    ob = filt.order[b].astype(np.int64)
    keys, c1 = _edge_keys_from_orders(
        e_orders[:, None], a[:, None], b[:, None],
        np.arange(filt.n, dtype=np.int64)[None, :], oa, ob,
        return_case1=True)
    B, n = keys.shape
    out = np.full_like(keys, EMPTY_KEY)
    n1 = c1.sum(axis=1)
    r1, v1 = np.nonzero(c1)
    if r1.size:
        out[r1, (np.cumsum(c1, axis=1) - 1)[r1, v1]] = keys[r1, v1]
    c2 = (keys != EMPTY_KEY) & ~c1
    r2, v2 = np.nonzero(c2)
    if r2.size:
        k2 = keys[r2, v2]
        o = np.lexsort((k2, r2))
        r2s, k2s = r2[o], k2[o]
        starts = np.searchsorted(r2s, np.arange(B, dtype=np.int64))
        rank = np.arange(r2s.size, dtype=np.int64) - starts[r2s]
        out[r2s, n1[r2s] + rank] = k2s
    return out


def edge_cobdy_sparse(filt: Filtration, e_orders: np.ndarray) -> np.ndarray:
    """Coboundary keys of a batch of edges via neighborhood intersection.

    Returns (B, max_deg) int64 packed keys, ascending, EMPTY_KEY padded.
    """
    e_orders = np.asarray(e_orders, dtype=np.int64)
    a = filt.edges[e_orders, 0].astype(np.int64)
    b = filt.edges[e_orders, 1].astype(np.int64)
    v = filt.nbr_vtx[a].astype(np.int64)          # (B, K) candidates from N^a
    oa = filt.nbr_vtx_ord[a].astype(np.int64)     # order of {a, v}
    ob = _lookup_order(filt, b, v)                # order of {b, v} or -1
    keys = _edge_keys_from_orders(e_orders[:, None], a[:, None], b[:, None],
                                  v, oa, ob)
    keys.sort(axis=1)
    return keys


def _edge_keys_from_orders(o_ab, a, b, v, oa, ob, return_case1=False):
    """Triangle keys for candidate third-vertices ``v`` (vectorized core).

    With ``return_case1`` also returns the mask of valid case-1 entries
    (diameter = the edge itself) for the sorted-partition fast path."""
    common = (oa >= 0) & (ob >= 0)
    m = np.maximum(oa, ob)
    kp = np.maximum(o_ab, m)
    case1 = m < o_ab
    ks = np.where(case1, v, np.where(oa > ob, b, a))
    keys = pack_np(kp, ks)
    keys = np.where(common, keys, EMPTY_KEY)
    if return_case1:
        return keys, common & case1
    return keys


def min_edge_cobdy_all(filt: Filtration, sparse: bool = True,
                       batch: int = 4096) -> np.ndarray:
    """Smallest cofacet key per edge, stored a priori (paper §4.3.5:
    "the smallest simplex in the coboundary of each edge is stored a priori
    at the cost of O(n_e) memory")."""
    out = np.full(filt.n_e, EMPTY_KEY, dtype=np.int64)
    fn = edge_cobdy_sparse if sparse else edge_cobdy_ns
    for s in range(0, filt.n_e, batch):
        ids = np.arange(s, min(s + batch, filt.n_e))
        keys = fn(filt, ids)
        out[ids] = keys[:, 0] if keys.shape[1] else EMPTY_KEY
    return out


# ---------------------------------------------------------------------------
# Triangle coboundaries (tetrahedra)
# ---------------------------------------------------------------------------

def tri_vertices(filt: Filtration, tri_keys: np.ndarray):
    """Vertices (a, b, c) of triangles given packed keys <kp, c>."""
    tri_keys = np.asarray(tri_keys, dtype=np.int64)
    kp = tri_keys >> 32
    c = tri_keys & np.int64((1 << 32) - 1)
    a = filt.edges[kp, 0].astype(np.int64)
    b = filt.edges[kp, 1].astype(np.int64)
    return a, b, c.astype(np.int64), kp


def tri_cobdy_ns(filt: Filtration, tri_keys: np.ndarray) -> np.ndarray:
    """Coboundary (tetrahedra) keys for a batch of triangles, NS path.

    Returns (B, n) int64 packed keys ascending, EMPTY_KEY padded.
    """
    a, b, c, kp = tri_vertices(filt, tri_keys)
    oa = filt.order[a].astype(np.int64)           # (B, n) order of {a, v}
    ob = filt.order[b].astype(np.int64)
    oc = filt.order[c].astype(np.int64)
    o_bc = filt.order[b, c].astype(np.int64)[:, None]
    o_ac = filt.order[a, c].astype(np.int64)[:, None]
    keys = _tri_keys_from_orders(kp[:, None], o_ac, o_bc, oa, ob, oc)
    keys.sort(axis=1)
    return keys


def tri_cobdy_sparse(filt: Filtration, tri_keys: np.ndarray) -> np.ndarray:
    """Coboundary keys for triangles via neighborhood intersection.

    Returns (B, max_deg) int64 keys ascending, EMPTY_KEY padded.
    """
    a, b, c, kp = tri_vertices(filt, tri_keys)
    v = filt.nbr_vtx[a].astype(np.int64)          # (B, K)
    oa = filt.nbr_vtx_ord[a].astype(np.int64)
    ob = _lookup_order(filt, b, v)
    oc = _lookup_order(filt, c, v)
    o_bc = _lookup_order(filt, b, c[:, None])
    o_ac = _lookup_order(filt, a, c[:, None])
    keys = _tri_keys_from_orders(kp[:, None], o_ac, o_bc, oa, ob, oc)
    keys.sort(axis=1)
    return keys


def _tri_keys_from_orders(kp, o_ac, o_bc, oa, ob, oc):
    """Tetra keys for candidate fourth-vertices (vectorized core).

    kp: (B,1) triangle diameter-edge order (of {a,b}); o_ac/o_bc: (B,1);
    oa/ob/oc: (B,K) orders of {a,v}/{b,v}/{c,v} (-1 where absent).
    Tetra key: primary = max of the 6 edge orders; secondary = order of the
    edge opposite the diameter:  ab<->cv, av<->bc, bv<->ac, cv<->ab.
    """
    common = (oa >= 0) & (ob >= 0) & (oc >= 0)
    m = np.maximum(np.maximum(oa, ob), oc)
    kp_new = np.maximum(kp, m)
    ks = np.where(
        m < kp, oc,                                  # diameter = ab -> opp {c,v}
        np.where(m == oa, o_bc,                      # diameter = av -> opp {b,c}
                 np.where(m == ob, o_ac, kp)))       # bv -> {a,c} ; cv -> {a,b}
    keys = pack_np(kp_new, ks)
    return np.where(common, keys, EMPTY_KEY)


def min_tri_cobdy(filt: Filtration, tri_keys: np.ndarray,
                  sparse: bool = True) -> np.ndarray:
    """Smallest cofacet key per triangle (trivial-pair check, H2*)."""
    fn = tri_cobdy_sparse if sparse else tri_cobdy_ns
    keys = fn(filt, np.atleast_1d(tri_keys))
    return keys[:, 0]


def greatest_boundary_triangle(filt: Filtration, tet_keys: np.ndarray) -> np.ndarray:
    """For tetra <k1,k2>: greatest facet = <k1, max vertex of edge(k2)>
    (paper §4.3.5) — the candidate trivial-pair owner."""
    tet_keys = np.asarray(tet_keys, dtype=np.int64)
    k1 = tet_keys >> 32
    k2 = tet_keys & np.int64((1 << 32) - 1)
    vmax = filt.edges[k2].max(axis=-1).astype(np.int64) if tet_keys.ndim else \
        np.int64(filt.edges[k2].max())
    return (k1 << 32) | vmax


# ---------------------------------------------------------------------------
# Column enumeration for H2*: case-1 triangles grouped by diameter edge
# ---------------------------------------------------------------------------

def case1_triangles_of_edges(filt: Filtration, e_orders: np.ndarray,
                             sparse: bool = True) -> list[np.ndarray]:
    """For each edge e: triangles with diameter e, i.e. common neighbors v
    with O_av < e and O_bv < e; returned as packed keys <e, v>, ascending.
    These are exactly the H2* columns owned by e (paper Alg. 3 line 13)."""
    e_orders = np.asarray(e_orders, dtype=np.int64)
    a = filt.edges[e_orders, 0].astype(np.int64)
    b = filt.edges[e_orders, 1].astype(np.int64)
    if sparse:
        v = filt.nbr_vtx[a].astype(np.int64)
        oa = filt.nbr_vtx_ord[a].astype(np.int64)
        ob = _lookup_order(filt, b, v)
    else:
        v = np.broadcast_to(np.arange(filt.n, dtype=np.int64),
                            (len(e_orders), filt.n))
        oa = filt.order[a].astype(np.int64)
        ob = filt.order[b].astype(np.int64)
    ok = (oa >= 0) & (ob >= 0) & (oa < e_orders[:, None]) & (ob < e_orders[:, None])
    out = []
    for i, e in enumerate(e_orders):
        vs = np.sort(v[i][ok[i]])
        out.append((np.int64(e) << 32) | vs)
    return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _lookup_order(filt: Filtration, row: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Order of edge {row_i, v_ij} via batched binary search in N^row
    (sparse lookup; -1 where absent).  row: (B,), v: (B, K).

    One row (the batch engine's per-column coboundaries) searches that
    row's ``degree`` neighbours directly: the same answers with a third of
    the numpy calls of the flattened batch search."""
    if len(row) == 1:
        r = int(row[0])
        deg = int(filt.degree[r])
        if deg == 0:
            return np.full(np.shape(v), -1, dtype=np.int64)
        nbr = filt.nbr_vtx[r, :deg].astype(np.int64)      # sorted, no pad
        pos = np.minimum(np.searchsorted(nbr, v[0]), deg - 1)
        o = filt.nbr_vtx_ord[r, pos].astype(np.int64)
        return np.where(nbr[pos] == v[0], o, -1)[None]
    nbr = filt.nbr_vtx[row].astype(np.int64)            # (B, K) sorted, pad = n
    ords = filt.nbr_vtx_ord[row].astype(np.int64)
    B, K = nbr.shape
    deg = filt.degree[row].astype(np.int64)[:, None]
    stride = np.int64(filt.n + 1)
    flat = (nbr + np.arange(B, dtype=np.int64)[:, None] * stride).ravel()
    q = (np.clip(v, 0, filt.n) + np.arange(B, dtype=np.int64)[:, None] * stride)
    pos = np.searchsorted(flat, q.ravel()).reshape(B, -1)
    pos_in_row = pos - np.arange(B, dtype=np.int64)[:, None] * K
    valid = (pos_in_row >= 0) & (pos_in_row < deg)
    pos_c = np.clip(pos_in_row, 0, K - 1)
    hit = valid & (np.take_along_axis(nbr, pos_c, axis=1) == v)
    o = np.take_along_axis(ords, pos_c, axis=1)
    return np.where(hit, o, -1)
