"""Vietoris-Rips filtration construction (Dory §4: ``F_0``, ``F_1``, neighborhoods).

Port of ``src/repro/core/filtration.py``.  Host numpy on purpose: the exact
f64 distances (fixed-order ``cross_term`` and numpy's row-norm summation
order) are what make ``edge_len`` bit-identical to the reference; the
device only ever proposes f32 candidates (``repro_torch.scale.tiles``).
:func:`filtration_from_arrays` carries a reference ``Filtration`` across.

The filtration for 1-simplices, ``F_1``, is the list of permissible edges
(``d(x, y) <= tau_max``) sorted by length (ties broken lexicographically so
every edge has a unique order — a valid refinement of the VR filtration, which
leaves persistence diagrams invariant).

Two neighbor representations are built, mirroring the paper's two code paths:

* **sparse** (Dory): per-vertex *vertex-neighborhoods* ``N^a`` (sorted by
  neighbor id) and *edge-neighborhoods* ``E^a`` (sorted by edge order), as
  padded rectangular arrays — ``O(n + n_e)`` memory, the paper's
  ``(3n + 12 n_e) * 4`` bytes base-memory account is reproduced in
  :meth:`Filtration.base_memory_bytes`.
* **non-sparse** (DoryNS): a dense ``(n, n)`` int32 order matrix — ``O(n^2)``
  memory, replacing binary searches with array access.  The matrix is now
  *lazy*: sparse-only pipelines (``repro.scale`` streaming builds) carry
  ``dense_order=None`` and never pay the ``O(n^2)`` allocation; touching
  :attr:`Filtration.order` materializes it on demand.

Distance arithmetic is deliberately BLAS-free for the cross term: matmul
kernels pick different accumulation orders per operand shape, so ``X @ Y.T``
is not bit-reproducible across tilings.  ``cross_term`` accumulates over the
feature axis in fixed ascending order, which makes every blocked / tiled /
per-pair distance path in this repo produce identical bits for identical
pairs — the invariant ``repro.scale`` relies on to be a drop-in replacement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

NO_EDGE = np.int32(-1)


def cross_term(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``sum_k x[i, k] * y[j, k]`` with fixed ascending-k accumulation.

    Bit-identical for a given pair (i, j) regardless of how rows are blocked
    into tiles (BLAS matmul is not — its kernel choice depends on shape).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    acc = np.zeros((x.shape[0], y.shape[0]))
    for k in range(x.shape[1]):
        acc += x[:, k, None] * y[None, :, k]
    return acc


def pair_sq_dists(points: np.ndarray, iu: np.ndarray, ju: np.ndarray,
                  sq: Optional[np.ndarray] = None) -> np.ndarray:
    """Clamped squared distances for an explicit pair list (i, j).

    Same scalar operation sequence per pair as :func:`block_sq_dists`, so the
    result is bit-identical to the corresponding tile/matrix entries.
    """
    points = np.asarray(points, dtype=np.float64)
    if sq is None:
        sq = np.sum(points * points, axis=1)
    acc = np.zeros(len(iu))
    for k in range(points.shape[1]):
        acc += points[iu, k] * points[ju, k]
    d2 = sq[iu] + sq[ju] - 2.0 * acc
    np.maximum(d2, 0.0, out=d2)
    return d2


def block_sq_dists(x: np.ndarray, y: np.ndarray,
                   sq_x: Optional[np.ndarray] = None,
                   sq_y: Optional[np.ndarray] = None) -> np.ndarray:
    """Clamped squared distances between two row blocks (canonical form).

    ``sq_*`` are the precomputed row squared-norms (``np.sum(p * p, axis=1)``
    of the *full* array, sliced — per-row reductions are slice-invariant).
    """
    if sq_x is None:
        sq_x = np.sum(x * x, axis=1)
    if sq_y is None:
        sq_y = np.sum(y * y, axis=1)
    d2 = sq_x[:, None] + sq_y[None, :] - 2.0 * cross_term(x, y)
    np.maximum(d2, 0.0, out=d2)
    return d2


def pairwise_distances(points: np.ndarray, block_rows: int = 1024) -> np.ndarray:
    """Dense Euclidean distance matrix (host/numpy path).

    Computed in row blocks so peak scratch is ``O(block_rows * n)`` on top of
    the ``(n, n)`` output — no second full-matrix temporary — and clamped at 0
    before the sqrt (the Gram form ``|x|^2 + |y|^2 - 2 x.y`` cancels
    catastrophically for near-duplicate points).
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    sq = np.sum(points * points, axis=1)
    out = np.empty((n, n))
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        d2 = block_sq_dists(points[s:e], points, sq[s:e], sq)
        out[s:e] = np.sqrt(d2, out=d2)
    np.fill_diagonal(out, 0.0)
    return out


@dataclasses.dataclass
class Filtration:
    """Immutable VR filtration state shared by all reduction engines."""

    n: int                      # number of vertices
    n_e: int                    # number of permissible edges
    edges: np.ndarray           # (n_e, 2) int32, edges[o] = (a, b), a < b, o = f_1 order
    edge_len: np.ndarray        # (n_e,) float64 lengths, nondecreasing
    tau_max: float

    # sparse (Dory) structure: padded neighborhoods.
    degree: np.ndarray          # (n,) int32
    max_deg: int
    nbr_vtx: np.ndarray         # (n, max_deg) int32 neighbor ids sorted ascending; pad = n
    nbr_vtx_ord: np.ndarray     # (n, max_deg) int32 edge order for nbr_vtx; pad = -1
    nbr_edge_ord: np.ndarray    # (n, max_deg) int32 edge orders sorted ascending; pad = 2**31-1
    nbr_edge_vtx: np.ndarray    # (n, max_deg) int32 neighbor for nbr_edge_ord; pad = n

    # non-sparse (DoryNS) structure: dense order matrix, -1 where no edge.
    # None for streamed builds (repro.scale); materialized lazily on access.
    dense_order: Optional[np.ndarray] = None    # (n, n) int32 or None

    @property
    def has_dense_order(self) -> bool:
        """True iff the O(n^2) order matrix is already materialized."""
        return self.dense_order is not None

    @property
    def order(self) -> np.ndarray:
        """Dense (n, n) order matrix; built on first access if absent."""
        if self.dense_order is None:
            self.dense_order = dense_order_matrix(self.n, self.edges)
        return self.dense_order

    def base_memory_bytes(self) -> int:
        """Paper appendix E: base memory = ``(3n + 12 n_e) * 4`` bytes."""
        return (3 * self.n + 12 * self.n_e) * 4

    def edge_order_of(self, a: int, b: int) -> int:
        return int(self.order[a, b])

    def diam_value(self, key_primary) -> np.ndarray:
        """Filtration value (length of diameter edge) for primary key(s)."""
        return self.edge_len[np.asarray(key_primary, dtype=np.int64)]


def filtration_from_arrays(fields: Dict[str, Any]) -> Filtration:
    """A :class:`Filtration` from another package's fields, as plain data.

    ``fields`` maps every :class:`Filtration` field name to a numpy array or
    a scalar (``dataclasses.asdict`` of the reference ``Filtration`` gives
    exactly that).  Arrays are copied into the dtypes this module builds,
    so a filtration carried across reduces to the same diagrams as one
    built here.
    """
    names = {f.name for f in dataclasses.fields(Filtration)}
    missing = names - set(fields) - {"dense_order"}
    if missing:
        raise ValueError(f"missing Filtration fields: {sorted(missing)}")
    int32 = ("edges", "degree", "nbr_vtx", "nbr_vtx_ord", "nbr_edge_ord",
             "nbr_edge_vtx")
    kw: Dict[str, Any] = {}
    for name in names:
        v = fields.get(name)
        if name in int32:
            v = np.array(v, dtype=np.int32)
        elif name == "edge_len":
            v = np.array(v, dtype=np.float64)
        elif name == "dense_order":
            v = None if v is None else np.array(v, dtype=np.int32)
        elif name == "tau_max":
            v = float(v)
        else:
            v = int(v)
        kw[name] = v
    return Filtration(**kw)


def dense_order_matrix(n: int, edges: np.ndarray) -> np.ndarray:
    """(n, n) int32 edge-order lookup table (DoryNS), -1 where no edge."""
    order = np.full((n, n), NO_EDGE, dtype=np.int32)
    iu = edges[:, 0].astype(np.int64)
    ju = edges[:, 1].astype(np.int64)
    o = np.arange(len(edges), dtype=np.int32)
    order[iu, ju] = o
    order[ju, iu] = o
    return order


def build_filtration(
    points: np.ndarray | None = None,
    dists: np.ndarray | None = None,
    tau_max: float = np.inf,
) -> Filtration:
    """Build ``F_1`` + neighborhoods from a point cloud or a distance matrix."""
    if dists is None:
        if points is None:
            raise ValueError("provide points or dists")
        dists = pairwise_distances(points)
    dists = np.asarray(dists, dtype=np.float64)
    n = dists.shape[0]
    if dists.shape != (n, n):
        raise ValueError(f"dists must be square, got {dists.shape}")

    iu, ju = np.triu_indices(n, k=1)
    lens = dists[iu, ju]
    keep = lens <= tau_max
    iu, ju, lens = iu[keep], ju[keep], lens[keep]
    return filtration_from_edges(n, iu, ju, lens, tau_max,
                                 with_dense_order=True)


def filtration_from_edges(
    n: int,
    iu: np.ndarray,
    ju: np.ndarray,
    lens: np.ndarray,
    tau_max: float,
    presorted: bool = False,
    with_dense_order: bool = False,
) -> Filtration:
    """Assemble a :class:`Filtration` from a COO edge list (i < j required).

    The shared back half of every builder — dense (``build_filtration``),
    tiled/streamed and sparse-input (``repro.scale``).  Sorts edges into the
    canonical unique order ``(length, i, j)`` lexicographic unless
    ``presorted``; neighborhoods are built with ``O(n + n_e)`` memory.  The
    dense order matrix is only allocated when ``with_dense_order`` (the
    DoryNS path); otherwise it stays lazy (``dense_order=None``).
    """
    iu = np.asarray(iu, dtype=np.int64)
    ju = np.asarray(ju, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.float64)
    if not presorted:
        # Unique, deterministic edge order: (length, i, j) lexicographic.
        sort_idx = np.lexsort((ju, iu, lens))
        iu, ju, lens = iu[sort_idx], ju[sort_idx], lens[sort_idx]
    n_e = int(lens.shape[0])
    edges = np.stack([iu, ju], axis=1).astype(np.int32)
    o = np.arange(n_e, dtype=np.int32)

    degree = np.zeros(n, dtype=np.int32)
    np.add.at(degree, iu, 1)
    np.add.at(degree, ju, 1)
    max_deg = int(degree.max()) if n_e else 1
    max_deg = max(max_deg, 1)

    nbr_vtx = np.full((n, max_deg), n, dtype=np.int32)
    nbr_vtx_ord = np.full((n, max_deg), NO_EDGE, dtype=np.int32)
    nbr_edge_ord = np.full((n, max_deg), np.iinfo(np.int32).max, dtype=np.int32)
    nbr_edge_vtx = np.full((n, max_deg), n, dtype=np.int32)

    # Build per-vertex lists: each edge contributes to both endpoints.
    src = np.concatenate([iu, ju])
    dst = np.concatenate([ju, iu])
    eo = np.concatenate([o, o])
    # N^a: sorted by neighbor id.
    key = src.astype(np.int64) * (n + 1) + dst
    srt = np.argsort(key, kind="stable")
    s_src, s_dst, s_eo = src[srt], dst[srt], eo[srt]
    slot = _running_slot(s_src, n)
    nbr_vtx[s_src, slot] = s_dst
    nbr_vtx_ord[s_src, slot] = s_eo
    # E^a: sorted by edge order.
    key = src.astype(np.int64) * (n_e + 1) + eo
    srt = np.argsort(key, kind="stable")
    s_src, s_dst, s_eo = src[srt], dst[srt], eo[srt]
    slot = _running_slot(s_src, n)
    nbr_edge_ord[s_src, slot] = s_eo
    nbr_edge_vtx[s_src, slot] = s_dst

    return Filtration(
        n=n, n_e=n_e, edges=edges, edge_len=lens, tau_max=float(tau_max),
        degree=degree, max_deg=max_deg,
        nbr_vtx=nbr_vtx, nbr_vtx_ord=nbr_vtx_ord,
        nbr_edge_ord=nbr_edge_ord, nbr_edge_vtx=nbr_edge_vtx,
        dense_order=dense_order_matrix(n, edges) if with_dense_order else None,
    )


def _running_slot(sorted_ids: np.ndarray, n: int) -> np.ndarray:
    """Position of each element within its (already grouped) id run."""
    if sorted_ids.size == 0:
        return np.zeros(0, dtype=np.int64)
    counts = np.bincount(sorted_ids, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(sorted_ids.size) - starts[sorted_ids]
