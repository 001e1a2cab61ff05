"""Streaming tiled filtration construction (million-point path, paper §5-6).

Port of ``src/repro/scale/tiles.py``, serial harvest.  The distance matrix
is visited in ``(tile_m, tile_n)`` blocks, each block is thresholded
against ``tau_max`` and its surviving ``(i, j, length)`` triplets are
merged into the canonical ``(length, i, j)`` edge list — one tile plus
``O(n + n_e)`` memory, never ``O(n^2)``.

Two backends:

* ``"numpy"`` — exact f64 tiles on the host through the fixed-order
  ``block_sq_dists`` (the reference's host path, unchanged);
* ``"kernel"`` — the reference's ``"pallas"`` path on a torch device: the
  tile's f32 squared distances come from
  :func:`repro_torch.kernels.pairwise_dist.pairwise_sq_dists` (the CUDA
  kernel on a card, its plain version on the CPU), are thresholded on the
  device against the margin-widened f32 threshold, and only the candidate
  index list crosses to the host, where every candidate is re-measured
  exactly in f64 (``pair_sq_dists``).  The output is bit-identical to the
  numpy tile whatever produced the f32 candidates.

``backend="auto"`` takes ``"kernel"`` on a CUDA device and ``"numpy"`` on
the CPU.  The sharded harvest over a mesh (:mod:`repro_torch.scale.shard`)
replays each shard's tile list through the same per-tile dispatch
(``iter_tile_edges(tiles=)``).  A tile lost to a transient fault (the
``harvest.tile`` site of :mod:`repro_torch.resilience.faults`) is
harvested again, as in the reference: a tile is a pure function of its
origin, so the retry gives identical bits, counted in
``TileStats.tile_retries``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.filtration import (block_sq_dists, filtration_from_edges,
                               pair_sq_dists)
from ..device import DeviceLike, resolve_device
from ..obs.trace import span
from ..resilience.faults import (TransientFault, active_injector,
                                 retry_with_backoff)

DEFAULT_TILE = 2048

SqDistsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class TileStats:
    """Accounting for one streamed build (benchmarks assert against this).

    For sharded builds (``repro_torch.scale.shard``) the per-tile fields
    describe *one device*: ``peak_tile_bytes`` is the largest tile resident
    on any single device, ``gather_bytes`` the per-round transfer to the
    host, and ``shard_peak_harvest_bytes`` the largest per-device COO
    fragment set held before the host merge.  ``n_shards == 1`` for serial
    builds.  The port's device rounds bring back each tile's candidate
    index lists, not the reference's stacked f32 round, so its
    ``gather_bytes`` (and ``candidate_pairs``) differ from the
    reference's by design.
    """

    n: int = 0
    n_e: int = 0
    tile_m: int = 0
    tile_n: int = 0
    backend: str = "numpy"
    tiles_visited: int = 0
    candidate_pairs: int = 0      # kernel path: f32 candidates refined in f64
    peak_tile_bytes: int = 0      # largest per-tile scratch
    harvest_bytes: int = 0        # final sorted COO triplet arrays
    merge_peak_bytes: int = 0     # worst transient during concat + lexsort
    base_memory_bytes: int = 0    # paper (3n + 12 n_e) * 4 for the result
    n_shards: int = 1             # devices/shards the tile grid was split over
    mesh_axis: str = ""           # mesh axis name for device-sharded builds
    gather_bytes: int = 0         # sharded: per-round transfer to the host
    shard_peak_harvest_bytes: int = 0   # largest per-shard fragment set
    tile_retries: int = 0         # injected/transient tile failures retried

    def peak_extra_bytes(self) -> int:
        """Peak transient memory of the build: one tile + the merge worst case
        (chunks + concat copy, then sort index + permuted copies)."""
        return self.peak_tile_bytes + max(self.merge_peak_bytes,
                                          self.harvest_bytes)

    def per_device_base_bytes(self) -> int:
        """Per-device share of the paper's ``(3n + 12 n_e) * 4`` account.

        The ``3n`` vertex arrays are duplicated on every device; the
        ``12 n_e`` edge arrays split ~evenly across shards (ceiling share).
        """
        shards = max(1, self.n_shards)
        ne_share = -(-self.n_e // shards)
        return (3 * self.n + 12 * ne_share) * 4

    def per_device_peak_bytes(self) -> int:
        """Peak per-device transient of a sharded harvest: the resident tile
        scratch plus the round gather plus this device's un-merged COO
        fragments.  ``scale.budget.tile_transient_bytes`` a-priori bounds
        the first two terms only (``peak_tile_bytes + gather_bytes``); the
        fragment term rides the edge share of the
        :meth:`per_device_base_bytes` account instead."""
        return (self.peak_tile_bytes + self.gather_bytes
                + self.shard_peak_harvest_bytes)


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "numpy"
    if backend not in ("numpy", "kernel"):
        raise ValueError(f"unknown tile backend {backend!r}")
    return backend


def _f32_margin(sq_max: float, d: int) -> float:
    """Upper bound on |d2_f32 - d2_f64| for the f32 candidate filter.

    Input rounding to f32 plus the f32 Gram accumulation each contribute
    O(eps32) per term; 8 * (d + 4) terms is a deliberately loose constant —
    a too-wide margin only means a few extra candidates get the exact f64
    re-measure, never a missed edge.
    """
    eps32 = float(np.finfo(np.float32).eps)
    return 8.0 * (d + 4) * eps32 * max(sq_max, 1.0) * 4.0


def tile_grid(n: int, tile_m: int, tile_n: int) -> list:
    """Row-major list of upper-triangular tile origins ``(si, sj)``.

    A tile is listed iff it intersects the strict upper triangle
    (``si < min(sj + tile_n, n) - 1``); every unordered pair (i < j) lives in
    exactly one listed tile, so per-tile harvests are disjoint and their
    union is exactly the dense path's thresholded upper triangle.
    """
    return [(si, sj)
            for si in range(0, n, tile_m)
            for sj in range(0, n, tile_n)
            if si < min(sj + tile_n, n) - 1]


def _upper_mask(si: int, ei: int, sj: int, ej: int) -> Optional[np.ndarray]:
    """i<j mask for a diagonal-crossing tile; None when fully above (the
    vast majority for large n, which then needs no mask at all)."""
    if ei - 1 < sj:
        return None
    return np.arange(si, ei)[:, None] < np.arange(sj, ej)[None, :]


def _harvest_masked_tile(lens_tile: np.ndarray, si: int, sj: int,
                         tau_max: float, upper: Optional[np.ndarray],
                         stats: Optional[TileStats]
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Threshold one exact-f64 length tile and emit its COO chunk."""
    mask = lens_tile <= tau_max
    if upper is not None:
        mask &= upper
    if stats is not None:
        stats.peak_tile_bytes = max(
            stats.peak_tile_bytes, lens_tile.nbytes + mask.nbytes
            + (0 if upper is None else upper.nbytes))
    ri, rj = np.nonzero(mask)
    return si + ri, sj + rj, lens_tile[ri, rj]


def _harvest_points_tile(points: np.ndarray, sq: np.ndarray,
                         si: int, ei: int, sj: int, ej: int, tau_max: float,
                         stats: Optional[TileStats]
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy host path: exact f64 tile via the fixed-order kernels."""
    d2 = block_sq_dists(points[si:ei], points[sj:ej], sq[si:ei], sq[sj:ej])
    lens_tile = np.sqrt(d2, out=d2)
    return _harvest_masked_tile(lens_tile, si, sj, tau_max,
                                _upper_mask(si, ei, sj, ej), stats)


def _candidates_on_device(d2_32: torch.Tensor, si: int, ei: int, sj: int,
                          ej: int, thr32: np.float32,
                          stats: Optional[TileStats]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Tile-local ``(row, col)`` of the f32 candidates, thresholded where
    ``d2_32`` lives; only the index list crosses to the host.

    ``thr32`` is a float32 value, so comparing the float32 tile against it
    on the device selects exactly the host comparison's candidates."""
    cand = d2_32 <= float(thr32)
    upper_bytes = 0
    if ei - 1 >= sj:
        dev = d2_32.device
        upper = (torch.arange(si, ei, device=dev)[:, None]
                 < torch.arange(sj, ej, device=dev)[None, :])
        cand &= upper
        upper_bytes = upper.numel()
    if stats is not None:
        stats.peak_tile_bytes = max(
            stats.peak_tile_bytes,
            d2_32.numel() * 4 + cand.numel() + upper_bytes)
    ri, rj = torch.nonzero(cand, as_tuple=True)
    return ri.cpu().numpy(), rj.cpu().numpy()


def _refine_candidates(ri: np.ndarray, rj: np.ndarray, points: np.ndarray,
                       sq: np.ndarray, si: int, sj: int, tau_max: float,
                       stats: Optional[TileStats]
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact f64 re-measure of one tile's f32 candidates (host numpy, the
    reference's operation sequence), so the output is bit-identical to the
    numpy tile regardless of which device produced the candidates."""
    iu, ju = si + ri, sj + rj
    lens = np.sqrt(pair_sq_dists(points, iu, ju, sq))
    if stats is not None:
        stats.candidate_pairs += int(iu.size)
    keep = lens <= tau_max
    return iu[keep], ju[keep], lens[keep]


def _f32_threshold(points: np.ndarray, sq: np.ndarray,
                   tau_max: float) -> np.float32:
    """Margin-widened f32 candidate threshold for the whole cloud."""
    n = points.shape[0]
    margin = _f32_margin(float(sq.max()) if n else 1.0, points.shape[1])
    return np.float32(tau_max * tau_max + margin) \
        if np.isfinite(tau_max) else np.float32(np.inf)


def _f32_dists_threshold(tau_max: float) -> np.float32:
    """Conservative f32 candidate threshold for a precomputed *length*
    matrix: casting a length to f32 perturbs it by at most eps32/2
    relative, so a 4-eps margin can only add candidates (each re-measured
    against the exact f64 entry), never drop a true edge."""
    if not np.isfinite(tau_max):
        return np.float32(np.inf)
    eps32 = float(np.finfo(np.float32).eps)
    return np.float32(tau_max + 4.0 * eps32 * max(tau_max, 1.0))


def _refine_f32_dists_tile(cand: np.ndarray, dists: np.ndarray,
                           si: int, ei: int, sj: int, ej: int,
                           tau_max: float, stats: Optional[TileStats]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact f64 re-measure of one device-filtered dists tile.

    ``cand`` is the tile's f32 candidate mask (already cropped to the real
    ``(ei - si, ej - sj)`` extent) computed on device against
    :func:`_f32_dists_threshold`; the exact lengths come straight from the
    f64 matrix, so the output is bit-identical to the host dists tile for
    any device count.
    """
    upper = _upper_mask(si, ei, sj, ej)
    if upper is not None:
        cand = cand & upper
    if stats is not None:
        stats.peak_tile_bytes = max(
            stats.peak_tile_bytes,
            2 * cand.nbytes + (0 if upper is None else upper.nbytes))
    ri, rj = np.nonzero(cand)
    iu, ju = si + ri, sj + rj
    lens = np.asarray(dists[iu, ju], dtype=np.float64)
    if stats is not None:
        stats.candidate_pairs += int(iu.size)
    keep = lens <= tau_max
    return iu[keep], ju[keep], lens[keep]


def iter_tile_edges(
    points: Optional[np.ndarray] = None,
    dists: Optional[np.ndarray] = None,
    tau_max: float = np.inf,
    tile_m: int = DEFAULT_TILE,
    tile_n: int = DEFAULT_TILE,
    backend: str = "auto",
    device: DeviceLike = None,
    stats: Optional[TileStats] = None,
    tiles: Optional[list] = None,
    sq_dists: Optional[SqDistsFn] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield COO edge chunks ``(iu, ju, lens)`` per tile, ``i < j`` only.

    Tiles stream serially in :func:`tile_grid` order — or in the explicit
    ``tiles`` list of ``(si, sj)`` origins, which is how ``scale.shard``
    replays one shard's partition through this exact dispatch.  Chunks are
    disjoint and their union over a full grid is exactly the dense path's
    thresholded upper triangle.
    ``sq_dists`` replaces the f32 tile function of the kernel backend
    (default: the ``pairwise_sq_dists`` kernel wrapper); whatever it
    proposes, the exact re-measure keeps the chunks unchanged.
    """
    if (points is None) == (dists is None):
        raise ValueError("provide exactly one of points or dists")
    dev = resolve_device(device)
    backend = _resolve_backend(backend, dev) if points is not None \
        else "numpy"
    if stats is not None:
        stats.tile_m, stats.tile_n, stats.backend = tile_m, tile_n, backend

    if dists is not None:
        dists = np.asarray(dists)
        n = dists.shape[0]
        if dists.shape != (n, n):
            raise ValueError(f"dists must be square, got {dists.shape}")
    else:
        points = np.asarray(points, dtype=np.float64)
        n = points.shape[0]
        sq = np.sum(points * points, axis=1)
        if backend == "kernel":
            if sq_dists is None:
                from ..kernels.pairwise_dist import pairwise_sq_dists
                sq_dists = pairwise_sq_dists
            pts32 = torch.as_tensor(points, dtype=torch.float32, device=dev)
            thr32 = _f32_threshold(points, sq, tau_max)
    if stats is not None:
        stats.n = n

    if tiles is None:
        tiles = tile_grid(n, tile_m, tile_n)
    inj = active_injector()
    for tile_ord, (si, sj) in enumerate(tiles):
        ei, ej = min(si + tile_m, n), min(sj + tile_n, n)
        if stats is not None:
            stats.tiles_visited += 1

        # the chunk is computed under its span and only then yielded, so
        # consumer work between tiles is never attributed to the harvest
        def compute_tile(attempt: int, tile_ord=tile_ord,
                         si=si, sj=sj, ei=ei, ej=ej):
            # a lost tile computation (preempted device, evicted host) is
            # transient: the tile is a pure function of its origin, so the
            # retry re-harvests identical bits
            if inj is not None and inj.fire("harvest.tile", index=tile_ord,
                                            kinds=("fail_tile",)):
                raise TransientFault(
                    f"injected tile failure at ({si},{sj})")
            if dists is not None:
                with span("harvest/tile", tile=f"{si},{sj}",
                          backend="dists"):
                    lens_tile = np.asarray(dists[si:ei, sj:ej],
                                           dtype=np.float64)
                    return _harvest_masked_tile(lens_tile, si, sj, tau_max,
                                                _upper_mask(si, ei, sj, ej),
                                                stats)
            if backend == "kernel":
                with span("harvest/tile", tile=f"{si},{sj}",
                          backend="kernel"):
                    d2_32 = sq_dists(pts32[si:ei], pts32[sj:ej])
                    ri, rj = _candidates_on_device(d2_32, si, ei, sj, ej,
                                                   thr32, stats)
                    return _refine_candidates(ri, rj, points, sq, si, sj,
                                              tau_max, stats)
            with span("harvest/tile", tile=f"{si},{sj}", backend="numpy"):
                return _harvest_points_tile(points, sq, si, ei, sj, ej,
                                            tau_max, stats)

        if inj is None:
            chunk = compute_tile(0)
        else:
            def note_retry(a, err, delay_s):
                if stats is not None:
                    stats.tile_retries += 1
            chunk = retry_with_backoff(compute_tile, attempts=3,
                                       base_s=1e-4, seed=tile_ord,
                                       sleep=None, on_retry=note_retry)
        yield chunk


def harvest_edges(
    points: Optional[np.ndarray] = None,
    dists: Optional[np.ndarray] = None,
    tau_max: float = np.inf,
    tile_m: int = DEFAULT_TILE,
    tile_n: int = DEFAULT_TILE,
    backend: str = "auto",
    device: DeviceLike = None,
    stats: Optional[TileStats] = None,
    sq_dists: Optional[SqDistsFn] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All permissible edges as one globally sorted COO list.

    Chunks stream out of :func:`iter_tile_edges` and merge through
    :func:`merge_edge_chunks` into the canonical ``(length, i, j)`` order —
    the same the dense builder uses, so downstream structures match bit for
    bit.
    """
    ii, jj, ll = [], [], []
    for iu, ju, lens in iter_tile_edges(points=points, dists=dists,
                                        tau_max=tau_max, tile_m=tile_m,
                                        tile_n=tile_n, backend=backend,
                                        device=device, stats=stats,
                                        sq_dists=sq_dists):
        ii.append(iu.astype(np.int64))
        jj.append(ju.astype(np.int64))
        ll.append(lens)
    return merge_edge_chunks(ii, jj, ll, stats=stats)


def merge_edge_chunks(
    ii: list, jj: list, ll: list, stats: Optional[TileStats] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-tile COO chunk lists into the canonical sorted edge list.

    The single ``(length, i, j)`` lexsort is a total order over pairs, so
    the result is independent of chunk arrival order.  Consumes the input
    lists (chunks are released as each concatenation lands) so the
    transient peak is chunks + one concat copy, then sort index + permuted
    copies — recorded in ``TileStats.merge_peak_bytes``.
    """
    chunk_bytes = sum(a.nbytes + b.nbytes + c.nbytes
                      for a, b, c in zip(ii, jj, ll))
    with span("harvest/merge", n_chunks=len(ll)):
        iu = np.concatenate(ii) if ii else np.zeros(0, dtype=np.int64)
        ii.clear()
        ju = np.concatenate(jj) if jj else np.zeros(0, dtype=np.int64)
        jj.clear()
        lens = np.concatenate(ll) if ll else np.zeros(0)
        ll.clear()
        srt = np.lexsort((ju, iu, lens))
        iu, ju, lens = iu[srt], ju[srt], lens[srt]
    if stats is not None:
        stats.n_e = int(lens.size)
        stats.harvest_bytes = int(iu.nbytes + ju.nbytes + lens.nbytes)
        # worst transient: all chunks + the first concat copy alive together,
        # vs. final arrays + lexsort index + one permuted copy in flight
        stats.merge_peak_bytes = max(chunk_bytes + iu.nbytes,
                                     stats.harvest_bytes + srt.nbytes
                                     + iu.nbytes)
    return iu, ju, lens


def build_filtration_tiled(
    points: Optional[np.ndarray] = None,
    dists: Optional[np.ndarray] = None,
    tau_max: float = np.inf,
    tile_m: int = DEFAULT_TILE,
    tile_n: int = DEFAULT_TILE,
    backend: str = "auto",
    device: DeviceLike = None,
    with_dense_order: bool = False,
    return_stats: bool = False,
):
    """Streamed :class:`Filtration` build — never allocates ``(n, n)``.

    Output is bit-identical (edges, orders, lengths, neighborhoods) to
    ``build_filtration`` on the same input, but peak memory is one
    ``(tile_m, tile_n)`` tile plus ``O(n + n_e)``.  ``with_dense_order``
    defaults to False so the result runs the order-free sparse Dory path.

    Returns ``filt`` or ``(filt, TileStats)`` with ``return_stats``.
    """
    stats = TileStats()
    iu, ju, lens = harvest_edges(points=points, dists=dists, tau_max=tau_max,
                                 tile_m=tile_m, tile_n=tile_n,
                                 backend=backend, device=device, stats=stats)
    filt = filtration_from_edges(stats.n, iu, ju, lens, tau_max,
                                 presorted=True,
                                 with_dense_order=with_dense_order)
    stats.base_memory_bytes = filt.base_memory_bytes()
    if return_stats:
        return filt, stats
    return filt
