"""Sharded tiled filtration harvest over the ``data`` mesh axis.

Port of ``src/repro/scale/shard.py``.  The upper-triangular tile grid is
partitioned **round-robin** across the mesh's data axis and each round
gives one tile to each mesh entry:

* **device rounds** (points): ``pairwise_sq_dists`` runs on the entry's
  device, on its own CUDA stream, so the round's tiles run at once; the
  f32 candidates are thresholded there and only their index lists cross to
  the host (``scale.tiles._candidates_on_device``, the serial path's
  form), where each candidate is re-measured exactly in f64
  (``pair_sq_dists``) in the reference's order;
* **dists rounds** (a precomputed matrix): each entry thresholds its own
  f32 tile against ``_f32_dists_threshold`` and its 1-byte candidate mask
  comes back; the exact lengths are read from the f64 matrix on the host.

A shard that has run out of tiles launches nothing (the reference
recomputes a zero block there), so the device rounds launch
``pairwise_sq_dists`` once a tile.  The port's ``gather_bytes`` counts the
index lists (points) or the f32 tiles up and the masks back (dists) of a
round, not the reference's stacked f32 round, and its ``candidate_pairs``
follow its own f32 kernel: both differ from the reference's by design.

The ``numpy`` backend, or ``n_shards`` with no mesh, shards the same
partition on the host: each shard's tile list replays through the serial
:func:`~repro_torch.scale.tiles.iter_tile_edges` dispatch.

**Bit-identity is structural**: every unordered pair (i < j) lives in
exactly one tile, every tile in exactly one shard, each tile's exact
lengths come from the same fixed-order f64 kernels as the serial and dense
paths (the row norms stay ``np.sum``), and the final ``(length, i, j)``
lexsort is a total order — so the sorted edge list, and the whole
:class:`~repro_torch.core.filtration.Filtration`, is bit-identical to the
serial and dense builds for every device count.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.filtration import filtration_from_edges
from ..device import DeviceLike, resolve_device
from ..launch.mesh import mesh_device
from ..obs.trace import span
from .tiles import (DEFAULT_TILE, TileStats, _candidates_on_device,
                    _f32_dists_threshold, _f32_threshold, _refine_candidates,
                    _refine_f32_dists_tile, _resolve_backend, iter_tile_edges,
                    merge_edge_chunks, tile_grid)

__all__ = ["build_filtration_sharded", "harvest_edges_sharded",
           "partition_tiles", "shard_of_mesh"]


def partition_tiles(n: int, tile_m: int, tile_n: int,
                    n_shards: int) -> List[List[Tuple[int, int]]]:
    """Round-robin partition of the upper-triangular tile grid.

    Tile ``t`` (row-major :func:`~repro_torch.scale.tiles.tile_grid` order)
    goes to shard ``t % n_shards``; consecutive grid tiles land on
    different shards, which balances the diagonal tiles (cheaper: half
    masked out) across devices.  Every tile appears in exactly one shard —
    the disjoint-cover invariant the bit-identity guarantee rests on.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    tiles = tile_grid(n, tile_m, tile_n)
    return [tiles[k::n_shards] for k in range(n_shards)]


def shard_of_mesh(mesh) -> Tuple[str, int]:
    """(axis name, size) of the mesh axis tiles shard over (the data axis).

    Only the port's :class:`~repro_torch.launch.mesh.Mesh` is taken: any
    other object raises ``TypeError``, a mesh with no data axis
    ``ValueError``."""
    from ..dist.sharding import data_axis

    axis = data_axis(mesh, "tile")
    return axis, int(mesh.shape[axis])


def _harvest_shards_host(points, dists, shards, tau_max, tile_m, tile_n,
                         backend, device, stats, chunks):
    """Host-partitioned harvest: each shard's tile list replayed through
    the serial :func:`iter_tile_edges` dispatch (exact-f64 numpy, or the
    kernel f32-candidate/f64-refine path on ``device`` when that backend
    was asked for without a mesh).  Fragment bytes tracked per shard."""
    shard_bytes = [0] * len(shards)
    for k, shard in enumerate(shards):
        # the host replays shards back-to-back; lane attribution renders
        # them as the parallel device tracks a mesh would run
        with span("harvest/shard", lane=k, n_tiles=len(shard)):
            for chunk in iter_tile_edges(points=points, dists=dists,
                                         tau_max=tau_max, tile_m=tile_m,
                                         tile_n=tile_n, backend=backend,
                                         device=device, stats=stats,
                                         tiles=shard):
                _keep_fragment(chunks, shard_bytes, k, *chunk)
    _note_shard_peak(stats, shard_bytes)


def _live_tiles(shards, r: int, n: int, tile_m: int, tile_n: int):
    """Round ``r``'s ``(k, si, ei, sj, ej)`` of every shard that still has a
    tile; an exhausted shard sits the round out."""
    live = []
    for k, shard in enumerate(shards):
        if r < len(shard):
            si, sj = shard[r]
            live.append((k, si, min(si + tile_m, n), sj, min(sj + tile_n, n)))
    return live


def _keep_fragment(chunks, shard_bytes, k, iu, ju, lens) -> None:
    """Append one tile's COO chunk and count its bytes to shard ``k``."""
    ii, jj, ll = chunks
    ii.append(iu.astype(np.int64))
    jj.append(ju.astype(np.int64))
    ll.append(lens)
    shard_bytes[k] += ii[-1].nbytes + jj[-1].nbytes + ll[-1].nbytes


def _note_shard_peak(stats, shard_bytes) -> None:
    if stats is not None:
        stats.shard_peak_harvest_bytes = max(stats.shard_peak_harvest_bytes,
                                             max(shard_bytes, default=0))


def _candidate_round_fn(mesh, axis: str, xs, live, thr32: np.float32,
                        stats: Optional[TileStats] = None):
    """One points-harvest round over ``axis``: each live ``(k, si, ei, sj,
    ej)`` tile's f32 candidates on entry ``k``'s device and stream
    (``xs[k]``, the cloud in f32 there), thresholded there; returns ``{k:
    (ri, rj)}``, the tile-local candidate index lists on the host.  Every
    entry's kernel is queued before any list is read back, so the round's
    tiles overlap on the card.  No collectives by design: each entry's
    tile is independent.  Module level, closed over nothing, so
    ``repro_torch.analyze.collectives`` can run it and pin that schedule
    (the reference's ``_candidate_round_fn``)."""
    from ..kernels.pairwise_dist import pairwise_sq_dists

    d2 = {}
    for k, si, ei, sj, ej in live:
        with mesh.on(axis, k):
            d2[k] = pairwise_sq_dists(xs[k][si:ei], xs[k][sj:ej])
    found = {}
    for k, si, ei, sj, ej in live:
        with mesh.on(axis, k):
            found[k] = _candidates_on_device(d2.pop(k), si, ei, sj, ej,
                                             thr32, stats)
    return found


def _dists_round_fn(mesh, axis: str, dists: np.ndarray, live,
                    thr32: float):
    """One dists-harvest round over ``axis``: each live tile of the
    precomputed matrix cast to f32 (numpy's cast, as the reference's round
    buffer makes it), put on entry ``k``'s device and thresholded there
    (the reference's ``t <= thr32``); returns ``({k: mask}, moved)``, the
    1-byte candidate masks on the host and the bytes the round moved (the
    f32 tiles up, the masks back).  No collectives, and module level, for
    the reason :func:`_candidate_round_fn` gives."""
    devices = mesh.axis_devices(axis)
    masks = {}
    moved = 0
    for k, si, ei, sj, ej in live:
        with mesh.on(axis, k):
            t = torch.from_numpy(np.ascontiguousarray(
                dists[si:ei, sj:ej], dtype=np.float32)).to(devices[k])
            masks[k] = t <= thr32
            moved += t.numel() * 4
    for k, *_ in live:
        with mesh.on(axis, k):
            # analyze: allow[host-sync] the per-round candidate-mask gather is the schedule; the f64 re-measure reads the masks on the host
            masks[k] = masks[k].cpu().numpy()
            moved += masks[k].nbytes
    return masks, moved


def _harvest_shards_device(points, sq, shards, tau_max, tile_m, tile_n,
                           mesh, axis, stats, chunks):
    """Device rounds (:func:`_candidate_round_fn`): one f32 candidate tile
    per mesh entry a round, on the entry's device and stream; the index
    lists come back, the exact f64 refine and the COO extraction run on
    the host."""
    n = points.shape[0]
    devices = mesh.axis_devices(axis)
    thr32 = _f32_threshold(points, sq, tau_max)
    pts32 = {}
    for dev in devices:
        if dev not in pts32:
            pts32[dev] = torch.as_tensor(points, dtype=torch.float32,
                                         device=dev)
    xs = [pts32[dev] for dev in devices]
    shard_bytes = [0] * len(shards)
    for r in range(max(len(s) for s in shards)):
        live = _live_tiles(shards, r, n, tile_m, tile_n)
        with span("harvest/round", round=r, n_live=len(live)):
            found = _candidate_round_fn(mesh, axis, xs, live, thr32, stats)
        if stats is not None:
            stats.gather_bytes = max(stats.gather_bytes, sum(
                ri.nbytes + rj.nbytes for ri, rj in found.values()))
        for k, si, ei, sj, ej in live:
            if stats is not None:
                stats.tiles_visited += 1
            with span("harvest/refine", lane=k, round=r, tile=f"{si},{sj}"):
                ri, rj = found.pop(k)
                chunk = _refine_candidates(ri, rj, points, sq, si, sj,
                                           tau_max, stats)
            _keep_fragment(chunks, shard_bytes, k, *chunk)
    _note_shard_peak(stats, shard_bytes)


def _harvest_shards_device_dists(dists, shards, tau_max, tile_m, tile_n,
                                 mesh, axis, stats, chunks):
    """Dists rounds (:func:`_dists_round_fn`): each mesh entry thresholds
    its own f32 tile of the matrix on its device; the 1-byte candidate
    mask comes back and the host re-measures the candidates straight from
    the exact f64 matrix."""
    n = dists.shape[0]
    thr32 = float(_f32_dists_threshold(tau_max))
    shard_bytes = [0] * len(shards)
    for r in range(max(len(s) for s in shards)):
        live = _live_tiles(shards, r, n, tile_m, tile_n)
        with span("harvest/round", round=r, n_live=len(live)):
            masks, moved = _dists_round_fn(mesh, axis, dists, live, thr32)
        if stats is not None:
            stats.gather_bytes = max(stats.gather_bytes, moved)
        for k, si, ei, sj, ej in live:
            if stats is not None:
                stats.tiles_visited += 1
            with span("harvest/refine", lane=k, round=r, tile=f"{si},{sj}"):
                chunk = _refine_f32_dists_tile(masks.pop(k), dists, si, ei,
                                               sj, ej, tau_max, stats)
            _keep_fragment(chunks, shard_bytes, k, *chunk)
    _note_shard_peak(stats, shard_bytes)


def harvest_edges_sharded(
    points: Optional[np.ndarray] = None,
    dists: Optional[np.ndarray] = None,
    tau_max: float = np.inf,
    tile_m: int = DEFAULT_TILE,
    tile_n: int = DEFAULT_TILE,
    mesh=None,
    n_shards: Optional[int] = None,
    backend: str = "auto",
    device: DeviceLike = None,
    stats: Optional[TileStats] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sharded harvest: all permissible edges as one canonical sorted list.

    The reference's parameters in the reference's order, with ``device``
    where the reference has ``interpret``.  Bit-identical to
    :func:`~repro_torch.scale.tiles.harvest_edges` (and the dense upper
    triangle) for every shard/device count.  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`; its data axis fixes the shard
    count) or ``n_shards`` (host-partitioned, no devices needed) is
    typically given; both default to 1 shard.

    With a mesh, backends ``"auto"`` and ``"kernel"`` mean the device rounds
    (the reference's ``"pallas"``), for points and dists alike, and
    ``device`` must be ``None`` or of the mesh's device type.  Without a
    mesh — or with the ``numpy`` backend — the harvest runs on the host
    (the kernel backend's f32 filter on ``device``), reproducing the
    multi-device *work split* and its per-device :class:`TileStats`.
    """
    if (points is None) == (dists is None):
        raise ValueError("provide exactly one of points or dists")
    axis = None
    if mesh is not None:
        axis, mesh_shards = shard_of_mesh(mesh)
        if n_shards is not None and int(n_shards) != mesh_shards:
            raise ValueError(
                f"n_shards={n_shards} disagrees with the mesh's "
                f"{axis}-axis size {mesh_shards}; pass only one of them")
        n_shards = mesh_shards
        device = mesh_device(mesh, device)
        if stats is not None:
            stats.mesh_axis = axis
    n_shards = 1 if n_shards is None else int(n_shards)
    if mesh is not None and backend in ("auto", "kernel"):
        # a mesh asks for device execution: "auto" means the device rounds,
        # not the host split the serial resolver would pick on the CPU
        backend = "kernel"
    elif points is not None:
        backend = _resolve_backend(backend, resolve_device(device))
    else:
        backend = "numpy"

    if dists is not None:
        dists = np.asarray(dists)
        n = dists.shape[0]
        if dists.shape != (n, n):
            raise ValueError(f"dists must be square, got {dists.shape}")
        points = sq = None
    else:
        points = np.asarray(points, dtype=np.float64)
        n = points.shape[0]
        # numpy's row norms, never torch.sum: edge_len bit-identity
        sq = np.sum(points * points, axis=1)

    if stats is not None:
        stats.n = n
        stats.tile_m, stats.tile_n = tile_m, tile_n
        stats.backend = backend
        stats.n_shards = n_shards

    shards = partition_tiles(n, tile_m, tile_n, n_shards)
    chunks: Tuple[list, list, list] = ([], [], [])
    if backend == "kernel" and mesh is not None and points is not None:
        _harvest_shards_device(points, sq, shards, tau_max, tile_m, tile_n,
                               mesh, axis, stats, chunks)
    elif backend == "kernel" and mesh is not None:
        _harvest_shards_device_dists(dists, shards, tau_max, tile_m, tile_n,
                                     mesh, axis, stats, chunks)
    else:
        _harvest_shards_host(points, dists, shards, tau_max, tile_m, tile_n,
                             backend, device, stats, chunks)
    return merge_edge_chunks(*chunks, stats=stats)


def build_filtration_sharded(
    points: Optional[np.ndarray] = None,
    dists: Optional[np.ndarray] = None,
    tau_max: float = np.inf,
    tile_m: int = DEFAULT_TILE,
    tile_n: int = DEFAULT_TILE,
    mesh=None,
    n_shards: Optional[int] = None,
    backend: str = "auto",
    device: DeviceLike = None,
    with_dense_order: bool = False,
    return_stats: bool = False,
):
    """Mesh-sharded streamed :class:`Filtration` build.

    The multi-device form of
    :func:`~repro_torch.scale.tiles.build_filtration_tiled`: output is
    bit-identical to it (and to dense ``build_filtration``) for every
    device count; per-device peak memory is one tile + the round's
    transfer + this device's fragment share — see
    :meth:`TileStats.per_device_peak_bytes` and
    ``scale.budget.tile_transient_bytes``.

    Returns ``filt`` or ``(filt, TileStats)`` with ``return_stats``.
    """
    stats = TileStats()
    iu, ju, lens = harvest_edges_sharded(
        points=points, dists=dists, tau_max=tau_max, tile_m=tile_m,
        tile_n=tile_n, mesh=mesh, n_shards=n_shards, backend=backend,
        device=device, stats=stats)
    filt = filtration_from_edges(stats.n, iu, ju, lens, tau_max,
                                 presorted=True,
                                 with_dense_order=with_dense_order)
    stats.base_memory_bytes = filt.base_memory_bytes()
    if return_stats:
        return filt, stats
    return filt
