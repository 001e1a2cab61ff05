"""Top-level persistent homology API (Dory Algorithm 3: H0, H1*, H2*).

Port of ``src/repro/core/homology.py``: same API (numpy points in, numpy
diagrams out, ``PHResult.stats`` on the same metrics schema) plus a
``device`` argument.  Backends ``dense`` and ``tiled``; engines ``single``,
``batch`` and ``packed``.

``compute_ph`` is the user-facing entry point: point cloud or distance matrix
in, persistence diagrams out, with the paper's full pipeline — filtration +
neighborhoods, H0 union-find, cohomology reduction of edges (H1*) with
H0-clearing, then cohomology reduction of triangles (H2*) with H1*-clearing;
trivial pairs detected on the fly throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from ..analyze.invariants import sanitizing
from ..obs.metrics import MetricsRegistry
from ..obs.trace import span, stopwatch, tracing
from . import coboundary as cb
from ..device import DeviceLike, resolve_device
from .filtration import Filtration, build_filtration
from .h0 import compute_h0
from .reduction import DimensionAdapter, reduce_dimension


def make_h1_adapter(filt: Filtration, sparse: bool = True) -> DimensionAdapter:
    """H1*: columns = edge orders; lows = triangle keys."""
    min_cob = cb.min_edge_cobdy_all(filt, sparse=sparse)
    cobdy_fn = cb.edge_cobdy_sparse if sparse else cb.edge_cobdy_ns

    return DimensionAdapter(
        cobdy=lambda ids: cobdy_fn(filt, ids),
        owner_of_low=lambda lows: np.asarray(lows, dtype=np.int64) >> 32,
        min_cobdy=lambda ids: min_cob[np.asarray(ids, dtype=np.int64)],
        birth_value=lambda ids: filt.edge_len[np.asarray(ids, dtype=np.int64)],
        death_value=lambda lows: filt.edge_len[
            np.asarray(lows, dtype=np.int64) >> 32],
    )


def make_h2_adapter(filt: Filtration, sparse: bool = True) -> DimensionAdapter:
    """H2*: columns = triangle keys; lows = tetrahedron keys."""
    cobdy_fn = cb.tri_cobdy_sparse if sparse else cb.tri_cobdy_ns
    min_cache: Dict[int, int] = {}

    def min_cobdy(ids: np.ndarray) -> np.ndarray:
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        missing = [int(t) for t in ids if int(t) not in min_cache]
        if missing:
            keys = cobdy_fn(filt, np.array(missing, dtype=np.int64))
            for t, k in zip(missing, keys[:, 0]):
                min_cache[t] = int(k)
        return np.array([min_cache[int(t)] for t in ids], dtype=np.int64)

    return DimensionAdapter(
        cobdy=lambda ids: cobdy_fn(filt, ids),
        owner_of_low=lambda lows: cb.greatest_boundary_triangle(
            filt, np.asarray(lows, dtype=np.int64)),
        min_cobdy=min_cobdy,
        birth_value=lambda ids: filt.edge_len[
            np.asarray(ids, dtype=np.int64) >> 32],
        death_value=lambda lows: filt.edge_len[
            np.asarray(lows, dtype=np.int64) >> 32],
    )


def h2_columns(filt: Filtration, h1_pivots: np.ndarray,
               sparse: bool = True,
               memory_budget_bytes: Optional[int] = None) -> np.ndarray:
    """Triangle columns for H2* in decreasing F2 order, with clearing.

    Triangles are grouped by diameter edge (descending), ks descending within
    a group — exactly paper Alg. 3 lines 12-15.  Triangles that were H1*
    pivots (deaths) are cleared — one ``np.isin`` per batch rather than a
    per-triangle Python set probe, so column assembly no longer dominates at
    large ``n_e``.

    Candidate enumeration is budget-aware (the first bite at a budgeted
    reduction phase): edges that cannot own a case-1 triangle (an endpoint
    of degree < 2 has no common neighbor) are dropped up front with one
    vectorized degree gather instead of a per-edge neighborhood walk, and
    with ``memory_budget_bytes`` the per-batch enumeration transient is
    capped by sizing the edge batch to the budget rather than the fixed
    2048.  The transient is ``<= batch * max_deg`` *slots*, but each slot
    costs well more than one key: ``case1_triangles_of_edges`` materializes
    three int64 gather arrays plus a bool mask plus the packed keys
    (~40 B/slot budgeted below).  Neither knob changes the output — both
    only bound how much is materialized at once.
    """
    pivots = np.asarray(h1_pivots, dtype=np.int64)
    chunks = []
    edge_ids = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
    deg = filt.degree.astype(np.int64)
    can_own = (deg[filt.edges[edge_ids, 0]] > 1) \
        & (deg[filt.edges[edge_ids, 1]] > 1)
    edge_ids = edge_ids[can_own]
    batch = 2048
    if memory_budget_bytes is not None:
        # v/oa/ob int64 gathers (24) + ok mask (1) + packed keys out (8),
        # rounded up — per (edge, neighbor) slot of the enumeration scratch
        per_edge = 40 * max(1, int(filt.max_deg))
        batch = int(np.clip(memory_budget_bytes // per_edge, 64, 2048))
    for s in range(0, len(edge_ids), batch):
        ids = edge_ids[s:s + batch]
        groups = cb.case1_triangles_of_edges(filt, ids, sparse=sparse)
        keys = np.concatenate([g[::-1] for g in groups]) if groups \
            else np.zeros(0, dtype=np.int64)
        if keys.size and pivots.size:
            keys = keys[~np.isin(keys, pivots)]
        if keys.size:
            chunks.append(keys)
    return np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)


@dataclasses.dataclass
class PHResult:
    diagrams: Dict[int, np.ndarray]    # dim -> (k, 2) (birth, death), inf allowed
    stats: Dict[str, float]

    def betti_at(self, tau: float) -> Dict[int, int]:
        out = {}
        for d, pd in self.diagrams.items():
            if pd.size == 0:
                out[d] = 0
            else:
                out[d] = int(((pd[:, 0] <= tau) & (pd[:, 1] > tau)).sum())
        return out


def compute_ph(
    points: Optional[np.ndarray] = None,
    dists: Optional[np.ndarray] = None,
    tau_max: float = np.inf,
    maxdim: int = 2,
    mode: str = "explicit",
    sparse: Optional[bool] = None,
    filtration: Optional[Filtration] = None,
    engine: str = "single",
    batch_size: int = 128,
    backend: str = "dense",
    memory_budget_bytes: Optional[int] = None,
    tile_m: int = 2048,
    tile_n: int = 2048,
    mesh=None,
    n_shards: Optional[int] = None,
    exchange_every: int = 4,
    sanitize: Optional[bool] = None,
    trace=None,
    device: DeviceLike = None,
) -> PHResult:
    """Persistent homology up to ``maxdim`` (<= 2), Dory pipeline.

    The reference's arguments with the reference's meaning
    (``src/repro/core/homology.py``), plus ``device``: ``None`` runs on the
    card and raises ``RuntimeError`` when there is none; ``"cpu"`` runs the
    kernels' plain PyTorch versions on the host.  On the device run the
    tiled harvest's f32 candidate filter (``pairwise_sq_dists``) and, with
    ``engine="packed"``, the packed reduction's GF(2) kernels; everything
    else is the reference's host numpy, so filtrations and diagrams are
    bit-identical to it.

    mode: "explicit" stores R^⊥, "implicit" stores only V^⊥.
    sparse: neighborhoods (Dory) vs dense order matrix (DoryNS); default
    picks NS for small n and always the sparse path for streamed
    filtrations.
    engine: "single" (1-thread analog), "batch" (serial-parallel, §4.4;
    host numpy) or "packed" (serial-parallel on bit-packed GF(2) blocks).
    backend: "dense" materializes the (n, n) distance matrix; "tiled"
    streams it in (tile_m, tile_n) blocks (:mod:`repro_torch.scale`).
    With ``memory_budget_bytes`` and no finite ``tau_max`` the threshold
    is picked so the paper's ``(3n + 12 n_e) * 4`` account fits the
    budget; the same budget caps the H2* enumeration transient and bounds
    the reduction store.
    mesh: with ``backend="tiled"``, a
    :class:`~repro_torch.launch.mesh.Mesh` with a ``data`` axis shards the
    tile harvest across its entries (:mod:`repro_torch.scale.shard`; one
    ``pairwise_sq_dists`` launch a tile, each entry on its own stream) —
    output bit-identical to the serial tiled and dense builds for every
    device count — and ``memory_budget_bytes`` is then read *per device*.
    With ``engine="packed"`` the same mesh distributes the GF(2) reduction
    over its data axis (the pivot exchange a gather over it), and is then
    legal with any backend or a prebuilt filtration.  ``device`` must be
    ``None`` (the mesh's first entry runs the reduction) or of the mesh's
    device type.
    n_shards: the distributed packed reduction without a mesh (batches
    dealt round-robin over ``n_shards`` shards, fused supersteps, a pivot
    replica fed by Elias–Fano exchange rounds over a host loop-back; same
    diagrams); requires ``engine="packed"``.  ``exchange_every`` batches
    the pivot-exchange rounds (one wire round per that-many supersteps);
    diagrams are cadence-independent.
    sanitize: arm the GF(2) sanitizer
    (:mod:`repro_torch.analyze.invariants`) for the H0 and reduction
    phases of this call — cheap incremental invariant checks (pivot-low
    uniqueness, packed-segment consistency, wire round-trips, spill
    re-materialization equality) that raise a structured
    ``SanitizeViolation`` instead of returning a silently wrong diagram;
    the stats then carry ``sanitize_checks``.  ``None`` (default) defers
    to the ambient state: ``REPRO_SANITIZE``, read when the sanitizer
    module is imported, or an enclosing ``sanitizing`` scope; ``False``
    forces it off.  Any engine, device or mesh.
    trace: as in the reference (a path exports a Chrome trace, a
    :class:`~repro_torch.obs.trace.Tracer` collects, ``None`` defers to
    ``REPRO_TRACE``, ``False`` forces it off).
    """
    if mesh is not None and engine != "packed" \
            and (filtration is not None or backend != "tiled"):
        raise ValueError("mesh sharding requires backend='tiled' and no "
                         "prebuilt filtration (or engine='packed', which "
                         "distributes the reduction for any backend)")
    if n_shards is not None and engine != "packed":
        raise ValueError("n_shards distributes the reduction and requires "
                         "engine='packed'")
    if engine not in ("single", "batch", "packed"):
        raise ValueError(f"unknown engine {engine!r}")
    if backend not in ("dense", "tiled"):
        raise ValueError(f"unknown backend {backend!r}")
    harvest_shards = 1
    if mesh is not None:
        from ..launch.mesh import mesh_device
        from ..scale.shard import shard_of_mesh

        harvest_shards = shard_of_mesh(mesh)[1]
        device = mesh_device(mesh, device)
    dev = resolve_device(device)
    reg = MetricsRegistry()
    tile_stats = None
    res1 = res2 = None
    diagrams: Dict[int, np.ndarray] = {}

    with tracing(trace), span("ph/compute_ph", engine=engine, mode=mode,
                              maxdim=maxdim):
        with stopwatch("ph/filtration") as sw_filt:
            if filtration is not None:
                filt = filtration
            elif backend == "tiled":
                from ..scale import (build_filtration_sharded,
                                     build_filtration_tiled,
                                     estimate_tau_max)

                if memory_budget_bytes is not None \
                        and not np.isfinite(tau_max):
                    if points is None:
                        raise ValueError("memory_budget_bytes needs points "
                                         "to estimate tau_max")
                    # the reference passes no backend: the transient is
                    # sized as the numpy path's, and so is it here
                    tau_max = estimate_tau_max(points, memory_budget_bytes,
                                               n_shards=harvest_shards,
                                               tile_m=tile_m, tile_n=tile_n)
                    reg.gauge("tau_max_estimated").set(float(tau_max))
                if mesh is not None:
                    filt, tile_stats = build_filtration_sharded(
                        points=points, dists=dists, tau_max=tau_max,
                        tile_m=tile_m, tile_n=tile_n, mesh=mesh,
                        device=dev, return_stats=True)
                    reg.gauge("n_shards").set(float(tile_stats.n_shards))
                    reg.gauge("per_device_peak_bytes").set(
                        float(tile_stats.per_device_peak_bytes()))
                    reg.gauge("per_device_base_bytes").set(
                        float(tile_stats.per_device_base_bytes()))
                else:
                    filt, tile_stats = build_filtration_tiled(
                        points=points, dists=dists, tau_max=tau_max,
                        tile_m=tile_m, tile_n=tile_n, device=dev,
                        return_stats=True)
            else:
                filt = build_filtration(points=points, dists=dists,
                                        tau_max=tau_max)
        reg.gauge("t_filtration").set(sw_filt.elapsed)
        reg.gauge("n").set(float(filt.n))
        reg.gauge("n_e").set(float(filt.n_e))
        reg.gauge("base_memory_bytes").set(float(filt.base_memory_bytes()))
        if sparse is None:
            sparse = (not filt.has_dense_order) or filt.n > 1024
        if engine == "batch":
            from .serial_parallel import reduce_dimension_batched

            def _reduce(adapter, cols, mode=mode, cleared=None):
                return reduce_dimension_batched(
                    adapter, cols, mode=mode, cleared=cleared,
                    batch_size=batch_size,
                    store_budget_bytes=memory_budget_bytes)
        elif engine == "packed":
            from .packed_reduce import reduce_dimension_packed

            def _reduce(adapter, cols, mode=mode, cleared=None):
                # one pivot cache per dimension (created inside the call):
                # H1 and H2 lows live in different key spaces
                return reduce_dimension_packed(
                    adapter, cols, mode=mode, cleared=cleared,
                    batch_size=batch_size,
                    store_budget_bytes=memory_budget_bytes,
                    n_shards=n_shards, mesh=mesh,
                    exchange_every=exchange_every, device=dev)
        else:
            def _reduce(adapter, cols, mode=mode, cleared=None):
                return reduce_dimension(adapter, cols, mode=mode,
                                        cleared=cleared,
                                        store_budget_bytes=memory_budget_bytes)

        with sanitizing(sanitize) as san:
            with stopwatch("ph/h0") as sw:
                h0 = compute_h0(filt)
                diagrams[0] = h0.diagram()
            reg.gauge("t_h0").set(sw.elapsed)

            if maxdim >= 1:
                with stopwatch("ph/h1") as sw:
                    if san is not None:
                        san.set_context(dim=1)
                    adapter1 = make_h1_adapter(filt, sparse=sparse)
                    cols1 = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
                    res1 = _reduce(adapter1, cols1, mode=mode,
                                   cleared=h0.death_edges)
                    diagrams[1] = res1.diagram()
                reg.gauge("t_h1").set(sw.elapsed)

            if maxdim >= 2:
                with stopwatch("ph/h2") as sw:
                    if san is not None:
                        san.set_context(dim=2)
                    adapter2 = make_h2_adapter(filt, sparse=sparse)
                    cols2 = h2_columns(filt, res1.pivot_lows, sparse=sparse,
                                       memory_budget_bytes=memory_budget_bytes)
                    res2 = _reduce(adapter2, cols2, mode=mode)
                    diagrams[2] = res2.diagram()
                reg.gauge("t_h2").set(sw.elapsed)
            if san is not None:
                reg.counter("sanitize_checks").inc(sum(san.counts.values()))
                san.set_context(dim=None)

        # memory observability: the observed harvest/reduction high-water
        # marks next to the predicted (3n + 12 n_e) * 4 account
        from ..scale.budget import account_bytes

        predicted = float(account_bytes(filt.n, filt.n_e))
        reg.gauge("predicted_account_bytes").set(predicted)
        obs_harvest = 0.0
        if tile_stats is not None:
            obs_harvest = float(tile_stats.peak_extra_bytes())
            reg.gauge("observed_peak_harvest_bytes").record_max(obs_harvest)
        obs_reduce = 0.0
        for res in (res1, res2):
            if res is not None:
                obs_reduce = max(
                    obs_reduce,
                    res.stats.get("stored_bytes", 0.0)
                    + res.stats.get("peak_block_bytes", 0.0))
        reg.gauge("observed_peak_reduce_bytes").record_max(obs_reduce)
        base = float(filt.base_memory_bytes())
        reg.gauge("budget_drift_ratio").set(
            (base + max(obs_harvest, obs_reduce)) / max(predicted, 1.0))

    stats: Dict[str, float] = reg.as_stats()
    for prefix, res in (("h1", res1), ("h2", res2)):
        if res is not None:
            for k, v in res.stats.items():
                stats[f"{prefix}_{k}"] = v
    return PHResult(diagrams=diagrams, stats=stats)
