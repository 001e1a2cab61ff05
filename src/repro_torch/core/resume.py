"""Resumable reduction state and exact warm-start incremental updates.

Port of ``src/repro/core/resume.py``.  Host numpy, as in the reference,
except the reductions: :func:`make_reducer` takes ``device`` last and the
packed engine runs its GF(2) kernels there.  Checkpoints are the
reference's byte for byte — same arrays, dtypes, record order and
``content_hash`` — so a checkpoint saved by either package loads in the
other.  The ``resume.load`` injection point keeps its own load ordinal.

PH-as-a-service (``repro_torch.serve.ph``) needs ``compute_ph``-quality
answers without paying a cold reduction for every request.  This module
captures the reduction's *replayable* state — per dimension, every
committed pair with its pivot low and owning column, plus the full raw-δ
V-expansion of each non-trivial committed and essential column — into a
:class:`ReductionCheckpoint`, and serves two exact warm-start updates on
top of it:

* **tau growth** (:func:`warm_tau_growth`) — the threshold grows on a cached
  dataset.  New edges are strictly longer than every old edge, so their
  cofacet keys are strictly larger than every old key; pairs recorded at the
  old threshold are *canonically preserved* and only (a) the new columns and
  (b) the previously-essential columns — seeded with their recorded
  residual ``⊕ δ(gens ∪ {col})`` — need reducing.  The phase-2 reduction
  lives entirely in new-key space (an old essential column's old keys cancel
  inside the seed), so it never probes an old pivot: the warm run skips the
  paired columns outright.
* **point arrival** (:func:`warm_point_arrival`) — points append to a cached
  dataset at the same threshold.  Arrivals can re-route deaths, so no old
  pair may be assumed; instead every old column *replays* from its recorded
  V-expansion (old edge orders remapped into the new filtration through the
  canonical ``(length, i, j)`` sort, which preserves their relative order).
  Seeding a column with ``⊕ δ_new(gens ∪ {col})`` is a valid left-to-right
  partial reduction — every gen precedes the column in decreasing filtration
  order — so completing it greedily reproduces the canonical pairing,
  bit-identical to a cold run (Li & Cisewski-Kehe's mergeable-PH observation,
  arXiv 2410.01839, in cohomology form).

Both paths run on any reduction engine (``single``/``batch``/``packed``,
including the packed engine's distributed ``n_shards`` driver) and re-capture
a fresh checkpoint, so updates chain.  Capture requires tracked
δ-expansions: ``mode="implicit"`` or a finite ``store_budget_bytes``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike, resolve_device
from ..resilience.faults import CheckpointCorruption, active_injector, flip_bit
from .filtration import Filtration, filtration_from_edges
from .h0 import compute_h0
from .homology import h2_columns, make_h1_adapter, make_h2_adapter
from .reduction import reduce_dimension

_KEY_MASK = np.int64((1 << 32) - 1)

#: on-disk format version of ReductionCheckpoint.save; bumped on layout
#: changes so a stale file is rejected as corrupt, never misparsed
CHECKPOINT_VERSION = 1

# ordinal of ReductionCheckpoint.load calls in this process — the
# occurrence index the ``resume.load`` injection point fires against
_LOAD_ORDINAL = 0


@dataclasses.dataclass
class DimState:
    """Replayable reduction state of one dimension (H1* or H2*)."""

    pairs: np.ndarray          # (k, 2) float64 finite diagram pairs (d > b)
    pair_cols: np.ndarray      # (k,) int64 owning column ids
    essentials: np.ndarray     # (m,) float64 births of essential classes
    essential_ids: np.ndarray  # (m,) int64 essential column ids
    pivot_lows: np.ndarray     # (p,) int64 all pivot lows (incl. trivial)
    pivot_cols: np.ndarray     # (p,) int64 their owning columns
    gens: Dict[int, np.ndarray]  # col id -> full raw-δ V-expansion

    def diagram(self) -> np.ndarray:
        ess = np.stack([self.essentials,
                        np.full_like(self.essentials, np.inf)], axis=1) \
            if self.essentials.size else np.zeros((0, 2))
        return np.concatenate([self.pairs, ess], axis=0)

    def nbytes(self) -> int:
        arrs = (self.pairs, self.pair_cols, self.essentials,
                self.essential_ids, self.pivot_lows, self.pivot_cols)
        return int(sum(a.nbytes for a in arrs)
                   + sum(g.nbytes for g in self.gens.values()))


@dataclasses.dataclass
class ReductionCheckpoint:
    """Everything a warm restart needs about a finished reduction."""

    n: int                     # vertex count of the captured filtration
    n_e: int                   # edge count
    edges: np.ndarray          # (n_e, 2) int32 — identity check + remapping
    tau_max: float
    maxdim: int
    dims: Dict[int, DimState]  # 1 and/or 2

    def nbytes(self) -> int:
        return int(self.edges.nbytes
                   + sum(d.nbytes() for d in self.dims.values()))

    # ---- integrity + versioned persistence ----

    def content_hash(self) -> str:
        """sha256 over the checkpoint's entire replayable content.

        Scalars, edges, and every DimState array (gens in sorted col-id
        order) feed one canonical byte stream — two checkpoints hash equal
        iff a warm restart from them is bit-identical."""
        h = hashlib.sha256()
        h.update(np.array([self.n, self.n_e, self.maxdim],
                          dtype=np.int64).tobytes())
        h.update(np.float64(self.tau_max).tobytes())
        h.update(np.ascontiguousarray(self.edges, dtype=np.int32).tobytes())
        for d in sorted(self.dims):
            st = self.dims[d]
            h.update(np.int64(d).tobytes())
            for arr in (st.pairs, st.pair_cols, st.essentials,
                        st.essential_ids, st.pivot_lows, st.pivot_cols):
                h.update(np.ascontiguousarray(arr).tobytes())
            for cid in sorted(st.gens):
                h.update(np.int64(cid).tobytes())
                h.update(np.ascontiguousarray(st.gens[cid],
                                              dtype=np.int64).tobytes())
        return h.hexdigest()

    def save(self, path: str) -> str:
        """Versioned, hash-stamped save (npz).  Atomic: writes to a temp
        sibling and renames, so a crashed save never shadows a good file.
        Returns :meth:`content_hash`."""
        digest = self.content_hash()
        arrays: Dict[str, np.ndarray] = {
            "__meta__": np.array([CHECKPOINT_VERSION, self.n, self.n_e,
                                  self.maxdim], dtype=np.int64),
            "__tau__": np.float64([self.tau_max]),
            "__hash__": np.frombuffer(bytes.fromhex(digest),
                                      dtype=np.uint8).copy(),
            "edges": np.ascontiguousarray(self.edges, dtype=np.int32),
        }
        for d, st in self.dims.items():
            p = f"dim{d}_"
            arrays[p + "pairs"] = st.pairs
            arrays[p + "pair_cols"] = st.pair_cols
            arrays[p + "essentials"] = st.essentials
            arrays[p + "essential_ids"] = st.essential_ids
            arrays[p + "pivot_lows"] = st.pivot_lows
            arrays[p + "pivot_cols"] = st.pivot_cols
            ids = np.array(sorted(st.gens), dtype=np.int64)
            arrays[p + "gen_ids"] = ids
            offs = np.zeros(ids.size + 1, dtype=np.int64)
            data = [np.ascontiguousarray(st.gens[int(c)], dtype=np.int64)
                    for c in ids]
            if data:
                np.cumsum([g.size for g in data], out=offs[1:])
            arrays[p + "gen_offsets"] = offs
            arrays[p + "gen_data"] = (np.concatenate(data) if data
                                      else np.zeros(0, dtype=np.int64))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
        return digest

    @classmethod
    def load(cls, path: str) -> "ReductionCheckpoint":
        """Inverse of :meth:`save` with integrity checking.

        Raises :class:`~repro_torch.resilience.faults.CheckpointCorruption`
        on a truncated/unparseable file, an unsupported format version, or
        a content-hash mismatch — callers fall back to a cold reduction
        (detect corrupt, fall back to cold).  The ``resume.load`` injection
        point fires here, corrupting the *in-memory* read buffer so tests
        exercise every rejection path without touching the file on disk;
        its occurrence index is this module's count of loads in the
        process (``_LOAD_ORDINAL``)."""
        global _LOAD_ORDINAL
        _LOAD_ORDINAL += 1
        with open(path, "rb") as f:
            raw = f.read()
        inj = active_injector()
        if inj is not None:
            for fault in inj.fire("resume.load", index=_LOAD_ORDINAL,
                                  path=path):
                if fault.kind == "bitflip":
                    raw = flip_bit(raw, int(fault.param("bit", 12345)))
                elif fault.kind == "truncate":
                    raw = raw[:max(1, len(raw) // 2)]
        try:
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            raise CheckpointCorruption(
                f"unreadable checkpoint {path!r}: {e}") from e
        try:
            meta = arrays["__meta__"]
            version = int(meta[0])
            if version != CHECKPOINT_VERSION:
                raise CheckpointCorruption(
                    f"checkpoint {path!r} has version {version}, "
                    f"expected {CHECKPOINT_VERSION}")
            dims: Dict[int, DimState] = {}
            for d in (1, 2):
                p = f"dim{d}_"
                if p + "pairs" not in arrays:
                    continue
                ids = arrays[p + "gen_ids"]
                offs = arrays[p + "gen_offsets"]
                data = arrays[p + "gen_data"]
                gens = {int(c): data[offs[i]:offs[i + 1]].copy()
                        for i, c in enumerate(ids)}
                dims[d] = DimState(
                    pairs=arrays[p + "pairs"],
                    pair_cols=arrays[p + "pair_cols"],
                    essentials=arrays[p + "essentials"],
                    essential_ids=arrays[p + "essential_ids"],
                    pivot_lows=arrays[p + "pivot_lows"],
                    pivot_cols=arrays[p + "pivot_cols"],
                    gens=gens)
            ckpt = cls(n=int(meta[1]), n_e=int(meta[2]),
                       edges=arrays["edges"],
                       tau_max=float(arrays["__tau__"][0]),
                       maxdim=int(meta[3]), dims=dims)
            stored = bytes(arrays["__hash__"]).hex()
        except CheckpointCorruption:
            raise
        except Exception as e:
            raise CheckpointCorruption(
                f"malformed checkpoint {path!r}: {e}") from e
        if ckpt.content_hash() != stored:
            raise CheckpointCorruption(
                f"checkpoint {path!r} content hash mismatch "
                "(bit rot or partial write)")
        return ckpt


def make_reducer(engine: str = "single", mode: str = "implicit",
                 batch_size: int = 128,
                 store_budget_bytes: Optional[int] = None,
                 n_shards: Optional[int] = None,
                 device: DeviceLike = None) -> Callable:
    """Engine dispatch with the capture/warm-start kwargs threaded through.

    Returns ``run(adapter, cols, cleared, seed_gens, commit_log,
    essential_log) -> ReductionResult``.  Capture needs every committed
    column's *full* δ-expansion, which the stores only track in implicit
    mode or under a store budget — explicit unbudgeted runs are rejected
    up front rather than producing silently incomplete checkpoints.

    ``device`` (the reference's parameters, then this one) is resolved
    here: ``None`` is the card and raises ``RuntimeError`` without one,
    ``"cpu"`` runs the kernels' plain versions.  The packed engine runs
    its GF(2) kernels on it; ``single`` and ``batch`` are host engines
    and only check it.
    """
    if mode == "explicit" and store_budget_bytes is None:
        raise ValueError(
            "checkpoint capture needs tracked δ-expansions: use "
            "mode='implicit' or set store_budget_bytes")
    if n_shards is not None and engine != "packed":
        raise ValueError("n_shards requires engine='packed'")
    if engine not in ("single", "batch", "packed"):
        raise ValueError(f"unknown engine {engine!r}")
    dev = resolve_device(device)
    if engine == "single":
        def run(adapter, cols, cleared, seed_gens, commit_log, essential_log):
            return reduce_dimension(
                adapter, cols, mode=mode, cleared=cleared,
                store_budget_bytes=store_budget_bytes, seed_gens=seed_gens,
                commit_log=commit_log, essential_log=essential_log)
    elif engine == "batch":
        from .serial_parallel import reduce_dimension_batched

        def run(adapter, cols, cleared, seed_gens, commit_log, essential_log):
            return reduce_dimension_batched(
                adapter, cols, mode=mode, cleared=cleared,
                batch_size=batch_size,
                store_budget_bytes=store_budget_bytes, seed_gens=seed_gens,
                commit_log=commit_log, essential_log=essential_log)
    else:
        from .packed_reduce import reduce_dimension_packed

        def run(adapter, cols, cleared, seed_gens, commit_log, essential_log):
            return reduce_dimension_packed(
                adapter, cols, mode=mode, cleared=cleared,
                batch_size=batch_size,
                store_budget_bytes=store_budget_bytes, n_shards=n_shards,
                seed_gens=seed_gens, commit_sink=commit_log,
                essential_log=essential_log, device=dev)
    return run


def _dim_state(res, commit_log: list, essential_log: list) -> DimState:
    gens: Dict[int, np.ndarray] = {}
    for rec in commit_log:
        g = rec.get("gens")
        if g is None:
            raise ValueError("commit record carries no δ-expansion — "
                             "capture requires a gens-tracking store")
        gens[int(rec["col_id"])] = np.asarray(g, dtype=np.int64)
    for rec in essential_log:
        gens[int(rec["col_id"])] = np.asarray(rec["gens"], dtype=np.int64)
    return DimState(
        pairs=res.pairs, pair_cols=res.pair_cols,
        essentials=res.essentials, essential_ids=res.essential_ids,
        pivot_lows=res.pivot_lows, pivot_cols=res.pivot_cols, gens=gens)


def _h1_cols(filt: Filtration) -> np.ndarray:
    return np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)


def _seed_map(state: DimState, only: Optional[np.ndarray] = None
              ) -> Dict[int, np.ndarray]:
    if only is None:
        return dict(state.gens)
    keep = set(int(c) for c in only)
    return {c: g for c, g in state.gens.items() if c in keep}


def cold_reduce(
    filt: Filtration,
    maxdim: int = 2,
    sparse: bool = True,
    memory_budget_bytes: Optional[int] = None,
    reducer: Optional[Callable] = None,
    **reducer_opts,
) -> Tuple[Dict[int, np.ndarray], ReductionCheckpoint]:
    """The ``compute_ph`` pipeline with checkpoint capture.

    Returns ``(diagrams, checkpoint)``; diagrams are bit-identical to
    ``compute_ph(filtration=filt, ...)`` (asserted in the serve test
    suite).  ``reducer`` defaults to :func:`make_reducer`\\ ``(**opts)``.
    """
    run = reducer if reducer is not None else make_reducer(**reducer_opts)
    diagrams: Dict[int, np.ndarray] = {}
    dims: Dict[int, DimState] = {}
    h0 = compute_h0(filt)
    diagrams[0] = h0.diagram()
    res1 = None
    if maxdim >= 1:
        adapter1 = make_h1_adapter(filt, sparse=sparse)
        clog: list = []
        elog: list = []
        res1 = run(adapter1, _h1_cols(filt), h0.death_edges, None, clog, elog)
        diagrams[1] = res1.diagram()
        dims[1] = _dim_state(res1, clog, elog)
    if maxdim >= 2:
        adapter2 = make_h2_adapter(filt, sparse=sparse)
        cols2 = h2_columns(filt, res1.pivot_lows, sparse=sparse,
                           memory_budget_bytes=memory_budget_bytes)
        clog, elog = [], []
        res2 = run(adapter2, cols2, None, None, clog, elog)
        diagrams[2] = res2.diagram()
        dims[2] = _dim_state(res2, clog, elog)
    ckpt = ReductionCheckpoint(
        n=filt.n, n_e=filt.n_e, edges=np.array(filt.edges, dtype=np.int32),
        tau_max=float(filt.tau_max), maxdim=maxdim, dims=dims)
    return diagrams, ckpt


def _merge_tau_growth(old: DimState, new: DimState,
                      new_gens: Dict[int, np.ndarray]) -> DimState:
    """Checkpoint state after a tau-growth phase 2: preserved old pairs plus
    the phase-2 results; every old essential column was re-examined in
    phase 2, so its expansion record is superseded by the warm log."""
    gens = dict(old.gens)
    gens.update(new_gens)
    return DimState(
        pairs=np.concatenate([old.pairs, new.pairs], axis=0),
        pair_cols=np.concatenate([old.pair_cols, new.pair_cols]),
        essentials=new.essentials,
        essential_ids=new.essential_ids,
        pivot_lows=np.concatenate([old.pivot_lows, new.pivot_lows]),
        pivot_cols=np.concatenate([old.pivot_cols, new.pivot_cols]),
        gens=gens)


def warm_tau_growth(
    filt: Filtration,
    ckpt: ReductionCheckpoint,
    sparse: bool = True,
    memory_budget_bytes: Optional[int] = None,
    reducer: Optional[Callable] = None,
    **reducer_opts,
) -> Tuple[Dict[int, np.ndarray], ReductionCheckpoint]:
    """Exact warm start when ``filt`` extends ``ckpt``'s filtration in tau.

    Old pairs are preserved verbatim; only new columns and previously
    essential columns (seeded with their recorded residuals) reduce.  The
    module docstring carries the exactness argument.  Raises ``ValueError``
    when ``filt`` does not extend the checkpoint (callers fall back cold).
    """
    if filt.n != ckpt.n or filt.n_e < ckpt.n_e \
            or not np.array_equal(filt.edges[:ckpt.n_e],
                                  ckpt.edges.astype(filt.edges.dtype)):
        raise ValueError("filtration does not extend the checkpoint "
                         "(tau growth requires identical points and a "
                         "prefix-stable edge order)")
    run = reducer if reducer is not None else make_reducer(**reducer_opts)
    diagrams: Dict[int, np.ndarray] = {}
    dims: Dict[int, DimState] = {}
    h0 = compute_h0(filt)
    diagrams[0] = h0.diagram()
    maxdim = ckpt.maxdim
    merged1 = None
    if maxdim >= 1:
        old1 = ckpt.dims[1]
        adapter1 = make_h1_adapter(filt, sparse=sparse)
        # skip every previously paired column (its pair is canonical) on
        # top of the usual H0 clearing
        cleared = np.concatenate([np.asarray(h0.death_edges, dtype=np.int64),
                                  old1.pivot_cols])
        seeds = _seed_map(old1, only=old1.essential_ids)
        clog: list = []
        elog: list = []
        res1 = run(adapter1, _h1_cols(filt), cleared, seeds, clog, elog)
        warm_gens = _dim_state(res1, clog, elog).gens
        merged1 = _merge_tau_growth(old1, res1, warm_gens)
        diagrams[1] = merged1.diagram()
        dims[1] = merged1
    if maxdim >= 2:
        old2 = ckpt.dims[2]
        adapter2 = make_h2_adapter(filt, sparse=sparse)
        cols2 = h2_columns(filt, merged1.pivot_lows, sparse=sparse,
                           memory_budget_bytes=memory_budget_bytes)
        seeds = _seed_map(old2, only=old2.essential_ids)
        clog, elog = [], []
        res2 = run(adapter2, cols2, old2.pivot_cols, seeds, clog, elog)
        warm_gens = _dim_state(res2, clog, elog).gens
        merged2 = _merge_tau_growth(old2, res2, warm_gens)
        diagrams[2] = merged2.diagram()
        dims[2] = merged2
    new_ckpt = ReductionCheckpoint(
        n=filt.n, n_e=filt.n_e, edges=np.array(filt.edges, dtype=np.int32),
        tau_max=float(filt.tau_max), maxdim=maxdim, dims=dims)
    return diagrams, new_ckpt


def edge_order_map(ckpt: ReductionCheckpoint, filt: Filtration) -> np.ndarray:
    """Old edge order -> new edge order after points arrived.

    Old vertices keep their ids and old edge lengths are unchanged, so each
    old ``(i, j)`` appears exactly once in the new filtration; the canonical
    ``(length, i, j)`` sort preserves the *relative* order of old edges.
    Raises ``ValueError`` if any old edge is missing (not an extension).
    """
    n = max(int(filt.n), int(ckpt.n)) + 1
    old_code = (ckpt.edges[:, 0].astype(np.int64) * n
                + ckpt.edges[:, 1].astype(np.int64))
    new_code = (filt.edges[:, 0].astype(np.int64) * n
                + filt.edges[:, 1].astype(np.int64))
    order = np.argsort(new_code, kind="stable")
    pos = np.searchsorted(new_code[order], old_code)
    if (pos >= len(new_code)).any() \
            or not np.array_equal(new_code[order][pos], old_code):
        raise ValueError("new filtration does not contain every old edge")
    emap = order[pos].astype(np.int64)
    if not (np.diff(emap) > 0).all():
        raise ValueError("old edge order not preserved in new filtration")
    return emap


def _remap_tri_keys(keys: np.ndarray, emap: np.ndarray) -> np.ndarray:
    """Triangle keys ``(diam_edge_order << 32) | vertex`` under an edge-order
    remap (vertex ids are stable across point arrival)."""
    keys = np.asarray(keys, dtype=np.int64)
    return (emap[keys >> 32] << np.int64(32)) | (keys & _KEY_MASK)


def _remap_seeds(state: DimState, dim: int, emap: np.ndarray
                 ) -> Dict[int, np.ndarray]:
    """Recorded V-expansions in the new filtration's id space."""
    out: Dict[int, np.ndarray] = {}
    for col, g in state.gens.items():
        if dim == 1:
            out[int(emap[col])] = emap[np.asarray(g, dtype=np.int64)]
        else:
            key = int(_remap_tri_keys(np.array([col], dtype=np.int64),
                                      emap)[0])
            out[key] = _remap_tri_keys(g, emap)
    return out


def warm_point_arrival(
    filt: Filtration,
    ckpt: ReductionCheckpoint,
    sparse: bool = True,
    memory_budget_bytes: Optional[int] = None,
    reducer: Optional[Callable] = None,
    **reducer_opts,
) -> Tuple[Dict[int, np.ndarray], ReductionCheckpoint]:
    """Exact warm start when points arrived on ``ckpt``'s dataset.

    Arrivals may re-route deaths, so every old column replays — but from
    its recorded V-expansion (remapped through :func:`edge_order_map`), not
    from scratch: a seeded column starts at the residual its old reduction
    ended on, and the greedy completion reproduces the canonical pairing of
    the *new* complex (module docstring).  Returns full diagrams plus a
    fresh checkpoint, bit-identical to a cold run.
    """
    if filt.n < ckpt.n:
        raise ValueError("point arrival requires a vertex superset")
    emap = edge_order_map(ckpt, filt)
    run = reducer if reducer is not None else make_reducer(**reducer_opts)
    diagrams: Dict[int, np.ndarray] = {}
    dims: Dict[int, DimState] = {}
    h0 = compute_h0(filt)
    diagrams[0] = h0.diagram()
    maxdim = ckpt.maxdim
    res1 = None
    if maxdim >= 1:
        adapter1 = make_h1_adapter(filt, sparse=sparse)
        seeds = _remap_seeds(ckpt.dims[1], 1, emap)
        clog: list = []
        elog: list = []
        res1 = run(adapter1, _h1_cols(filt), h0.death_edges, seeds, clog,
                   elog)
        diagrams[1] = res1.diagram()
        dims[1] = _dim_state(res1, clog, elog)
    if maxdim >= 2:
        adapter2 = make_h2_adapter(filt, sparse=sparse)
        cols2 = h2_columns(filt, res1.pivot_lows, sparse=sparse,
                           memory_budget_bytes=memory_budget_bytes)
        seeds = _remap_seeds(ckpt.dims[2], 2, emap)
        clog, elog = [], []
        res2 = run(adapter2, cols2, None, seeds, clog, elog)
        diagrams[2] = res2.diagram()
        dims[2] = _dim_state(res2, clog, elog)
    new_ckpt = ReductionCheckpoint(
        n=filt.n, n_e=filt.n_e, edges=np.array(filt.edges, dtype=np.int32),
        tau_max=float(filt.tau_max), maxdim=maxdim, dims=dims)
    return diagrams, new_ckpt


def split_batch_state(state: DimState, dim: int,
                      edge_bounds: np.ndarray, vtx_bounds: np.ndarray,
                      cloud: int) -> DimState:
    """One cloud's :class:`DimState` out of a batched union reduction.

    A union filtration of disjoint clouds is block-diagonal: the reduction
    decomposes exactly, and every key of cloud ``k`` rebuilds its local id
    by subtracting the cloud's edge-order / vertex offsets.  ``edge_bounds``
    / ``vtx_bounds`` are the (C+1,) cumulative offsets of the union build.
    """
    e0, e1 = int(edge_bounds[cloud]), int(edge_bounds[cloud + 1])
    v0 = int(vtx_bounds[cloud])

    def col_cloud(cols: np.ndarray) -> np.ndarray:
        owner = cols if dim == 1 else (np.asarray(cols, dtype=np.int64) >> 32)
        return (owner >= e0) & (owner < e1)

    def remap_cols(cols: np.ndarray) -> np.ndarray:
        cols = np.asarray(cols, dtype=np.int64)
        if dim == 1:
            return cols - e0
        return ((cols >> 32) - e0 << np.int64(32)) | ((cols & _KEY_MASK) - v0)

    def remap_lows(lows: np.ndarray) -> np.ndarray:
        lows = np.asarray(lows, dtype=np.int64)
        if dim == 1:   # triangle keys: (diam edge << 32) | vertex
            return ((lows >> 32) - e0 << np.int64(32)) \
                | ((lows & _KEY_MASK) - v0)
        # tetra keys: (max edge << 32) | opposite edge
        return ((lows >> 32) - e0 << np.int64(32)) \
            | ((lows & _KEY_MASK) - e0)

    pair_in = col_cloud(state.pair_cols)
    ess_in = col_cloud(state.essential_ids)
    piv_in = col_cloud(state.pivot_cols)
    gens: Dict[int, np.ndarray] = {}
    for col, g in state.gens.items():
        owner = col if dim == 1 else col >> 32
        if e0 <= owner < e1:
            col_l = int(remap_cols(np.array([col], dtype=np.int64))[0])
            gens[col_l] = remap_cols(g)
    return DimState(
        pairs=state.pairs[pair_in],
        pair_cols=remap_cols(state.pair_cols[pair_in]),
        essentials=state.essentials[ess_in],
        essential_ids=remap_cols(state.essential_ids[ess_in]),
        pivot_lows=remap_lows(state.pivot_lows[piv_in]),
        pivot_cols=remap_cols(state.pivot_cols[piv_in]),
        gens=gens)


def union_filtration(filts: List[Filtration]
                     ) -> Tuple[Filtration, np.ndarray, np.ndarray]:
    """Disjoint union of per-cloud filtrations as one block filtration.

    Vertices and edges of cloud ``k`` shift by the cumulative offsets; each
    cloud's canonical edge order is kept as a contiguous block
    (``presorted=True``), so the union coboundary is block-diagonal and any
    engine's reduction of the union restricts *exactly* to each cloud's
    standalone reduction — the batching trick behind the packed serve path.
    Returns ``(filtration, vtx_bounds, edge_bounds)`` with the (C+1,)
    cumulative offsets used by :func:`split_batch_state`.
    """
    if not filts:
        raise ValueError("need at least one filtration")
    ns = np.array([f.n for f in filts], dtype=np.int64)
    nes = np.array([f.n_e for f in filts], dtype=np.int64)
    vtx_bounds = np.concatenate([[0], np.cumsum(ns)])
    edge_bounds = np.concatenate([[0], np.cumsum(nes)])
    iu = np.concatenate([f.edges[:, 0].astype(np.int64) + vtx_bounds[k]
                         for k, f in enumerate(filts)])
    ju = np.concatenate([f.edges[:, 1].astype(np.int64) + vtx_bounds[k]
                         for k, f in enumerate(filts)])
    lens = np.concatenate([f.edge_len for f in filts])
    tau = max(float(f.tau_max) for f in filts)
    filt = filtration_from_edges(int(vtx_bounds[-1]), iu, ju, lens, tau,
                                 presorted=True)
    return filt, vtx_bounds, edge_bounds


def batched_cold_reduce(
    filts: List[Filtration],
    maxdim: int = 2,
    sparse: bool = True,
    memory_budget_bytes: Optional[int] = None,
    reducer: Optional[Callable] = None,
    **reducer_opts,
) -> List[Tuple[Dict[int, np.ndarray], ReductionCheckpoint]]:
    """Reduce many small clouds as *one* union reduction, split exactly.

    One engine invocation per dimension amortizes batching / packing /
    dispatch overhead across all clouds; block-diagonality makes every
    per-cloud diagram and checkpoint bit-identical to a standalone
    :func:`cold_reduce` (asserted in ``tests/test_torch_resume.py``).  H0
    runs per cloud — union-find is cheap and its death edges concatenate
    into the union clearing list.
    """
    if len(filts) == 1:
        return [cold_reduce(filts[0], maxdim=maxdim, sparse=sparse,
                            memory_budget_bytes=memory_budget_bytes,
                            reducer=reducer, **reducer_opts)]
    run = reducer if reducer is not None else make_reducer(**reducer_opts)
    union, vtx_bounds, edge_bounds = union_filtration(filts)
    h0s = [compute_h0(f) for f in filts]
    out_diagrams: List[Dict[int, np.ndarray]] = [
        {0: h0.diagram()} for h0 in h0s]
    out_dims: List[Dict[int, DimState]] = [dict() for _ in filts]
    res1 = None
    if maxdim >= 1:
        adapter1 = make_h1_adapter(union, sparse=sparse)
        cleared = np.concatenate(
            [np.asarray(h0.death_edges, dtype=np.int64) + edge_bounds[k]
             for k, h0 in enumerate(h0s)])
        clog: list = []
        elog: list = []
        res1 = run(adapter1, _h1_cols(union), cleared, None, clog, elog)
        state1 = _dim_state(res1, clog, elog)
        for k in range(len(filts)):
            out_dims[k][1] = split_batch_state(state1, 1, edge_bounds,
                                               vtx_bounds, k)
            out_diagrams[k][1] = out_dims[k][1].diagram()
    if maxdim >= 2:
        adapter2 = make_h2_adapter(union, sparse=sparse)
        cols2 = h2_columns(union, res1.pivot_lows, sparse=sparse,
                           memory_budget_bytes=memory_budget_bytes)
        clog, elog = [], []
        res2 = run(adapter2, cols2, None, None, clog, elog)
        state2 = _dim_state(res2, clog, elog)
        for k in range(len(filts)):
            out_dims[k][2] = split_batch_state(state2, 2, edge_bounds,
                                               vtx_bounds, k)
            out_diagrams[k][2] = out_dims[k][2].diagram()
    out = []
    for k, f in enumerate(filts):
        ckpt = ReductionCheckpoint(
            n=f.n, n_e=f.n_e, edges=np.array(f.edges, dtype=np.int32),
            tau_max=float(f.tau_max), maxdim=maxdim, dims=out_dims[k])
        out.append((out_diagrams[k], ckpt))
    return out


def canonical_diagram(diagram: np.ndarray) -> np.ndarray:
    """Rows sorted lexicographically by (birth, death) — one canonical
    presentation per diagram multiset, so any two exact pipelines (cold,
    warm, batched-union) compare bit-equal with ``np.array_equal``."""
    d = np.asarray(diagram, dtype=np.float64).reshape(-1, 2)
    if d.size == 0:
        return d
    return d[np.lexsort((d[:, 1], d[:, 0]))]
