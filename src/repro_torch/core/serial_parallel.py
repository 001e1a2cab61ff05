"""Serial-parallel batched reduction (Dory §4.4).

Port of ``src/repro/core/serial_parallel.py``.  Host numpy, as in the
reference: this is the paper's batched engine, not a kernel path.  It
takes the reference's parameters in its order, the warm-restart hooks
(``seed_gens``, ``commit_log``, ``essential_log``) included.

Rather than reducing one column at a time, a *batch* of B columns is
processed per round:

* **parallel** phase — every batch column is reduced against the already
  committed ``R^⊥`` (and against trivial owners) independently; this is the
  embarrassingly-parallel part the paper maps to threads and we map to
  vectorized/batched work.
* **serial** phase — intra-batch pivot collisions are resolved in filtration
  order: a column may only absorb a *marked* (fully reduced) earlier batch
  mate, falling back to the parallel rule whenever its new low re-enters the
  committed table (paper Fig. 14-15 precedence rules).
* **clearance** — all resolved columns commit pivots/pairs at once and the
  batch window slides.

Semantics are identical to the single-column engine (asserted in tests); the
batch size trades parallel width against serial-merge work, matching the
paper's batch-size hyperparameter discussion.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..obs.metrics import MetricsRegistry
from ..obs.trace import span
from .pairing import EMPTY_KEY
from .reduction import (DimensionAdapter, PivotStore, ReductionResult,
                        clearance_commit, clearing_filter, finalize_result,
                        merge_cancel, seed_column, self_owner_of,
                        store_gens)


def _reduce_vs_store(store: PivotStore, adapter: DimensionAdapter,
                     r: np.ndarray, col_id: int,
                     gens: Dict[int, int]) -> Tuple[np.ndarray, int]:
    """Reduce r against committed pivots + trivial owners until its low is
    fresh (the parallel-phase rule).  Returns the partially-reduced r and
    the number of GF(2) column additions performed (the unit every engine
    counts, so cross-engine reductions/sec is comparable)."""
    n_adds = 0
    while r.size:
        low = int(r[0])
        addend = store.lookup_addend(low, col_id)
        if addend is None:
            break
        owner = self_owner_of(store, adapter, low)
        gens[owner] = gens.get(owner, 0) + 1
        for g in store_gens(store, low):
            gens[int(g)] = gens.get(int(g), 0) + 1
        r = merge_cancel(r, addend)
        n_adds += 1
    return r, n_adds


def reduce_dimension_batched(
    adapter: DimensionAdapter,
    column_ids: np.ndarray,
    mode: str = "explicit",
    cleared=None,
    batch_size: int = 128,
    store_budget_bytes: Optional[int] = None,
    seed_gens: Optional[Dict[int, np.ndarray]] = None,
    commit_log: Optional[list] = None,
    essential_log: Optional[list] = None,
) -> ReductionResult:
    """Serial-parallel batched reduction (module docstring).

    ``store_budget_bytes`` bounds the pivot store exactly like the single
    engine's: explicit ``R^⊥`` columns past the budget spill to implicit
    ``V^⊥`` form, largest-explicit-column-first (see :class:`PivotStore`).
    ``seed_gens`` / ``commit_log`` / ``essential_log`` carry the same warm
    restart + capture contract as :func:`~repro_torch.core.reduction
    .reduce_dimension` (seeded columns start from their recorded residual;
    commits and essential expansions are logged for checkpointing).
    """
    store = PivotStore(adapter, mode, store_budget_bytes=store_budget_bytes,
                       commit_log=commit_log)
    pairs: List[tuple] = []
    essentials: List[float] = []
    essential_ids: List[int] = []
    n_reductions = 0
    queue = clearing_filter(column_ids, cleared)

    for s in range(0, len(queue), batch_size):
        ids = queue[s:s + batch_size]
        B = len(ids)
        # ---- materialize coboundaries for the whole batch (vectorized) ----
        cob = adapter.cobdy(ids)
        rs: List[np.ndarray] = [row[row != EMPTY_KEY] for row in cob]
        gens: List[Dict[int, int]] = [dict() for _ in range(B)]
        if seed_gens:
            for i in range(B):
                seed = seed_gens.get(int(ids[i]))
                if seed is not None and len(seed):
                    rs[i] = seed_column(adapter, int(ids[i]), seed)
                    gens[i] = {int(g): 1 for g in seed}
        marked = [False] * B
        empty = [False] * B

        # ---- parallel phase ----
        with span("reduce/parallel", batch=s // batch_size, n=B):
            for i in range(B):
                rs[i], n_adds = _reduce_vs_store(store, adapter, rs[i],
                                                 int(ids[i]), gens[i])
                n_reductions += n_adds

        # ---- serial phase (in filtration order within the batch) ----
        # marked columns are final and hold pairwise-distinct lows, so one
        # low -> batch-index dict replaces the former O(B^2) linear scan
        # for a marked mate with the same low
        marked_low_to_j: Dict[int, int] = {}
        with span("reduce/serial", batch=s // batch_size):
            for i in range(B):
                r = rs[i]
                while True:
                    if r.size == 0:
                        empty[i] = True
                        break
                    low = int(r[0])
                    addend = store.lookup_addend(low, int(ids[i]))
                    if addend is not None:
                        owner = self_owner_of(store, adapter, low)
                        gens[i][owner] = gens[i].get(owner, 0) + 1
                        for g in store_gens(store, low):
                            gens[i][int(g)] = gens[i].get(int(g), 0) + 1
                        r = merge_cancel(r, addend)
                        n_reductions += 1
                        continue
                    j = marked_low_to_j.get(low)
                    if j is None:
                        marked[i] = True
                        marked_low_to_j[low] = i
                        break
                    jid = int(ids[j])
                    gens[i][jid] = gens[i].get(jid, 0) + 1
                    for g, p in gens[j].items():
                        gens[i][g] = gens[i].get(g, 0) + p
                    r = merge_cancel(r, rs[j])
                    n_reductions += 1
                rs[i] = r

        # ---- clearance: commit the whole batch (batched value lookups) ----
        with span("reduce/commit", batch=s // batch_size):
            lows = np.array([int(rs[i][0]) if rs[i].size else -1
                             for i in range(B)], dtype=np.int64)
            clearance_commit(store, adapter, ids, lows, gens,
                             lambda rows: [rs[int(i)] for i in rows],
                             pairs, essentials, essential_ids=essential_ids,
                             essential_log=essential_log)

    return finalize_result(
        pairs, essentials, essential_ids,
        _final_stats(store, queue, pairs, essentials, n_reductions,
                     batch_size))


def _final_stats(store: PivotStore, queue, pairs, essentials,
                 n_reductions: int, batch_size: int) -> Dict[str, float]:
    """Engine stats through the typed registry (schema:
    repro_torch.obs.metrics)."""
    reg = MetricsRegistry()
    reg.counter("n_columns").inc(len(queue))
    reg.counter("n_reductions").inc(n_reductions)
    reg.counter("n_pairs").inc(len(pairs))
    reg.counter("n_essential").inc(len(essentials))
    reg.gauge("stored_bytes").set(store.bytes_stored)
    reg.gauge("n_stored_columns").set(len(store.columns))
    reg.counter("n_spilled").inc(store.n_spilled)
    reg.gauge("batch_size").set(batch_size)
    return reg.as_stats()
