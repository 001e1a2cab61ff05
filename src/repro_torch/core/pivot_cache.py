"""Shared packed pivot cache: memoization for the packed reduction.

Port of ``src/repro/core/pivot_cache.py``, the :class:`PackedPivotCache`
half.  The commit-delta wire codec (``encode_commit_delta`` and friends)
serves only the distributed reduction and stays in the reference until
that driver is ported.

The packed engine (:mod:`repro_torch.core.packed_reduce`) re-derives the
same per-pivot work once per *consuming batch*: every batch that probes a
committed pivot re-searches its keys into the batch's packed universe, and
in implicit mode re-materializes the pivot's R column from its V
generators.  This cache is the single shared home for both memoizations:

* **position memo** — packed bit positions of a pivot's keys inside the
  *current* block universe, keyed by pivot low and invalidated whenever the
  block's segment layout changes (``consolidate`` / ``add_segment`` bump an
  epoch).
* **materialization memo** — the pivot's canonical sorted R keys, keyed by
  low, budget-bounded with FIFO eviction.  R columns are canonical (the
  reduced column at a given low is unique over GF(2)), so caching them can
  never perturb bit-identity.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..obs.metrics import MetricsRegistry

__all__ = ["PackedPivotCache"]


class PackedPivotCache:
    """Per-reduction shared cache (one instance per ``reduce_dimension_packed``
    call, or one shared across dimensions when the caller threads it)."""

    def __init__(self, budget_bytes: Optional[int] = None):
        # materialization memo: low -> canonical sorted int64 R keys
        self._columns: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._col_bytes = 0
        self.budget_bytes = budget_bytes
        # position memo: low -> int64 absolute bit positions in the live
        # block universe; valid only for the current epoch
        self._positions: Dict[int, np.ndarray] = {}
        self._epoch = 0
        # counters (surfaced by reduce_bench.py)
        self.n_packs = 0          # position computations performed
        self.n_pack_hits = 0      # position lookups served from the memo
        self.n_materializations = 0   # R columns enumerated from gens
        self.n_mat_hits = 0           # R columns served from the memo
        self.n_col_evictions = 0

    # -- position memo ------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    def bump_epoch(self) -> int:
        """Invalidate all packed positions (block segment layout changed)."""
        self._epoch += 1
        self._positions.clear()
        return self._epoch

    def get_positions(self, low: int) -> Optional[np.ndarray]:
        pos = self._positions.get(low)
        if pos is not None:
            self.n_pack_hits += 1
        return pos

    def put_positions(self, low: int, pos: np.ndarray) -> None:
        """Record fully-resolved positions (caller guarantees no key was
        missing from the universe — partial resolutions must not be cached
        because a later ``add_segment`` could make stale misses ambiguous)."""
        self.n_packs += 1
        self._positions[low] = pos

    # -- materialization memo -----------------------------------------------

    def get_column(self, low: int) -> Optional[np.ndarray]:
        keys = self._columns.get(low)
        if keys is not None:
            self.n_mat_hits += 1
        return keys

    def put_column(self, low: int, keys: np.ndarray) -> None:
        self.n_materializations += 1
        if low in self._columns:
            return
        keys = np.ascontiguousarray(keys, dtype=np.int64)
        self._columns[low] = keys
        self._col_bytes += keys.nbytes
        if self.budget_bytes is not None:
            while self._col_bytes > self.budget_bytes and len(self._columns) > 1:
                _, old = self._columns.popitem(last=False)
                self._col_bytes -= old.nbytes
                self.n_col_evictions += 1

    def drop_column(self, low: int) -> None:
        old = self._columns.pop(low, None)
        if old is not None:
            self._col_bytes -= old.nbytes

    # -- introspection -------------------------------------------------------

    @property
    def column_bytes(self) -> int:
        return self._col_bytes

    def stats(self) -> Dict[str, float]:
        """Cache counters through the typed registry (obs.metrics), so the
        emitted keys stay schema-checked."""
        reg = MetricsRegistry()
        reg.counter("cache_n_packs").inc(self.n_packs)
        reg.counter("cache_n_pack_hits").inc(self.n_pack_hits)
        reg.counter("cache_n_materializations").inc(self.n_materializations)
        reg.counter("cache_n_mat_hits").inc(self.n_mat_hits)
        reg.counter("cache_n_col_evictions").inc(self.n_col_evictions)
        reg.gauge("cache_column_bytes").set(self._col_bytes)
        return reg.as_stats()
