"""Shared packed pivot cache: memoization + replication unit for reduction.

Port of ``src/repro/core/pivot_cache.py``: the :class:`PackedPivotCache`
and the commit-delta wire codec, whose payloads are word for word the
reference's (either package decodes the other's).  Under the GF(2)
sanitizer (:mod:`repro_torch.analyze.invariants`) ``put_column`` checks
that a memoized column is canonical and ``encode_commit_delta`` checks
the wire round trip, as in the reference.

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
* **replication codec** — ``encode_commit_delta``/``decode_commit_delta``
  turn a superstep's freshly committed pivots into one flat uint32 wire
  payload (Elias–Fano compressed, :mod:`repro_torch.dist.compression`) and
  back.  The distributed reduction's *concurrent* phase reads pivots only
  through a replica installed from decoded payloads, so the codec is
  load-bearing for the bit-identity tests — a corrupt wire format changes
  diagrams, it does not hide.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..analyze.invariants import active_sanitizer
from ..dist.compression import pack_column_payload, unpack_column_payload
from ..obs.metrics import MetricsRegistry
from ..resilience.faults import WireCorruption

__all__ = ["PackedPivotCache", "encode_commit_delta", "decode_commit_delta",
           "verify_commit_delta"]

_MODE_CODE = {"explicit": 0, "implicit": 1}
_CODE_MODE = {0: "explicit", 1: "implicit"}
_DELTA_MAGIC = np.uint32(0xD0F2)


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
        san = active_sanitizer()
        if san is not None:
            # memoized R columns must be canonical (strictly increasing):
            # the cache serves every later consumer of this low verbatim
            san.check_canonical_column(keys)
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


# ---------------------------------------------------------------------------
# Replication codec: superstep commit records <-> one uint32 wire payload
# ---------------------------------------------------------------------------

def encode_commit_delta(records: Sequence[dict]) -> np.ndarray:
    """Encode committed-pivot records for the pivot-exchange round.

    Each record: ``{"low": int, "col_id": int, "mode": "explicit"|"implicit",
    "column": int64 keys or None, "gens": int64 ids}``.  Explicit records
    ship their R column; implicit records ship their V generators.  Both
    are sorted for transport — key and generator *sets* are what every
    consumer reads, order is representational only.  The reference sorts
    only the generators and refuses an unsorted R column (``ValueError``
    from the Elias–Fano encoder); the packed host engine commits one
    whenever a batch holds more than one segment (``_PackedBatch.unpack``
    returns keys segment-major), so there the reference's distributed
    reduction stops and the port's goes on.  For sorted columns the payload
    is word for word the reference's.  The R columns and generator
    lists ride one fused :func:`~repro_torch.dist.compression.pack_column_payload`
    batch (columns first, gens second) so a delta costs a constant number
    of Elias–Fano passes however many pivots it carries.  Lossless by
    construction: the bit-identity suite round-trips diagrams through this
    wire format.
    """
    n = len(records)
    lows = np.array([r["low"] for r in records], dtype=np.int64)
    ids = np.array([r["col_id"] for r in records], dtype=np.int64)
    modes = np.array([_MODE_CODE[r["mode"]] for r in records],
                     dtype=np.uint32)
    empty = np.zeros(0, dtype=np.int64)
    cols, gens = [], []
    for r in records:
        c = r.get("column")
        cols.append(empty if c is None
                    else np.sort(np.ascontiguousarray(c, dtype=np.int64)))
        g = r.get("gens")
        gens.append(empty if g is None
                    else np.sort(np.ascontiguousarray(g, dtype=np.int64)))
    body = pack_column_payload(cols + gens)
    tail = np.concatenate([
        lows.view(np.uint32) if n else np.zeros(0, dtype=np.uint32),
        ids.view(np.uint32) if n else np.zeros(0, dtype=np.uint32),
        modes,
        body,
    ])
    # header slot 3: CRC32 over the other header words AND the tail — the
    # length fields must be covered too, or a flipped bit in `n` passes
    # the check and mis-slices the decode
    head = np.array([_DELTA_MAGIC, n, body.size], dtype=np.uint32)
    crc = np.uint32(zlib.crc32(head.tobytes() + tail.tobytes())
                    & 0xFFFFFFFF)
    header = np.array([_DELTA_MAGIC, n, body.size, crc], dtype=np.uint32)
    payload = np.concatenate([header, tail])
    san = active_sanitizer()
    if san is not None:
        # the replica installs exactly what decodes: check the round-trip
        # before the payload crosses the wire
        san.check_wire_roundtrip(records, payload, decode_commit_delta)
    return payload


def verify_commit_delta(payload: np.ndarray) -> bool:
    """Cheap receiver-side integrity check: header magic + CRC32 of the
    payload tail against header slot 3.  ``True`` iff the payload would
    decode to the records that produced it."""
    w = np.ascontiguousarray(payload, dtype=np.uint32)
    if w.size < 4 or w[0] != _DELTA_MAGIC:
        return False
    crc = np.uint32(zlib.crc32(w[:3].tobytes() + w[4:].tobytes())
                    & 0xFFFFFFFF)
    return bool(crc == w[3])


def decode_commit_delta(payload: np.ndarray) -> List[dict]:
    """Inverse of :func:`encode_commit_delta`.

    Raises :class:`~repro_torch.resilience.faults.WireCorruption` (a
    ``ValueError``) on a bad magic word or checksum mismatch — a corrupt
    exchange payload is *rejected for retransmission*, never installed
    into a replica store."""
    w = np.ascontiguousarray(payload, dtype=np.uint32)
    if w.size < 4 or w[0] != _DELTA_MAGIC:
        raise WireCorruption("not a commit-delta payload")
    if not verify_commit_delta(w):
        raise WireCorruption("commit-delta checksum mismatch")
    n = int(w[1])
    body_len = int(w[2])
    off = 4
    lows = w[off:off + 2 * n].view(np.int64); off += 2 * n
    ids = w[off:off + 2 * n].view(np.int64); off += 2 * n
    modes = w[off:off + n]; off += n
    both = unpack_column_payload(w[off:off + body_len])
    cols, gens = both[:n], both[n:]
    out = []
    for i in range(n):
        mode = _CODE_MODE[int(modes[i])]
        out.append({
            "low": int(lows[i]), "col_id": int(ids[i]), "mode": mode,
            "column": cols[i] if mode == "explicit" else None,
            "gens": gens[i],
        })
    return out
