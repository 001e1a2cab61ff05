"""Bit-packed serial-parallel reduction engine (Dory §4.4 × kernels/gf2).

Port of ``src/repro/core/packed_reduce.py``: ``_PackedBatch`` and the
fused-superstep loop of ``reduce_dimension_packed`` (P = 1 is its
one-slice case), kernel path included.  The host-side combinatorics stay
numpy, exactly as in the reference; on the kernel path the GF(2) kernels of
:mod:`repro_torch.kernels.gf2` run on ``device`` — hand-written CUDA on a
card, their plain PyTorch versions on the CPU.  A parallel-phase round
makes one round trip: the hit rows go to the device, ``gf2_scatter_xor``
adds the addends' coordinates into them and ``gf2_find_low`` reads each
segment's window of the result, and rows and lows come back in one copy.
The serial pre-pass keeps the reference's round trip per call.  With a
mesh (:mod:`repro_torch.launch.mesh`) the pivot exchange gathers the
stacked payloads over the mesh's data axis (``_make_exchange``).  The
warm-restart hooks, the GF(2) sanitizer's checks
(:mod:`repro_torch.analyze.invariants`), the shard supervisor
(:class:`~repro_torch.launch.elastic.ShardSupervisor`) and the
``reduce.superstep`` and ``exchange.wire`` fault sites
(:mod:`repro_torch.resilience.faults`) are the reference's.

The engine keeps the paper's batch structure — parallel phase against the
committed pivots, serial phase for intra-batch collisions, clearance
commit — but holds each batch in *one* bit-packed block for its whole
reduction:

* **rank compression** — per batch, the sorted unique key set of the
  batch's coboundaries plus the first round of gathered addends becomes the
  block's bit-space (``scatter_bits``): key ``universe[i]`` lives at bit
  ``i``, so ascending keys are ascending ranks and a first-set-bit scan
  (``gf2_find_low`` / ``find_low_np``) *is* the engine's ``low``;
* **parallel phase** — one :meth:`PivotStore.lookup_addends_batched` probe
  per round, then the hit rows absorb their gathered committed-pivot
  addends: an in-place bit scatter-XOR on host, ``gf2_scatter_xor`` on the
  device copy of the hit rows on the kernel path.  Only rows whose low
  moved are probed again;
* **segmented growth vs eviction** — an addend with keys outside the
  bit-space either *expands* the space (a fresh word-aligned segment) or
  *evicts* its row to plain sorted-key form (``merge_cancel`` chains).
  Segments consolidate to one sorted universe past ``_MAX_SEGMENTS`` — or
  eagerly on the kernel path, where the kernels need the single
  globally-sorted bit-space;
* **serial phase** — intra-batch low collisions resolve in one host walk
  over the batch in filtration order.  On the kernel path a
  ``gf2_serial_reduce`` pre-pass first clears the packed-vs-packed
  collisions on the device: ``ceil(B/32)`` *V-words* ride at the block's
  tail, reset to the identity before the pass, so afterwards each row's V
  bits name exactly the batch mates it absorbed;
* **clearance** — lows unpack back to int64 keys and commit through the
  :class:`PivotStore` (budgeted, largest-explicit-first spill).

Diagrams are bit-identical to ``reduce_dimension`` for every mode/budget:
all engines perform left-to-right GF(2) column additions, and the lows of
any fully reduced matrix are canonical.

**Distributed mode** (``n_shards``/``mesh``): column batches partition
round-robin over the shards (batch ``t`` -> shard ``t % P``), and each
*superstep* fuses the P shards' next batches into ONE resident block of
``P·B`` rows — per-device blocks simulated as row slices, which also
amortizes the per-batch fixed costs (one coboundary enumeration, one block
build, one store probe per round for all P slices).  On a card the fused
block goes through the same GF(2) kernels, at up to ``P·B`` hit rows a
round.  Phases per superstep:

* **concurrent phase** — the parallel phase of every slice runs against a
  *replica* of the pivot store, complete exactly up to the last exchange
  round (pivots arrive only through the exchange wire), with per-slice
  serial passes for intra-slice collisions;
* **tournament catch-up** — cross-slice collisions resolve in ``log2 P``
  hypercube rounds (partner ``j XOR step``): the later-ranked slice's row
  absorbs the earlier one's current (R, gens) snapshot — later batch
  columns follow earlier ones in processing order, so this matches the
  left-to-right schedule and only removes work;
* **commit sweep** — slices commit strictly in global batch order; each
  slice first re-probes the *authoritative* store (which now holds this
  superstep's earlier-slice pivots) until stable, so the final schedule is
  exactly a left-to-right reduction and diagrams stay bit-identical to the
  single-device engines for every shard count;
* **pivot exchange** — every ``exchange_every`` supersteps each shard's
  commit backlog encodes into one Elias–Fano wire payload
  (:mod:`repro_torch.core.pivot_cache`), crosses a host loop-back, decodes
  and installs into the replica.  The concurrent phase reads pivots *only*
  from the replica, so the wire codec sits on the bit-identity critical
  path by construction.

**Recovery** (``docs/resilience.md``, as in the reference): every live
shard beats once a superstep on the superstep clock.  A shard killed at
the start of a superstep misses its beat and its batches re-deal to the
survivors; one killed mid-superstep discards the whole superstep, which
restarts from the last commit sweep with the survivors (nothing of it has
committed, so the restart is exact).  A dead shard's wire backlog passes
to an heir.  A slow shard is sidelined from dealing for a superstep.  A
dropped or corrupt payload retries with a deterministic backoff (counted,
not slept); one that exhausts its budget is deferred: an empty payload
ships in its slot and its backlog waits for the next round.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analyze.invariants import active_sanitizer
from ..device import DeviceLike, resolve_device
from ..kernels.gf2 import (NO_LOW, find_low_np, gf2_find_low,
                           gf2_scatter_xor, gf2_serial_reduce, scatter_bits,
                           scatter_xor_bits, set_bit_positions,
                           stack_wire_payloads, to_numpy, to_tensor,
                           unstack_wire_payloads)
from ..launch.elastic import ShardSupervisor
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer, active_tracer, critical_path
from ..resilience.faults import (TransientFault, active_injector,
                                 corrupt_payload, retry_with_backoff)
from .pairing import EMPTY_KEY
from .pivot_cache import (PackedPivotCache, decode_commit_delta,
                          encode_commit_delta, verify_commit_delta)
from .reduction import (DimensionAdapter, PivotStore, ReductionResult,
                        clearance_commit, clearing_filter, finalize_result,
                        merge_cancel, seed_column)

_MAX_SEGMENTS = 12   # host path consolidates past this many segments
_EVICT_MAX = 8       # per slice: rounds needing new keys for fewer rows
                     # evict instead


def _resolve_use_kernels(use_kernels: Optional[bool],
                         device: torch.device) -> bool:
    """The kernels on a card, the numpy block mirrors on the CPU; ``True``
    forces the kernel path (on the CPU it runs the plain versions — the
    test path for its control flow)."""
    if use_kernels is None:
        return device.type == "cuda"
    return bool(use_kernels)


def _words(n_keys: int, use_kernels: bool) -> int:
    """Segment width in words; bucketed to 128 on the kernel path so the
    kernels see a handful of shapes, not one per universe size."""
    w = max(1, (n_keys + 31) // 32)
    return -(-w // 128) * 128 if use_kernels else w


def _find_low_row(col: np.ndarray) -> int:
    """First-set-bit rank of one packed uint32 row; NO_LOW when zero."""
    nz = col != 0
    if not nz.any():
        return NO_LOW
    w = int(nz.argmax())
    word = int(col[w])
    return w * 32 + ((word & -word).bit_length() - 1)


def _budgeted_batch_size(batch_size: int, cob_width: int,
                         store_budget_bytes: Optional[int]) -> int:
    """Cap the batch so the resident bit block fits the byte budget.

    The batch block is ``B`` rows × ``~B·K/32`` words ≈ ``B²K/8`` bytes
    (plus the same again transiently for a kernel-path addend gather).
    Inverting for ``B`` bounds the packed-block scratch; it does not change
    the output.  Best-effort: the batch never shrinks below 32 rows.
    """
    if store_budget_bytes is None:
        return batch_size
    b = int(np.sqrt(max(1.0, 4.0 * store_budget_bytes / max(1, cob_width))))
    return int(np.clip(b, 32, batch_size))


class _PackedBatch:
    """One batch resident in packed form, with a scalar escape hatch.

    Layout: ``block[:, 0:cap]`` is the R region — a sequence of
    word-aligned segments, each a sorted key array mapped to consecutive
    bit ranks — and ``block[:, cap:cap+VW]`` are the V-words the kernel
    serial pre-pass uses for δ-expansion tracking (zero otherwise).
    ``scalar`` maps evicted rows to plain int64 key arrays; ``lows`` holds
    every row's current low *key* (-1 = empty), which survives segment
    growth, consolidation and eviction unchanged.  A round whose missing
    keys touch at most ``evict_max`` rows evicts them; the superstep loop
    passes ``_EVICT_MAX`` per slice, so a fused block chooses between
    eviction and growth as its slices' own blocks would.
    """

    def __init__(self, cob: np.ndarray, seed_addends: List[np.ndarray],
                 use_kernels: bool, device: torch.device, cache=None,
                 evict_max: int = _EVICT_MAX):
        B = cob.shape[0]
        self.evict_max = evict_max
        self.B = B
        self.VW = (B + 31) // 32
        self.use_kernels = use_kernels
        self.device = device
        self.cache = cache
        if cache is not None:
            cache.bump_epoch()   # fresh universe: prior positions are stale
        mask = cob != EMPTY_KEY
        seg0 = np.unique(np.concatenate([cob[mask]] + seed_addends))
        self.segs: List[np.ndarray] = [seg0]
        self.seg_off: List[int] = [0]          # word offset per segment
        self.r_words = _words(len(seg0), use_kernels)
        self.cap = self.r_words
        self.block = np.zeros((B, self.cap + self.VW), dtype=np.uint32)
        ridx, _ = np.nonzero(mask)
        pos = np.searchsorted(seg0, cob[mask])
        scatter_bits(self.block, ridx, pos)
        self.scalar: Dict[int, np.ndarray] = {}
        self.lows = np.where(cob[:, 0] == EMPTY_KEY, np.int64(-1), cob[:, 0])
        self.peak_bytes = self.block.nbytes
        self.n_consolidations = 0
        self.n_expansions = 0
        self.n_evictions = 0

    # -- universe bookkeeping ------------------------------------------------

    def _grow_cap(self, need: int) -> None:
        new_cap = max(need, 2 * self.cap)
        block = np.zeros((self.B, new_cap + self.VW), dtype=np.uint32)
        block[:, :self.r_words] = self.block[:, :self.r_words]
        # V region is zero outside the kernel pre-pass — nothing to move
        self.block = block
        self.cap = new_cap
        self.peak_bytes = max(self.peak_bytes, block.nbytes)

    def add_segment(self, new_keys: np.ndarray) -> None:
        """Append new addend keys as a fresh word-aligned segment — no
        re-ranking of resident bits (rank order only holds per segment;
        lows are reconstructed as a min over segments)."""
        w = _words(len(new_keys), self.use_kernels)
        if self.r_words + w > self.cap:
            self._grow_cap(self.r_words + w)
        self.segs.append(new_keys)
        self.seg_off.append(self.r_words)
        self.r_words += w
        if self.use_kernels or len(self.segs) > _MAX_SEGMENTS:
            self.consolidate()

    def consolidate(self) -> None:
        """Merge all segments into one sorted universe (one global remap).
        The kernel path runs consolidated always: ``gf2_find_low`` /
        ``gf2_serial_reduce`` read the first set *bit*, which equals the
        min *key* only in a single globally-sorted bit-space."""
        if len(self.segs) == 1:
            return
        self.n_consolidations += 1
        san = active_sanitizer()
        if self.cache is not None:
            self.cache.bump_epoch()   # re-ranking invalidates cached positions
        ridx_all, keys_all = [], []
        for seg, off in zip(self.segs, self.seg_off):
            w = _words(len(seg), self.use_kernels)
            ridx, pos, _ = set_bit_positions(self.block[:, off:off + w])
            keep = pos < len(seg)
            if san is not None:
                # the keep filter below silently drops any bit past the
                # segment universe — under the sanitizer that is a lost
                # GF(2) coordinate, not slack
                san.check_segment_bits(pos, len(seg))
            ridx_all.append(ridx[keep])
            keys_all.append(seg[pos[keep]])
        ridx = np.concatenate(ridx_all)
        keys = np.concatenate(keys_all)
        universe = np.unique(np.concatenate(self.segs))
        self.segs = [universe]
        self.seg_off = [0]
        self.r_words = _words(len(universe), self.use_kernels)
        if self.r_words > self.cap:
            self.cap = self.r_words
        self.block = np.zeros((self.B, self.cap + self.VW), dtype=np.uint32)
        self.peak_bytes = max(self.peak_bytes, self.block.nbytes)
        pos = np.searchsorted(universe, keys)
        order = np.lexsort((pos, ridx))
        scatter_bits(self.block, ridx[order], pos[order])
        if san is not None:
            san.check_consolidation(ridx, keys, universe,
                                    self.block[:, :self.r_words])

    def _abs_positions(self, keys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Absolute bit position of each key (32·segment word offset +
        in-segment rank) plus the mask of keys in no segment yet."""
        out = np.full(len(keys), -1, dtype=np.int64)
        todo = np.ones(len(keys), dtype=bool)
        for seg, off in zip(self.segs, self.seg_off):
            if not len(seg) or not todo.any():
                continue
            pos = np.minimum(np.searchsorted(seg, keys), len(seg) - 1)
            hit = todo & (seg[pos] == keys)
            out[hit] = off * 32 + pos[hit]
            todo &= ~hit
        return out, todo

    # -- representation moves ------------------------------------------------

    def _unpack_row(self, c: int) -> np.ndarray:
        parts = []
        for seg, off in zip(self.segs, self.seg_off):
            if not len(seg):
                continue
            w = _words(len(seg), self.use_kernels)
            _, pos, _ = set_bit_positions(self.block[c:c + 1, off:off + w])
            pos = pos[pos < len(seg)]
            if pos.size:
                parts.append(seg[pos])
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)

    def evict(self, c: int) -> None:
        """Move row ``c`` to scalar (sorted-key) form: one stubborn chain
        must not balloon the shared bit-space."""
        if c in self.scalar:
            return
        self.n_evictions += 1
        keys = self._unpack_row(c)
        keys.sort(kind="stable")
        self.block[c, :self.r_words] = 0
        self.scalar[c] = keys

    # -- lows ----------------------------------------------------------------

    def _live_segments(self) -> List[Tuple[np.ndarray, int, int]]:
        """``(keys, word offset, width in words)`` of each non-empty
        segment."""
        return [(seg, off, _words(len(seg), self.use_kernels))
                for seg, off in zip(self.segs, self.seg_off) if len(seg)]

    def _set_lows(self, rows: np.ndarray, bit_lows: List[np.ndarray]
                  ) -> None:
        """``lows[rows]`` from each live segment's first-set-bit ranks
        (``NO_LOW`` where a row has none there): the min key over
        segments."""
        best = np.full(len(rows), EMPTY_KEY, dtype=np.int64)
        for (seg, _, _), lb in zip(self._live_segments(), bit_lows):
            k = np.where(lb == NO_LOW, EMPTY_KEY,
                         seg[np.minimum(lb, len(seg) - 1)])
            best = np.minimum(best, k)
        self.lows[rows] = np.where(best == EMPTY_KEY, -1, best)

    def refresh_lows(self, rows: np.ndarray) -> None:
        """Recompute ``lows[rows]`` (packed rows) as the min key over
        per-segment find-lows (``gf2_find_low`` on the kernel path)."""
        rows = np.asarray(rows, dtype=np.int64)
        if not rows.size:
            return
        bit_lows = []
        for _, off, w in self._live_segments():
            sub = self.block[rows, off:off + w]
            if self.use_kernels:
                # rows padded to a multiple of 32, as the reference buckets
                # them; the lows gate the host serial pass, so they come
                # straight back (one round trip per segment)
                pad = (-len(rows)) % 32
                if pad:
                    sub = np.vstack(
                        [sub, np.zeros((pad, w), dtype=np.uint32)])
                lb = gf2_find_low(to_tensor(sub, self.device)).cpu().numpy()
                lb = lb[:len(rows)]
            else:
                lb = find_low_np(sub)
            bit_lows.append(lb)
        self._set_lows(rows, bit_lows)

    def _row_low(self, c: int) -> int:
        best = -1
        for seg, off in zip(self.segs, self.seg_off):
            if not len(seg):
                continue
            w = _words(len(seg), self.use_kernels)
            lb = _find_low_row(self.block[c, off:off + w])
            if lb != NO_LOW and lb < len(seg):
                k = int(seg[lb])
                if best < 0 or k < best:
                    best = k
        return best

    # -- parallel phase ------------------------------------------------------

    def xor_rows_kernels(self, packed_hit: List[int], ridx: np.ndarray,
                         pos: np.ndarray) -> None:
        """The kernel path's parallel-phase round: XOR the addend bits at
        ``(ridx, pos)`` (block row, absolute bit position) into the packed
        rows ``packed_hit`` and refresh their lows, in one round trip.

        One host buffer (pinned on a card) holds the hit rows and a slot
        for each segment's lows; it crosses to the device in one copy.
        There ``gf2_scatter_xor`` flips the addends' bits in the rows in
        place (it range-checks and stages their flat indices itself) and
        ``gf2_find_low`` reads each segment's window of them; rows and lows
        come back in one synchronising copy.  The reference builds a dense
        addend block on the host instead; the bits that land are the
        same."""
        hit = np.asarray(packed_hit, dtype=np.int64)
        n, cap = len(hit), self.cap
        lut = np.full(self.B, -1, dtype=np.int64)
        lut[hit] = np.arange(n, dtype=np.int64)
        local = lut[ridx]
        if (local < 0).any():
            raise KeyError(f"addend rows {np.unique(ridx[local < 0])} are "
                           "not among the round's hit rows")
        flat = local * (cap * 32) + pos
        # the device copy of the hit rows is the size of the reference's
        # dense addend block, which it stands for in the peak account
        self.peak_bytes = max(self.peak_bytes,
                              self.block.nbytes + n * cap * 4)
        segs = self._live_segments()
        n_back = n * cap + len(segs) * n        # rows, then lows
        on_card = self.device.type == "cuda"
        host = torch.empty(n_back, dtype=torch.int32, pin_memory=on_card)
        words = host.numpy().view(np.uint32)
        np.take(self.block[:, :cap], hit, axis=0, mode="clip",
                out=words[:n * cap].reshape(n, cap))
        buf = host.to(self.device, non_blocking=True) if on_card else host
        rows = buf[:n * cap].view(n, cap)
        gf2_scatter_xor(rows, torch.from_numpy(flat))
        for s, (_, off, w) in enumerate(segs):
            gf2_find_low(rows[:, off:off + w],
                         out=buf[n * cap + s * n:n * cap + (s + 1) * n])
        if on_card:
            host.copy_(buf)
        self.block[hit, :cap] = words[:n * cap].reshape(n, cap)
        lows = host.numpy()[n * cap:].reshape(len(segs), n)
        self._set_lows(hit, list(lows))

    def xor_addends(self, hit: List[int],
                    addends: List[Optional[np.ndarray]],
                    addend_lows: Optional[np.ndarray] = None) -> None:
        """Parallel-phase GF(2) add: gathered addends into the hit rows —
        an in-place scatter-XOR on host, :meth:`xor_rows_kernels` on the
        kernel path; scalar rows ``merge_cancel``.

        Addend keys outside every segment either append as a fresh segment
        (dense rounds) or evict their rows (sparse rounds: at most
        ``evict_max`` rows miss, ``_EVICT_MAX`` per slice of a fused block).

        ``addend_lows[i]`` names the pivot low row ``i``'s addend came from;
        a pivot's key array is canonical per low, so its packed positions
        memoize in the shared cache per block epoch — repeat consumers skip
        the per-segment ``searchsorted`` re-pack entirely.
        """
        scalar_hit = [i for i in hit if i in self.scalar]
        packed_hit = [i for i in hit if i not in self.scalar]
        memo_rows: List[int] = []
        memo_pos: List[np.ndarray] = []
        if packed_hit and self.cache is not None and addend_lows is not None:
            rest = []
            for i in packed_hit:
                p = self.cache.get_positions(int(addend_lows[i]))
                if p is not None and len(p) == len(addends[i]):
                    memo_rows.append(i)
                    memo_pos.append(p)
                else:
                    rest.append(i)
            packed_hit = rest
        if packed_hit:
            epoch0 = self.n_consolidations
            lens = np.array([len(addends[i]) for i in packed_hit],
                            dtype=np.int64)
            keys = np.concatenate([addends[i] for i in packed_hit])
            ridx = np.repeat(np.asarray(packed_hit, dtype=np.int64), lens)
            pos, missing = self._abs_positions(keys)
            if missing.any():
                miss_rows = np.unique(ridx[missing])
                if len(miss_rows) <= self.evict_max:
                    for i in miss_rows:
                        self.evict(int(i))
                        scalar_hit.append(int(i))
                    keep = ~np.isin(ridx, miss_rows)
                    ridx, pos, keys = ridx[keep], pos[keep], keys[keep]
                    mask = ~np.isin(np.asarray(packed_hit), miss_rows)
                    packed_hit = [i for i in packed_hit
                                  if i not in self.scalar]
                    lens = lens[mask]
                else:
                    self.n_expansions += 1
                    new_seg = np.unique(keys[missing])
                    n_segs = len(self.segs) + 1
                    self.add_segment(new_seg)
                    if len(self.segs) == n_segs:
                        # append-only: found positions are still valid
                        off = self.seg_off[-1]
                        pos[missing] = off * 32 + np.searchsorted(
                            new_seg, keys[missing])
                    else:   # consolidation re-ranked everything
                        pos, miss2 = self._abs_positions(keys)
                        assert not miss2.any()
            if self.cache is not None and addend_lows is not None \
                    and packed_hit:
                starts = np.zeros(len(packed_hit) + 1, dtype=np.int64)
                np.cumsum(lens, out=starts[1:])
                for k, i in enumerate(packed_hit):
                    self.cache.put_positions(int(addend_lows[i]),
                                             pos[starts[k]:starts[k + 1]])
            if memo_rows and self.n_consolidations != epoch0:
                # a consolidation re-ranked the universe under the memoized
                # rows: recompute them (their keys were resident, so they
                # cannot miss) and re-memoize against the new epoch
                mkeys = np.concatenate([addends[i] for i in memo_rows])
                mpos, mmiss = self._abs_positions(mkeys)
                assert not mmiss.any()
                mlens = np.array([len(addends[i]) for i in memo_rows],
                                 dtype=np.int64)
                starts = np.zeros(len(memo_rows) + 1, dtype=np.int64)
                np.cumsum(mlens, out=starts[1:])
                memo_pos = [mpos[starts[k]:starts[k + 1]]
                            for k in range(len(memo_rows))]
                for k, i in enumerate(memo_rows):
                    self.cache.put_positions(int(addend_lows[i]),
                                             memo_pos[k])
        if memo_rows:
            mlens = np.array([len(p) for p in memo_pos], dtype=np.int64)
            mridx = np.repeat(np.asarray(memo_rows, dtype=np.int64), mlens)
            mpos = (np.concatenate(memo_pos) if memo_pos
                    else np.zeros(0, dtype=np.int64))
            if packed_hit:
                ridx = np.concatenate([ridx, mridx])
                pos = np.concatenate([pos, mpos])
                packed_hit = packed_hit + memo_rows
            else:
                ridx, pos = mridx, mpos
                packed_hit = list(memo_rows)
        if packed_hit:
            if self.use_kernels:
                self.xor_rows_kernels(packed_hit, ridx, pos)
            else:
                order = np.lexsort((pos, ridx))
                scatter_xor_bits(self.block, ridx[order], pos[order])
                self.refresh_lows(np.asarray(packed_hit, dtype=np.int64))
        for i in scalar_hit:
            merged = merge_cancel(self.scalar[i], addends[i])
            self.scalar[i] = merged
            self.lows[i] = int(merged[0]) if merged.size else -1

    # -- serial phase --------------------------------------------------------

    def _absorb(self, c: int, j: int, gens: List[Dict[int, int]],
                ids_int: List[int]) -> int:
        """Row ``c <- c ⊕ j`` over GF(2) with gens bookkeeping; returns
        ``c``'s new low key (does not write ``lows``).  ``c`` must come
        after ``j`` in processing order.  Packed rows XOR whole block rows;
        scalar rows ``merge_cancel``; a packed row absorbing a scalar mate
        evicts first."""
        c_packed = c not in self.scalar
        j_packed = j not in self.scalar
        if c_packed and not j_packed:
            self.evict(c)
            c_packed = False
        if c_packed:
            self.block[c] ^= self.block[j]
            low = self._row_low(c)
        else:
            jkeys = self.scalar[j] if not j_packed \
                else self._unpack_row(j)
            merged = merge_cancel(self.scalar[c], jkeys)
            self.scalar[c] = merged
            low = int(merged[0]) if merged.size else -1
        gens[c][ids_int[j]] = gens[c].get(ids_int[j], 0) + 1
        for g, p in gens[j].items():
            gens[c][g] = gens[c].get(g, 0) + p
        return low

    def serial_pass(self, gens: List[Dict[int, int]],
                    ids_int: List[int],
                    rows: Optional[np.ndarray] = None
                    ) -> Tuple[int, np.ndarray]:
        """Resolve intra-batch low collisions in filtration order.

        Kernel path: a ``gf2_serial_reduce`` V-augmented pre-pass clears
        packed-vs-packed collisions on the device (V bits -> gens merge),
        then the host walk finishes scalar-involved collisions.  Host path:
        the walk does everything via :meth:`_absorb`.  ``rows`` restricts
        the walk to one contiguous slice (the fused-superstep loop
        resolves per-shard slices independently; the kernel pre-pass
        assumes the whole block and only runs unrestricted).  Returns
        ``(n_reductions, changed_row_indices)``.
        """
        n_red = 0
        changed: Dict[int, bool] = {}
        if rows is None:
            if self.use_kernels:
                n_red += self._serial_kernel_prepass(gens, ids_int, changed)
            row_iter = range(self.B)
        else:
            row_iter = [int(r) for r in rows]
        low_to_row: Dict[int, int] = {}
        for c in row_iter:
            low = int(self.lows[c])
            while low >= 0:
                j = low_to_row.get(low)
                if j is None:
                    break
                n_red += 1
                changed[c] = True
                low = self._absorb(c, j, gens, ids_int)
            self.lows[c] = low
            if low >= 0:
                low_to_row[low] = c
        return n_red, np.array(sorted(changed), dtype=np.int64)

    def _serial_kernel_prepass(self, gens: List[Dict[int, int]],
                               ids_int: List[int],
                               changed: Dict[int, bool]) -> int:
        """Kernel pre-pass on the packed rows: V-identity words ride the
        block tail, ``gf2_serial_reduce`` XORs colliding rows on the device, and
        the V bits name each row's absorbed mates afterwards (scalar rows'
        block rows are zero, hence inert; zero slack words between the R
        segment and the V-words are skipped by the kernel's find-low; and
        V-rank collisions only ever involve R-empty rows)."""
        assert len(self.segs) == 1
        B, cap = self.B, self.cap
        vbit = np.arange(B)
        vslice = self.block[:, cap:]
        vslice[...] = 0
        # scalar rows get no identity bit: inert rows must not register lows
        live = np.array([i not in self.scalar for i in range(B)])
        lv = vbit[live]
        vslice[lv, lv >> 5] |= np.uint32(1) << (lv & 31).astype(np.uint32)
        C, W = B, cap + self.VW
        Cp, Wp = -(-C // 32) * 32, -(-W // 128) * 128
        padded = np.zeros((Cp, Wp), dtype=np.uint32)
        padded[:C, :W] = self.block
        red, _, reds = gf2_serial_reduce(to_tensor(padded[None], self.device))
        n_red = int(reds.cpu()[0])
        if n_red == 0:              # the block came back unchanged
            vslice[...] = 0
            return 0
        self.block[...] = to_numpy(red)[0, :C, :W]
        vrid, vpos, _ = set_bit_positions(vslice)
        vkeep = vpos < B
        counts = np.bincount(vrid[vkeep], minlength=B).astype(np.int64)
        vrows = np.split(vpos[vkeep], np.cumsum(counts)[:-1])
        touched = [i for i in range(B) if vrows[i].size > 1]
        entry = {int(i): dict(gens[i]) for i in touched}
        for i in touched:
            changed[int(i)] = True
            newg = dict(entry[int(i)])
            for j in vrows[i]:
                j = int(j)
                if j == i:
                    continue
                newg[ids_int[j]] = newg.get(ids_int[j], 0) + 1
                # unchanged mates keep their live gens; changed mates use
                # their pass-entry snapshot (the kernel walk is ascending)
                for g, p in entry.get(j, gens[j]).items():
                    newg[g] = newg.get(g, 0) + p
            gens[i] = newg
        vslice[...] = 0
        if touched:
            self.refresh_lows(np.array(touched, dtype=np.int64))
        return n_red

    # -- clearance -----------------------------------------------------------

    def unpack(self, rows: np.ndarray) -> List[np.ndarray]:
        """``rows`` as int64 key arrays, one block pass per segment.

        Row keys come out ascending *within* each segment's contribution
        (segment-major order overall, not globally sorted) — every consumer
        either re-ranks per key (the pack/scatter paths) or re-sorts
        (``merge_cancel``, ``parity_reduce``), so a global per-row sort
        would buy nothing.  Clearance also only unpacks the rows it will
        store: trivial pairs commit nothing."""
        rows = np.asarray(rows, dtype=np.int64)
        n = len(rows)
        if not n:
            return []
        out_scalar = {int(i): self.scalar[int(i)] for i in rows
                      if int(i) in self.scalar}
        packed_rows = np.array([i for i in rows if int(i) not in self.scalar],
                               dtype=np.int64)
        np_rows = len(packed_rows)
        parts = []
        counts = np.zeros(np_rows, dtype=np.int64)
        for seg, off in zip(self.segs, self.seg_off):
            if not len(seg) or not np_rows:
                continue
            w = _words(len(seg), self.use_kernels)
            ridx, pos, cnt = set_bit_positions(
                self.block[packed_rows, off:off + w])
            keep = pos < len(seg)
            if not keep.all():
                ridx, pos = ridx[keep], pos[keep]
                cnt = np.bincount(ridx, minlength=np_rows).astype(np.int64)
            parts.append((ridx, seg[pos], cnt))
            counts += cnt
        out = np.empty(int(counts.sum()), dtype=np.int64)
        row_start = np.zeros(np_rows + 1, dtype=np.int64)
        np.cumsum(counts, out=row_start[1:])
        fill = row_start[:-1].copy()
        for ridx, keys, cnt in parts:
            if not len(keys):
                continue
            part_off = np.cumsum(cnt) - cnt
            within = np.arange(len(keys), dtype=np.int64) - part_off[ridx]
            out[fill[ridx] + within] = keys
            fill += cnt
        packed_cols = np.split(out, row_start[1:-1]) if np_rows else []
        packed_iter = iter(packed_cols)
        return [out_scalar[int(i)] if int(i) in out_scalar
                else next(packed_iter) for i in rows]


def _tournament_merge(blk: _PackedBatch, gens: List[Dict[int, int]],
                      ids_int: List[int],
                      bounds: np.ndarray) -> Tuple[int, np.ndarray]:
    """Cross-slice catch-up in ``log2 P`` hypercube rounds.

    Pairing is the reference's ``(j, j XOR step)``
    (``core.jax_engine.make_distributed_round``); the later-ranked slice
    absorbs, because every column of a later batch follows every column of
    an earlier one in processing order — so each absorption is a legal
    left-to-right column addition and only removes work.  Collisions the
    hypercube pairing does not cover (and any it creates) are caught by the
    superstep's store-probe / per-slice serial-pass loop and the exact commit
    sweep."""
    n_red = 0
    changed: set = set()
    P = len(bounds) - 1
    step = 1
    while step < P:
        for j in range(P):
            p = j ^ step
            if p >= j or p >= P:
                continue   # absorber is the later-ranked slice of the pair
            plow: Dict[int, int] = {}
            for r in range(int(bounds[p]), int(bounds[p + 1])):
                lw = int(blk.lows[r])
                if lw >= 0:
                    plow[lw] = r
            for c in range(int(bounds[j]), int(bounds[j + 1])):
                lw = int(blk.lows[c])
                while lw >= 0 and lw in plow:
                    n_red += 1
                    changed.add(c)
                    lw = blk._absorb(c, plow[lw], gens, ids_int)
                blk.lows[c] = lw
        step <<= 1
    return n_red, np.array(sorted(changed), dtype=np.int64)


def _resolve_reduce_shards(mesh, n_shards: Optional[int]) -> int:
    """Shard count for the distributed driver: the mesh's data-axis size,
    or ``n_shards`` for the host-partitioned loop-back (same work split,
    no mesh needed — mirrors ``scale.shard.harvest_edges_sharded``)."""
    if mesh is not None:
        from ..scale.shard import shard_of_mesh
        axis, mesh_shards = shard_of_mesh(mesh)
        if n_shards is not None and int(n_shards) != mesh_shards:
            raise ValueError(
                f"n_shards={n_shards} disagrees with the mesh's "
                f"{axis}-axis size {mesh_shards}; pass only one of them")
        return mesh_shards
    return 1 if n_shards is None else int(n_shards)


def _make_exchange(mesh):
    """Pivot-exchange round: per-shard wire payloads -> all shards' payloads.

    With a mesh, payloads stack into a ``(P, L)`` uint32 buffer (``L``
    bucketed to a power of two, ``stack_wire_payloads``): row ``k`` goes to
    entry ``k`` of the mesh's data axis, and every entry gathers the whole
    buffer from the rows (the reference's ``all_gather`` under
    ``shard_map``).  The host reads the gathered buffer back once, as the
    reference's ``np.asarray`` of the replicated result does, so only the
    first entry's copy is made: the replicas on the other entries wait for
    a transport between cards (ROADMAP.md §1 item 5).  The buffer
    travels as an ``int32`` view of the same bits (``torch.uint32`` takes
    few operations).  Without a mesh the exchange is the host loop-back —
    identical payload path (encode -> exchange -> decode), no devices."""
    if mesh is None:
        return lambda payloads: payloads
    from ..dist.sharding import data_axis

    devices = mesh.axis_devices(data_axis(mesh, "reduce"))

    def exchange(payloads: List[np.ndarray]) -> List[np.ndarray]:
        buf, lens = stack_wire_payloads(payloads)
        rows = [torch.from_numpy(buf[k].view(np.int32)).to(dev)
                for k, dev in enumerate(devices)]
        gathered = torch.stack([row.to(devices[0]) for row in rows])
        return unstack_wire_payloads(
            gathered.cpu().numpy().view(np.uint32), lens)

    return exchange


def reduce_dimension_packed(
    adapter: DimensionAdapter,
    column_ids: np.ndarray,
    mode: str = "explicit",
    cleared=None,
    batch_size: int = 256,
    store_budget_bytes: Optional[int] = None,
    use_kernels: Optional[bool] = None,
    n_shards: Optional[int] = None,
    mesh=None,
    cache: Optional[PackedPivotCache] = None,
    exchange_every: int = 4,
    seed_gens: Optional[Dict[int, np.ndarray]] = None,
    commit_sink: Optional[list] = None,
    essential_log: Optional[list] = None,
    device: DeviceLike = None,
) -> ReductionResult:
    """Bit-packed serial-parallel cohomology reduction (module docstring).

    The reference's parameters in the reference's order, plus ``device``
    last.  Same contract as ``reduce_dimension``: ``column_ids`` in
    decreasing filtration order, diagrams bit-identical to it for every
    shard count.  ``device=None`` is the card (``RuntimeError`` without
    one); ``use_kernels=None`` resolves from the device — the CUDA kernels
    on ``cuda``, the numpy block mirrors on ``cpu`` — and ``True`` forces
    the kernel path, which on the CPU runs the kernels' plain versions.

    ``n_shards`` > 1 runs the fused-superstep distributed reduction on one
    device: batches deal round-robin over the shards, each superstep's P
    batches reduce in one fused block against a pivot replica fed by
    Elias–Fano-compressed exchange rounds, and commits happen in exact
    global batch order (module docstring).  ``exchange_every`` (>= 1)
    batches the exchange rounds — payloads ship every that-many
    supersteps; staleness is exact-safe because the commit sweep re-probes
    every pivot the replica has not seen yet (``pending`` below).
    ``cache`` threads a caller-owned :class:`PackedPivotCache` (one is
    created per call otherwise).

    A ``mesh`` (:class:`~repro_torch.launch.mesh.Mesh`) fixes P to its
    data-axis size (a disagreeing ``n_shards`` raises the reference's
    ``ValueError``) and carries each exchange round as a gather over that
    axis (``_make_exchange``); the kernels run on ``device``, which then
    defaults to the mesh's first entry and must be of the mesh's device
    type.  The split, the counters and the diagrams are those of the
    loop-back at the same P.

    ``seed_gens`` / ``commit_sink`` / ``essential_log`` carry the same
    warm-restart + capture contract as ``reduce_dimension``
    (:mod:`repro_torch.core.resume`): a seeded row starts from its
    recorded residual with its gens parity pre-loaded, on the numpy path
    and the kernel path alike (the residual's keys enter the block's first
    segment), and every commit reaches ``commit_sink`` at any P.

    Every timed region is a span on a local, always-on tracer (it forwards
    into the user's tracer when ``compute_ph(trace=...)`` activated one),
    each phase carrying its lane (shard) and superstep.  The host runs
    every shard's work back-to-back, so ``sim_wall_s`` is the critical path
    a P-device mesh would execute, *derived* from that span timeline
    (:func:`repro_torch.obs.trace.critical_path`): per-shard busy time for
    the data-parallel phases (fused block work attributed by row share,
    per-slice serial passes timed directly) plus the sequential parts at
    full cost (tournament, the in-order commit sweep, decode + install).
    The hand-rolled accounting is kept only as ``sim_wall_bookkeeping_s``,
    so the two can be cross-checked; for P == 1 both reproduce the measured
    wall.

    At P > 1 an armed fault injector (:func:`repro_torch.resilience.faults.
    inject`) kills or slows shards at ``reduce.superstep`` and drops,
    corrupts or delays payloads at ``exchange.wire``; the diagrams stay
    those of the fault-free run (module docstring, "Recovery"), and the
    seven ``resilience_*`` counters, the ``resilience/recover`` spans and
    the ``resilience_recover_s`` / ``resilience_backoff_s`` histograms
    record what happened.  ``kill_shard`` and ``slow_shard`` with a
    ``mesh`` raise the reference's ``ValueError``.
    """
    san = active_sanitizer()
    P = _resolve_reduce_shards(mesh, n_shards)
    if exchange_every < 1:
        raise ValueError("exchange_every must be >= 1")
    if mesh is not None:
        from ..launch.mesh import mesh_device
        device = mesh_device(mesh, device)
    dev = resolve_device(device)
    # local timeline: always on (sim_wall is derived from it), forwarding
    # into the user's tracer when compute_ph(trace=...) activated one
    tl = Tracer(forward_to=active_tracer())
    use_kernels = _resolve_use_kernels(use_kernels, dev)
    if cache is None:
        cache = PackedPivotCache()
    # P == 1 appends commits straight into the caller's sink (if any);
    # P > 1 owns a scratch log that is drained into per-shard wire backlogs
    # every slice — the sink then receives copies of each drained record
    commit_log: Optional[list] = [] if P > 1 else commit_sink
    store = PivotStore(adapter, mode, store_budget_bytes=store_budget_bytes,
                       cache=cache, commit_log=commit_log)
    if P > 1:
        # the replica mirrors the authority's track_gens: with an explicit
        # budgeted store the wire ships δ-expansions precisely so that
        # replica probes can return them (install() never spills, so the
        # budget carries no other behavior here)
        replica = PivotStore(adapter, mode,
                             store_budget_bytes=store_budget_bytes,
                             cache=cache)
        exchange = _make_exchange(mesh)
        lookup_store = replica
        # commits the replica has not installed yet: each shard's wire
        # backlog plus a map of their pivot lows -> (slice, superstep) —
        # the only lows at which the sweep's store re-probe can possibly
        # hit for rows that already stabilized against the replica, and
        # the provenance that drives the sweep's critical-path accounting
        shard_logs: List[list] = [[] for _ in range(P)]
        pending: Dict[int, Tuple[int, int]] = {}
        # -- resilience: heartbeat supervision on the deterministic
        # superstep clock.  Every live shard beats once per superstep; a
        # shard that misses a beat past the timeout is dead and its
        # remaining batch queue re-deals to the survivors from the last
        # exact commit sweep.  Stragglers are sidelined from dealing for a
        # cooldown but stay live.  An armed FaultInjector is what
        # kills/slows shards and drops/corrupts wire payloads, on a seeded
        # schedule; with none armed this is all no-op bookkeeping.
        sup = ShardSupervisor(n_shards=P, timeout=0.75, factor=3.0,
                              sideline=1)
        inj = active_injector()
        killed: set = set()
        slow_lag: Dict[int, Tuple[float, int]] = {}  # shard -> (lag, until)
        n_shard_deaths = 0
        n_redeals = 0
        n_sidelines = 0
        n_exchange_retries = 0
        n_exchange_deferrals = 0
        n_wire_corruptions = 0
        n_faults_seen = 0
    else:
        lookup_store = store
    pairs: List[tuple] = []
    essentials: List[float] = []
    essential_ids: List[int] = []
    n_reductions = 0
    n_rounds = 0
    n_expansions = 0
    n_evictions = 0
    n_consolidations = 0
    n_supersteps = 0
    n_exchange_rounds = 0
    n_tournament_reductions = 0
    n_sweep_probes = 0
    exchange_bytes = 0
    peak_block_bytes = 0
    # hand-rolled critical-path wall, kept ONLY to cross-check the
    # span-derived accounting (emitted as sim_wall_bookkeeping_s)
    sim_wall_book = 0.0
    reg = MetricsRegistry()
    queue = clearing_filter(column_ids, cleared)
    eff_batch = batch_size
    if len(queue):
        cob0 = adapter.cobdy(queue[:min(batch_size, len(queue))])
        eff_batch = _budgeted_batch_size(batch_size, cob0.shape[1],
                                         store_budget_bytes)

    pos = 0
    while pos < len(queue):
        # ---- superstep: the next up-to-|active| batches, dealt
        # round-robin over the supervisor's active shards (all P when
        # nothing failed); slice k is shard active[k]'s local batch ----
        n_supersteps += 1
        step = n_supersteps
        mid_kills: List[int] = []
        if P > 1:
            if inj is not None:
                for s in list(sup.live):
                    for f in inj.fire("reduce.superstep", index=step,
                                      shard=s):
                        if f.kind in ("kill_shard", "slow_shard") \
                                and mesh is not None:
                            raise ValueError(
                                f"{f.kind} injection requires the "
                                "host-partitioned driver (mesh=None): a "
                                "mesh cannot shrink mid-collective")
                        n_faults_seen += 1
                        if f.kind == "kill_shard":
                            if f.param("when", "start") == "mid":
                                # participates in the concurrent phase,
                                # dies before its commit sweep
                                mid_kills.append(s)
                            else:
                                killed.add(s)
                        elif f.kind == "slow_shard":
                            # beat lag clamped below the death timeout:
                            # "slow" degrades, it does not kill
                            slow_lag[s] = (
                                min(float(f.param("lag", 0.6)), 0.6),
                                step + int(f.param("duration", 1)))
            beats: Dict[int, float] = {}
            for s in sup.live:
                if s in killed:
                    continue                  # a dead shard stops beating
                lag = slow_lag.get(s)
                beats[s] = (float(step) - lag[0]
                            if lag is not None and step <= lag[1]
                            else float(step))
            plan = sup.observe(float(step), beats)
            if not sup.live:
                raise RuntimeError(
                    "every reduction shard died; cannot recover")
            if plan.dead:
                # re-deal the dead shards' remaining queue to survivors
                # (dealing below only feeds active shards) and hand their
                # un-replicated wire backlog to an heir so the replica
                # eventually hears about those commits
                with tl.span("resilience/recover", step=step,
                             kind="kill_start",
                             shards=tuple(plan.dead)) as rsp:
                    n_shard_deaths += len(plan.dead)
                    n_redeals += 1
                    heir = sup.live[0]
                    for d in plan.dead:
                        if shard_logs[d]:
                            shard_logs[heir].extend(shard_logs[d])
                            shard_logs[d] = []
                reg.histogram("resilience_recover_s").observe(rsp.dur)
            if plan.stragglers:
                n_sidelines += len(plan.stragglers)
            active = plan.active
        else:
            active = [0]
        slice_sizes = []
        start = pos
        for _ in range(len(active)):
            if pos >= len(queue):
                break
            take = min(eff_batch, len(queue) - pos)
            slice_sizes.append(take)
            pos += take
        ids_arr = np.asarray(queue[start:pos], dtype=np.int64)
        bounds = np.zeros(len(slice_sizes) + 1, dtype=np.int64)
        np.cumsum(slice_sizes, out=bounds[1:])
        n_slices = len(slice_sizes)
        B = len(ids_arr)
        ids_int = [int(i) for i in ids_arr]
        if san is not None:
            san.set_context(superstep=n_supersteps,
                            batch=f"{start}:{pos}")
        gens: List[Dict[int, int]] = [dict() for _ in range(B)]
        # per-shard busy accounting, span-encoded (obs.trace.critical_path):
        # fused block ops split by row share (the ``weights`` attr),
        # per-slice work on its own device lane, sync parts at full cost
        wt = tuple(float(sz) / max(B, 1) for sz in slice_sizes)
        t_fused = 0.0
        t_slice = np.zeros(max(n_slices, 1))
        t_seq = 0.0
        with tl.span("reduce/fused", step=step, weights=wt) as sp:
            cob = adapter.cobdy(ids_arr)
            if seed_gens:
                # warm restart: seeded rows start from their recorded
                # residual (a valid left-to-right partial reduction state)
                # with gens parity pre-loaded — pad the row width when a
                # residual outgrows one coboundary row
                residuals: Dict[int, np.ndarray] = {}
                for i in range(B):
                    seed = seed_gens.get(ids_int[i])
                    if seed is not None and len(seed):
                        residuals[i] = seed_column(adapter, ids_int[i], seed)
                        gens[i] = {int(g): 1 for g in seed}
                if residuals:
                    width = max(cob.shape[1],
                                max(r.size for r in residuals.values()))
                    if width > cob.shape[1]:
                        pad = np.full((B, width - cob.shape[1]), EMPTY_KEY,
                                      dtype=np.int64)
                        cob = np.concatenate([cob, pad], axis=1)
                    else:
                        cob = cob.copy()
                    for i, r in residuals.items():
                        cob[i, :] = EMPTY_KEY
                        cob[i, :r.size] = r
            # seed the bit-space with the first round of addends so the
            # common case packs exactly once; the concurrent phase probes
            # the replica (P > 1) — complete up to the last exchange
            # round — or the store
            lows0 = np.where(cob[:, 0] == EMPTY_KEY, np.int64(-1), cob[:, 0])
            addends, owners, owner_gens = \
                lookup_store.lookup_addends_batched(lows0, ids_arr)
            addend_lows = lows0
            batchblk = _PackedBatch(
                cob, [a for a in addends if a is not None], use_kernels,
                dev, cache=cache, evict_max=_EVICT_MAX * n_slices)
        t_fused += sp.dur

        probe = np.zeros(B, dtype=bool)   # rows whose low moved since probe
        while True:
            with tl.span("reduce/fused", step=step, weights=wt) as sp:
                hit = [i for i in range(B) if addends[i] is not None]
                if hit:
                    n_rounds += 1
                    n_reductions += len(hit)
                    for i in hit:
                        o = int(owners[i])
                        gens[i][o] = gens[i].get(o, 0) + 1
                        for g in owner_gens[i]:
                            g = int(g)
                            gens[i][g] = gens[i].get(g, 0) + 1
                    batchblk.xor_addends(hit, addends, addend_lows)
                    probe[hit] = batchblk.lows[hit] >= 0
            t_fused += sp.dur

            # intra-slice collisions -> per-slice serial pass in filtration
            # order (the whole block is one slice when P == 1)
            for k in range(n_slices):
                s0, s1 = int(bounds[k]), int(bounds[k + 1])
                sl_lows = batchblk.lows[s0:s1]
                nz = sl_lows[sl_lows >= 0]
                if len(np.unique(nz)) != len(nz):
                    with tl.span("reduce/slice", lane=k, step=step) as sp:
                        rows = None if n_slices == 1 else np.arange(s0, s1)
                        n_red, changed = batchblk.serial_pass(gens, ids_int,
                                                              rows=rows)
                        n_reductions += n_red
                        probe[changed] = batchblk.lows[changed] >= 0
                    t_slice[k] += sp.dur

            if not probe.any() and n_slices > 1:
                with tl.span("reduce/tournament", step=step) as sp:
                    n_red, changed = _tournament_merge(batchblk, gens,
                                                       ids_int, bounds)
                    n_reductions += n_red
                    n_tournament_reductions += n_red
                    probe[changed] = batchblk.lows[changed] >= 0
                t_seq += sp.dur

            if not probe.any():
                break
            with tl.span("reduce/fused", step=step, weights=wt) as sp:
                probe_lows = np.where(probe, batchblk.lows, -1)
                probe[:] = False
                addends, owners, owner_gens = \
                    lookup_store.lookup_addends_batched(probe_lows, ids_arr)
                addend_lows = probe_lows
            t_fused += sp.dur

        if P > 1 and mid_kills:
            # the shard died after its concurrent phase but before its
            # commit sweep: nothing of this superstep has committed, so the
            # last commit sweep is still the exact recovery line — discard
            # the superstep (its block, device copies and cache epoch go
            # with it; the next block bumps the epoch and sizes its
            # eviction threshold to its own slices) and restart it from
            # ``start`` with the survivors
            with tl.span("resilience/recover", step=step, kind="kill_mid",
                         shards=tuple(mid_kills)) as rsp:
                for s in mid_kills:
                    killed.add(s)
                    sup.kill(s)
                n_shard_deaths += len(mid_kills)
                n_redeals += 1
                if sup.live:
                    heir = sup.live[0]
                    for s in mid_kills:
                        if shard_logs[s]:
                            shard_logs[heir].extend(shard_logs[s])
                            shard_logs[s] = []
            if not sup.live:
                raise RuntimeError(
                    "every reduction shard died; cannot recover")
            # time-to-recover = the discarded concurrent work + the
            # bookkeeping above (the re-dealt batches rerun next loop)
            reg.histogram("resilience_recover_s").observe(
                t_fused + float(t_slice[:max(n_slices, 1)].sum())
                + t_seq + rsp.dur)
            pos = start
            continue

        # ---- exact commit sweep, slice by slice in global batch order:
        # re-probe the *authoritative* store until stable, then
        # clearance-commit — the realized schedule is a left-to-right
        # reduction, so diagrams are bit-identical to the single-device
        # engines.  Every row already stabilized against the replica, so a
        # store probe can only hit at a ``pending`` low (committed since
        # the last exchange round — including this superstep's
        # earlier-slice pivots); only rows at those lows, or rows the
        # sweep itself changed ("dirty"), need re-probing.  For the
        # simulated wall, slice k's sweep waits only on the slices whose
        # *this-superstep* pivots it actually absorbed — ``deps`` records
        # that DAG ----
        t_sweep = np.zeros(max(n_slices, 1))
        deps: List[set] = [set() for _ in range(max(n_slices, 1))]
        for k in range(n_slices):
            with tl.span("reduce/sweep", lane=k, step=step) as sw_sp:
                if san is not None:
                    san.set_context(slice=k)
                s0, s1 = int(bounds[k]), int(bounds[k + 1])
                rows = np.arange(s0, s1)
                sids = ids_arr[s0:s1]
                if P > 1:
                    pending_arr = np.fromiter(pending, dtype=np.int64,
                                              count=len(pending))
                    dirty = np.zeros(len(sids), dtype=bool)
                    while True:
                        sl_lows = batchblk.lows[s0:s1].copy()
                        cand = dirty.copy()
                        if pending_arr.size:
                            cand |= np.isin(sl_lows, pending_arr)
                        cand &= sl_lows >= 0
                        if not cand.any():
                            break
                        sl_lows[~cand] = -1
                        n_sweep_probes += 1
                        adds, owns, ogens = \
                            store.lookup_addends_batched(sl_lows, sids)
                        dirty[:] = False
                        hit_local = [i for i in range(len(sids))
                                     if adds[i] is not None]
                        if hit_local:
                            n_rounds += 1
                            n_reductions += len(hit_local)
                            for i in hit_local:
                                c = s0 + i
                                o = int(owns[i])
                                gens[c][o] = gens[c].get(o, 0) + 1
                                for g in ogens[i]:
                                    g = int(g)
                                    gens[c][g] = gens[c].get(g, 0) + 1
                                src = pending.get(int(sl_lows[i]))
                                if src is not None \
                                        and src[1] == n_supersteps:
                                    deps[k].add(src[0])
                            # block-row indexing: the kernel round maps
                            # these B-long arrays by the hit rows' indices
                            full_adds: List[Optional[np.ndarray]] = [None] * B
                            full_lows = np.full(B, -1, dtype=np.int64)
                            for i in hit_local:
                                full_adds[s0 + i] = adds[i]
                                full_lows[s0 + i] = sl_lows[i]
                            batchblk.xor_addends([s0 + i for i in hit_local],
                                                 full_adds, full_lows)
                            dirty[hit_local] = True
                        cur = batchblk.lows[s0:s1]
                        nz = cur[cur >= 0]
                        if len(np.unique(nz)) != len(nz):
                            n_red, changed = batchblk.serial_pass(
                                gens, ids_int, rows=rows)
                            n_reductions += n_red
                            dirty[changed - s0] = True
                        dirty &= batchblk.lows[s0:s1] >= 0

                log_mark = len(commit_log) if P > 1 else 0
                clearance_commit(
                    store, adapter, sids, batchblk.lows[s0:s1],
                    gens[s0:s1],
                    lambda rr, rows=rows: batchblk.unpack(
                        rows[np.asarray(rr, dtype=np.int64)]),
                    pairs, essentials, essential_ids=essential_ids,
                    essential_log=essential_log)
                if P > 1 and len(commit_log) > log_mark:
                    # drain this slice's commits straight into its shard's
                    # wire backlog; their lows are pending until the next
                    # exchange.  With gens untracked (explicit, no budget)
                    # neither side of the wire ever reads a δ-expansion —
                    # don't ship them.  The caller's sink gets record
                    # copies *before* the gens strip mutates them.
                    fresh = commit_log[log_mark:]
                    if commit_sink is not None:
                        commit_sink.extend(dict(r) for r in fresh)
                    if not store.track_gens:
                        for r in fresh:
                            r["gens"] = None
                    shard_logs[active[k]].extend(fresh)
                    for r in fresh:
                        pending[r["low"]] = (k, n_supersteps)
                    del commit_log[log_mark:]
                # the dep DAG is known only now — amend the span so the
                # timeline alone reconstructs the sweep critical path
                sw_sp.set(deps=tuple(sorted(deps[k])))
            t_sweep[k] += sw_sp.dur

        # critical path over the sweep DAG: finish(k) = t_sweep[k] +
        # max finish over the slices k absorbed from (deps point strictly
        # backward, so one forward pass is the longest-path DP)
        finish = np.zeros(max(n_slices, 1))
        for k in range(n_slices):
            dep_finish = max((finish[d] for d in deps[k]), default=0.0)
            finish[k] = dep_finish + t_sweep[k]
        sweep_cp = float(finish[:max(n_slices, 1)].max()) if n_slices else 0.0
        t_seq += sweep_cp

        peak_block_bytes = max(peak_block_bytes, batchblk.peak_bytes)
        n_consolidations += batchblk.n_consolidations
        n_expansions += batchblk.n_expansions
        n_evictions += batchblk.n_evictions

        frac = np.asarray(wt, dtype=np.float64)
        step_conc = float(np.max(t_fused * frac + t_slice[:n_slices]))
        reg.histogram("superstep_conc_s").observe(step_conc)
        sim_wall_book += step_conc + t_seq

        # ---- pivot exchange (every ``exchange_every`` supersteps, and
        # skipped once the queue is drained — the replica is never read
        # again): each shard ships its backlog as one EF-compressed
        # payload; every shard installs all decoded payloads into its
        # replica.  The wire is a gather over the mesh's data axis, or the
        # host loop-back without a mesh, and the replica is installed once —
        # exactly one device's worth of decode + install work ----
        if (P > 1 and pos < len(queue)
                and n_supersteps % exchange_every == 0
                and any(shard_logs)):
            n_exchange_rounds += 1
            t_enc = np.zeros(P)
            payloads = []
            shipped_lows: List[List[int]] = []
            for k in range(P):
                with tl.span("reduce/encode", lane=k, step=step) as sp:
                    payloads.append(encode_commit_delta(shard_logs[k]))
                shipped_lows.append([r["low"] for r in shard_logs[k]])
                t_enc[k] = sp.dur
            # wire-level faults: each payload's delivery gets a bounded
            # retry with deterministic jittered backoff (the schedule is
            # accounted, not slept); a payload that exhausts its budget is
            # *deferred* — an empty payload ships in its slot and its
            # backlog + pending lows survive to the next round, exact by
            # the same staleness argument as the exchange cadence itself
            delivered = [True] * P
            if inj is not None:
                empty_payload = encode_commit_delta([])

                def note_retry(a, e, delay):
                    nonlocal n_exchange_retries
                    n_exchange_retries += 1
                    reg.histogram("resilience_backoff_s").observe(delay)

                for k in range(P):
                    def attempt(a, k=k, buf0=payloads[k]):
                        nonlocal n_faults_seen, n_wire_corruptions
                        buf = buf0
                        for f in inj.fire("exchange.wire",
                                          index=n_exchange_rounds,
                                          shard=k):
                            n_faults_seen += 1
                            if f.kind == "drop":
                                raise TransientFault(
                                    f"exchange payload {k} dropped")
                            if f.kind == "corrupt":
                                buf = corrupt_payload(
                                    buf, int(f.param("bit", 17)))
                            elif f.kind == "delay":
                                reg.histogram(
                                    "resilience_backoff_s").observe(
                                    float(f.param("delay_s", 1e-3)))
                        if not verify_commit_delta(buf):
                            n_wire_corruptions += 1
                            raise TransientFault(
                                f"exchange payload {k} corrupt on the "
                                "wire (checksum)")
                        return buf

                    try:
                        payloads[k] = retry_with_backoff(
                            attempt, attempts=3, base_s=1e-4,
                            seed=(n_exchange_rounds << 8) | k,
                            sleep=None, on_retry=note_retry)
                    except TransientFault:
                        n_exchange_deferrals += 1
                        payloads[k] = empty_payload
                        delivered[k] = False
            wire = sum(p.nbytes for p in payloads)
            exchange_bytes += wire
            with tl.span("reduce/exchange", step=step,
                         bytes=int(wire)) as sp:
                for payload in exchange(payloads):
                    for rec in decode_commit_delta(payload):
                        replica.install(rec["low"], rec["col_id"],
                                        rec["mode"], rec["column"],
                                        rec["gens"])
            sim_wall_book += float(t_enc.max()) + sp.dur
            for k in range(P):
                if delivered[k]:
                    for low in shipped_lows[k]:
                        pending.pop(low, None)
                    shard_logs[k] = []

    if san is not None:
        san.set_context(superstep=None, batch=None, slice=None)
    # the reported sim walls are DERIVED from the span timeline — the
    # bookkeeping above survives only as its cross-check
    cp = critical_path(tl.spans)
    reg.counter("n_columns").inc(len(queue))
    reg.counter("n_reductions").inc(n_reductions)
    reg.counter("n_pairs").inc(len(pairs))
    reg.counter("n_essential").inc(len(essentials))
    reg.gauge("stored_bytes").set(store.bytes_stored)
    reg.gauge("n_stored_columns").set(len(store.columns))
    reg.counter("n_spilled").inc(store.n_spilled)
    reg.gauge("batch_size").set(eff_batch)
    reg.counter("n_rounds").inc(n_rounds)
    reg.counter("n_expansions").inc(n_expansions)
    reg.counter("n_evictions").inc(n_evictions)
    reg.counter("n_consolidations").inc(n_consolidations)
    reg.gauge("peak_block_bytes").record_max(peak_block_bytes)
    reg.gauge("use_kernels").set(float(use_kernels))
    reg.gauge("n_shards").set(P)
    reg.counter("n_supersteps").inc(n_supersteps)
    reg.counter("n_exchange_rounds").inc(n_exchange_rounds)
    reg.counter("n_tournament_reductions").inc(n_tournament_reductions)
    reg.counter("n_sweep_probes").inc(n_sweep_probes)
    reg.counter("exchange_bytes").inc(exchange_bytes)
    if P > 1:
        reg.counter("resilience_n_faults").inc(n_faults_seen)
        reg.counter("resilience_n_shard_deaths").inc(n_shard_deaths)
        reg.counter("resilience_n_redeals").inc(n_redeals)
        reg.counter("resilience_n_straggler_sidelines").inc(n_sidelines)
        reg.counter("resilience_n_exchange_retries").inc(n_exchange_retries)
        reg.counter("resilience_n_exchange_deferrals").inc(
            n_exchange_deferrals)
        reg.counter("resilience_n_wire_corruptions").inc(n_wire_corruptions)
    for key, val in cp.items():
        reg.gauge(key).set(val)
    reg.gauge("sim_wall_bookkeeping_s").set(sim_wall_book)
    reg.update_from(cache.stats())
    return finalize_result(pairs, essentials, essential_ids, reg.as_stats())
