"""Bit-packed serial-parallel reduction engine (Dory §4.4 × kernels/gf2).

Port of ``src/repro/core/packed_reduce.py``: ``_PackedBatch`` and the
single-device (P = 1) driver of ``reduce_dimension_packed``, kernel path
included.  The host-side combinatorics stay numpy, exactly as in the
reference; on the kernel path the GF(2) kernels of
:mod:`repro_torch.kernels.gf2` run on ``device`` — hand-written CUDA on a
card, their plain PyTorch versions on the CPU.  A parallel-phase round
makes one round trip: the hit rows go to the device, ``gf2_scatter_xor``
adds the addends' coordinates into them and ``gf2_find_low`` reads each
segment's window of the result, and rows and lows come back in one copy.
The serial pre-pass keeps the reference's round trip per call.  The
distributed superstep driver (tournament, commit sweep, pivot exchange),
the sanitizer and the fault hooks stay in the reference until the port
takes them over.

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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.gf2 import (NO_LOW, find_low_np, gf2_find_low,
                           gf2_scatter_xor, gf2_serial_reduce, scatter_bits,
                           scatter_xor_bits, set_bit_positions, to_numpy,
                           to_tensor)
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer, active_tracer, critical_path
from .pairing import EMPTY_KEY
from .pivot_cache import PackedPivotCache
from .reduction import (DimensionAdapter, PivotStore, ReductionResult,
                        clearance_commit, clearing_filter, finalize_result,
                        merge_cancel, refuse_resume_hooks)

_MAX_SEGMENTS = 12   # host path consolidates past this many segments
_EVICT_MAX = 8       # rounds needing new keys for fewer rows evict instead


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
    growth, consolidation and eviction unchanged.
    """

    def __init__(self, cob: np.ndarray, seed_addends: List[np.ndarray],
                 use_kernels: bool, device: torch.device, cache=None):
        B = cob.shape[0]
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
        if self.cache is not None:
            self.cache.bump_epoch()   # re-ranking invalidates cached positions
        ridx_all, keys_all = [], []
        for seg, off in zip(self.segs, self.seg_off):
            w = _words(len(seg), self.use_kernels)
            ridx, pos, _ = set_bit_positions(self.block[:, off:off + w])
            keep = pos < len(seg)
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
        (dense rounds) or evict their rows (sparse rounds, ``_EVICT_MAX``).

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
                if len(miss_rows) <= _EVICT_MAX:
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
                    ids_int: List[int]) -> Tuple[int, np.ndarray]:
        """Resolve intra-batch low collisions in filtration order.

        Kernel path: a ``gf2_serial_reduce`` V-augmented pre-pass clears
        packed-vs-packed collisions on the device (V bits -> gens merge), then
        the host walk finishes scalar-involved collisions.  Host path: the
        walk does everything via :meth:`_absorb`.  Returns
        ``(n_reductions, changed_row_indices)``.
        """
        n_red = 0
        changed: Dict[int, bool] = {}
        if self.use_kernels:
            n_red += self._serial_kernel_prepass(gens, ids_int, changed)
        low_to_row: Dict[int, int] = {}
        for c in range(self.B):
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
    decreasing filtration order, diagrams bit-identical to it.
    ``device=None`` is the card (``RuntimeError`` without one);
    ``use_kernels=None`` resolves from the device — the CUDA kernels on
    ``cuda``, the numpy block mirrors on ``cpu`` — and ``True`` forces the
    kernel path, which on the CPU runs the kernels' plain versions.
    ``cache`` threads a caller-owned :class:`PackedPivotCache` (one is
    created per call otherwise).

    Not in this port yet, refused with ``NotImplementedError``: ``n_shards``
    > 1, ``mesh`` and ``exchange_every`` other than 4 (the distributed
    driver, ROADMAP.md §1 item 4); ``seed_gens``, ``commit_sink`` and
    ``essential_log`` (the resume hooks, item 7).

    Every batch is a ``reduce/*`` span on a local, always-on tracer (it
    forwards into the user's tracer when ``compute_ph(trace=...)``
    activated one); the ``sim_*`` walls are derived from that timeline, as
    in the reference, and for one device reproduce the measured wall.  The
    reference's distributed counters (``n_shards``, exchange, tournament,
    sweep) are emitted at their one-device values so both packages report
    one key set.
    """
    if mesh is not None or (n_shards is not None and n_shards != 1) \
            or exchange_every != 4:
        raise NotImplementedError(
            "n_shards > 1 / mesh= / exchange_every != 4 (the distributed "
            "reduction) are not ported yet: ROADMAP.md §1 item 4")
    refuse_resume_hooks(seed_gens=seed_gens, commit_sink=commit_sink,
                        essential_log=essential_log)
    dev = resolve_device(device)
    tl = Tracer(forward_to=active_tracer())
    use_kernels = _resolve_use_kernels(use_kernels, dev)
    if cache is None:
        cache = PackedPivotCache()
    store = PivotStore(adapter, mode, store_budget_bytes=store_budget_bytes,
                       cache=cache)
    pairs: List[tuple] = []
    essentials: List[float] = []
    essential_ids: List[int] = []
    n_reductions = 0
    n_rounds = 0
    n_expansions = 0
    n_evictions = 0
    n_consolidations = 0
    n_supersteps = 0
    peak_block_bytes = 0
    # hand-rolled wall, kept ONLY to cross-check the span-derived one
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
        n_supersteps += 1
        step = n_supersteps
        start = pos
        pos = min(pos + eff_batch, len(queue))
        ids_arr = np.asarray(queue[start:pos], dtype=np.int64)
        B = len(ids_arr)
        ids_int = [int(i) for i in ids_arr]
        gens: List[Dict[int, int]] = [dict() for _ in range(B)]
        t_fused = 0.0
        t_slice = 0.0
        with tl.span("reduce/fused", step=step, weights=(1.0,)) as sp:
            cob = adapter.cobdy(ids_arr)
            # seed the bit-space with the first round of addends so the
            # common case packs exactly once
            lows0 = np.where(cob[:, 0] == EMPTY_KEY, np.int64(-1), cob[:, 0])
            addends, owners, owner_gens = \
                store.lookup_addends_batched(lows0, ids_arr)
            addend_lows = lows0
            batchblk = _PackedBatch(
                cob, [a for a in addends if a is not None], use_kernels,
                dev, cache=cache)
        t_fused += sp.dur

        probe = np.zeros(B, dtype=bool)   # rows whose low moved since probe
        while True:
            with tl.span("reduce/fused", step=step, weights=(1.0,)) as sp:
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

            # intra-batch collisions -> serial pass in filtration order
            nz = batchblk.lows[batchblk.lows >= 0]
            if len(np.unique(nz)) != len(nz):
                with tl.span("reduce/slice", lane=0, step=step) as sp:
                    n_red, changed = batchblk.serial_pass(gens, ids_int)
                    n_reductions += n_red
                    probe[changed] = batchblk.lows[changed] >= 0
                t_slice += sp.dur

            if not probe.any():
                break
            with tl.span("reduce/fused", step=step, weights=(1.0,)) as sp:
                probe_lows = np.where(probe, batchblk.lows, -1)
                probe[:] = False
                addends, owners, owner_gens = \
                    store.lookup_addends_batched(probe_lows, ids_arr)
                addend_lows = probe_lows
            t_fused += sp.dur

        with tl.span("reduce/sweep", lane=0, step=step, deps=()) as sw_sp:
            rows = np.arange(B)
            clearance_commit(
                store, adapter, ids_arr, batchblk.lows, gens,
                lambda rr: batchblk.unpack(rows[np.asarray(rr,
                                                           dtype=np.int64)]),
                pairs, essentials, essential_ids=essential_ids)

        peak_block_bytes = max(peak_block_bytes, batchblk.peak_bytes)
        n_consolidations += batchblk.n_consolidations
        n_expansions += batchblk.n_expansions
        n_evictions += batchblk.n_evictions

        step_conc = t_fused + t_slice
        reg.histogram("superstep_conc_s").observe(step_conc)
        sim_wall_book += step_conc + sw_sp.dur

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
    reg.gauge("n_shards").set(1)
    reg.counter("n_supersteps").inc(n_supersteps)
    reg.counter("n_exchange_rounds").inc(0)
    reg.counter("n_tournament_reductions").inc(0)
    reg.counter("n_sweep_probes").inc(0)
    reg.counter("exchange_bytes").inc(0)
    for key, val in cp.items():
        reg.gauge(key).set(val)
    reg.gauge("sim_wall_bookkeeping_s").set(sim_wall_book)
    reg.update_from(cache.stats())
    return finalize_result(pairs, essentials, essential_ids, reg.as_stats())
