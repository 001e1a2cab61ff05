"""Lossless Elias–Fano transport for the pivot exchange.

Port of the lossless half of ``src/repro/dist/compression.py`` (host numpy,
word for word the reference's wire format, so either package decodes the
other's payloads).  The int8 error-feedback gradient codec
(``ef_compress``, ``compressed_psum_grads``) serves training and comes with
the rest of the LM substrate (ROADMAP.md §1 item 10).

The distributed packed reduction (:mod:`repro_torch.core.packed_reduce`)
ships committed pivot columns between shards once per exchange round, and
GF(2) pivot data tolerates *zero* loss — one flipped key breaks bit-identity
of the diagrams.  Pivot columns are strictly-increasing int64 key arrays,
the textbook Elias–Fano case: ``n`` values below universe ``U`` cost
``n * (2 + ceil(log2(U/n)))`` bits — each key stores its low
``l = floor(log2(U/n))`` bits verbatim and its high bits unary in a
bitvector with exactly one set bit per value (``high + index``), so both
streams decode vectorized (``np.unpackbits`` + ``flatnonzero``).
``ef_encode_sorted``/``ef_decode_sorted`` are the exact round-trip pair;
``pack_column_payload``/``unpack_column_payload`` lift them to a *batch* of
sorted columns by embedding column ``c``'s keys into the single
strictly-increasing sequence ``keys + c * U``, so one vectorized encode
covers the whole delta.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["ef_encode_sorted", "ef_decode_sorted",
           "pack_column_payload", "unpack_column_payload"]

_EF_MAGIC = np.uint32(0xEF50)


def _bits_to_words(bits: np.ndarray) -> np.ndarray:
    """Little-endian bit array (uint8 of 0/1) -> uint32 words."""
    packed = np.packbits(bits, bitorder="little")
    pad = (-packed.size) % 4
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, dtype=np.uint8)])
    return packed.view(np.uint32)


def _words_to_bits(words: np.ndarray, n_bits: int) -> np.ndarray:
    return np.unpackbits(words.view(np.uint8), bitorder="little",
                         count=n_bits)


def ef_encode_sorted(values: np.ndarray,
                     universe: Optional[int] = None) -> np.ndarray:
    """Elias–Fano encode a non-decreasing non-negative int64 array.

    Returns a flat uint32 word array (the wire payload).  Exact round trip:
    ``ef_decode_sorted(ef_encode_sorted(v)) == v`` for every valid input,
    including empty.  ``universe`` (exclusive upper bound) defaults to
    ``values[-1] + 1``; pass a larger one only to pin the split parameter
    across payloads.
    """
    v = np.ascontiguousarray(values, dtype=np.int64)
    n = v.size
    if n == 0:
        return np.array([_EF_MAGIC, 0, 0, 0, 0], dtype=np.uint32)
    if v[0] < 0:
        raise ValueError("ef_encode_sorted requires non-negative values")
    if np.any(np.diff(v) < 0):
        raise ValueError("ef_encode_sorted requires a sorted sequence")
    top = int(v[-1])
    u = top + 1 if universe is None else int(universe)
    if u <= top:
        raise ValueError(f"universe {u} too small for max value {top}")
    # l = floor(log2(u / n)) clipped to [0, 63): low bits verbatim, high
    # bits unary.  Total: n*l + n + (u >> l) bits ~ n * (2 + log2(u/n)).
    l = max(int(u // n).bit_length() - 1, 0)
    l = min(l, 62)
    low = v & ((np.int64(1) << l) - 1) if l else np.zeros(n, dtype=np.int64)
    high = (v >> l).astype(np.int64)
    # low stream: n*l bits, value i at bits [i*l, (i+1)*l)
    if l:
        low_bits = ((low[:, None] >> np.arange(l, dtype=np.int64)) & 1)
        low_words = _bits_to_words(low_bits.astype(np.uint8).ravel())
    else:
        low_words = np.zeros(0, dtype=np.uint32)
    # high stream: unary bitvector, one set bit per value at high[i] + i
    hi_len = int(high[-1]) + n
    hi_bits = np.zeros(hi_len, dtype=np.uint8)
    hi_bits[high + np.arange(n, dtype=np.int64)] = 1
    hi_words = _bits_to_words(hi_bits)
    header = np.array([_EF_MAGIC, n & 0xFFFFFFFF, n >> 32, l, hi_len],
                      dtype=np.uint32)
    return np.concatenate([header, low_words, hi_words])


def ef_decode_sorted(payload: np.ndarray) -> np.ndarray:
    """Inverse of :func:`ef_encode_sorted`: payload words -> int64 array."""
    w = np.ascontiguousarray(payload, dtype=np.uint32)
    if w.size < 5 or w[0] != _EF_MAGIC:
        raise ValueError("not an Elias–Fano payload")
    n = int(w[1]) | (int(w[2]) << 32)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    l = int(w[3])
    hi_len = int(w[4])
    n_low_words = (n * l + 31) // 32
    low_words = w[5:5 + n_low_words]
    hi_words = w[5 + n_low_words:]
    if l:
        low_bits = _words_to_bits(low_words, n * l).reshape(n, l)
        low = low_bits.astype(np.int64) @ (np.int64(1) << np.arange(l))
    else:
        low = np.zeros(n, dtype=np.int64)
    hi_bits = _words_to_bits(hi_words, hi_len)
    pos = np.flatnonzero(hi_bits).astype(np.int64)
    if pos.size != n:
        raise ValueError(f"corrupt payload: {pos.size} high bits, expect {n}")
    high = pos - np.arange(n, dtype=np.int64)
    return (high << l) | low


def pack_column_payload(columns: Sequence[np.ndarray]) -> np.ndarray:
    """Encode a batch of strictly-sorted int64 columns as one payload.

    Column ``c``'s keys embed into the global strictly-increasing sequence
    ``keys + c * U`` (``U`` = 1 + max key over the batch): within a column
    the keys already ascend, and across a boundary the ``+U`` step exceeds
    any key reset — so a *single* vectorized Elias–Fano encode carries the
    whole delta, and the decoder splits columns back out with one
    divmod.  Empty columns round-trip (they occupy no keys but keep their
    slot via the count header; an all-empty batch is a 5-word payload).
    Falls back to raw 2-word-per-key packing when ``U * n_columns`` would
    overflow int64 (header word 1 says which: 0 EF, 1 raw, 2 all-empty).
    """
    cols = [np.ascontiguousarray(c, dtype=np.int64) for c in columns]
    counts = np.array([c.size for c in cols], dtype=np.int64)
    ncols = len(cols)
    flat = (np.concatenate(cols) if ncols
            else np.zeros(0, dtype=np.int64))
    header = np.array([np.uint32(0xEFBA), 0, ncols & 0xFFFFFFFF,
                       ncols >> 32], dtype=np.uint32)
    if ncols and not flat.size:
        # every column empty (e.g. the R side of an implicit-mode delta):
        # the count header alone reconstructs the batch
        header[1] = 2
        return np.concatenate([header, np.zeros(1, dtype=np.uint32)])
    counts_payload = ef_encode_sorted(np.cumsum(counts)) if ncols else \
        np.zeros(0, dtype=np.uint32)
    u = int(flat.max()) + 1 if flat.size else 1
    if flat.size and np.any(flat < 0):
        raise ValueError("pack_column_payload requires non-negative keys")
    if ncols and u <= (2**62) // max(ncols, 1):
        col_idx = np.repeat(np.arange(ncols, dtype=np.int64), counts)
        seq = flat + col_idx * u
        keys_payload = ef_encode_sorted(seq, universe=u * ncols)
        ubits = np.array([u & 0xFFFFFFFF, u >> 32], dtype=np.uint32)
        body = np.concatenate([ubits, keys_payload])
    else:
        header[1] = 1  # raw fallback
        body = flat.view(np.uint32) if flat.size else \
            np.zeros(0, dtype=np.uint32)
    cp_len = np.array([counts_payload.size], dtype=np.uint32)
    return np.concatenate([header, cp_len, counts_payload, body])


def unpack_column_payload(payload: np.ndarray) -> List[np.ndarray]:
    """Inverse of :func:`pack_column_payload`."""
    w = np.ascontiguousarray(payload, dtype=np.uint32)
    if w.size < 5 or w[0] != np.uint32(0xEFBA):
        raise ValueError("not a column payload")
    raw = int(w[1])
    ncols = int(w[2]) | (int(w[3]) << 32)
    cp_len = int(w[4])
    if ncols == 0:
        return []
    if raw == 2:
        empty = np.zeros(0, dtype=np.int64)
        return [empty] * ncols
    counts_cum = ef_decode_sorted(w[5:5 + cp_len])
    counts = np.diff(counts_cum, prepend=0)
    body = w[5 + cp_len:]
    if raw:
        flat = body.view(np.int64) if body.size else np.zeros(0, np.int64)
    else:
        u = int(body[0]) | (int(body[1]) << 32)
        seq = ef_decode_sorted(body[2:])
        flat = seq % u
    splits = np.cumsum(counts)[:-1]
    return [c for c in np.split(flat, splits)]
