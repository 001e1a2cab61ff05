"""Compressed transport for the distributed paths (port of
``src/repro/dist/compression.py``): one lossy codec and one lossless, for
two different wires.

**int8 error-feedback (lossy, gradients).**  The slow axis of a multi-pod
mesh moves gradients, and gradients tolerate lossy transport when the
quantization error is *fed back*: each step quantizes ``g + err`` instead of
``g`` and carries the residual to the next step, so the accumulated signal
is unbiased (1-bit/int8 SGD with error feedback; Seide et al., Karimireddy
et al.).  :func:`ef_compress` quantizes to symmetric int8 with a
per-tensor scale, ``scale = max|g + err| / 127``, ``q = round((g + err) /
scale)``, so the per-element residual is at most half a quantization step.
:func:`compressed_psum_grads` is the wire format over a mesh axis: each
entry quantizes its own gradients, the int8 payloads and float32 scales
go through :func:`~repro_torch.launch.mesh.all_gather`, and the mean is
rebuilt from the dequantized rows.  The arithmetic is the reference's in
float32, with one addition: XLA's CPU backend flushes denormal inputs and
results to zero, and so does the port here, step by step, on every device,
so that the two packages agree bit for bit (a denormal ``scale`` degrades
to 1 with ``q = 0``, a denormal signal to 0).

**Elias–Fano (lossless, pivot exchange).**  The distributed packed
reduction (:mod:`repro_torch.core.packed_reduce`) ships committed pivot
columns between shards once per exchange round, and GF(2) pivot data
tolerates *zero* loss — one flipped key breaks bit-identity of the
diagrams.  Host numpy, word for word the reference's wire format, so either
package decodes the other's payloads.  Pivot columns are strictly-increasing
int64 key arrays, the textbook Elias–Fano case: ``n`` values below universe
``U`` cost ``n * (2 + ceil(log2(U/n)))`` bits — each key stores its low
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

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh, all_gather
from .sharding import tree_flatten_with_path, tree_unflatten

__all__ = ["compressed_psum_grads", "dequantize_int8", "ef_compress",
           "ef_encode_sorted", "ef_decode_sorted",
           "pack_column_payload", "unpack_column_payload"]

# The smallest normal float32: below it XLA's CPU backend reads and writes 0.
_F32_TINY = float(np.finfo(np.float32).tiny)


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Denormals flushed to zero, keeping the sign (XLA's CPU arithmetic)."""
    return torch.where(t.abs() < _F32_TINY, t * 0.0, t)


def ef_compress(x, err) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize ``x + err`` to int8. Returns ``(q, scale, new_err)``.

    ``|new_err| <= scale / 2`` elementwise, and ``dequantize_int8(q, scale)
    + new_err == x + err`` exactly (the feedback identity).  A zero or
    denormal-underflow scale degrades to q=0 with the full signal carried in
    ``new_err`` — never a NaN/inf.
    """
    y = _ftz(_ftz(x.float()) + _ftz(err.float()))
    scale = _ftz(torch.max(torch.abs(y)) / 127.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(y / scale), -127.0, 127.0).to(torch.int8)
    new_err = _ftz(y - _ftz(q.float() * scale))
    return q, scale, new_err


def dequantize_int8(q, scale) -> torch.Tensor:
    return _ftz(q.float() * scale)


def compressed_psum_grads(grads: Sequence[Any], errs: Sequence[Any],
                          axis_name: str, mesh: Mesh
                          ) -> Tuple[List[Any], List[Any]]:
    """Mean of ``grads`` over ``axis_name`` of ``mesh`` with int8-EF
    transport.

    ``grads`` and ``errs`` have one pytree an entry of the axis (entry
    ``k``'s own gradients and carried errors), all congruent; returns
    ``(means, new_errs)``, one pytree an entry again.  Each leaf moves as
    (int8 payload, f32 scale) through two ``all_gather``s — 8/N the
    collective bytes of an f32 psum, so 4x fewer on the N=2 pod axis this
    is built for — and each entry rebuilds the mean from the dequantized
    rows, so the result differs from the exact mean by at most one
    quantization step (and the difference is what ``new_errs`` feeds
    back).  Every entry's mean is the same tensor, on entry 0's device.
    """
    n = mesh.shape[axis_name]
    if len(grads) != n or len(errs) != n:
        raise ValueError(f"compressed_psum_grads over {axis_name!r} takes one "
                         f"tree an entry ({n}), got {len(grads)} gradient "
                         f"and {len(errs)} error trees")
    flat = [tree_flatten_with_path(g) for g in grads]
    treedef = flat[0][1]
    leaves_g = [[leaf for _, leaf in f] for f, _ in flat]
    leaves_e = [[leaf for _, leaf in tree_flatten_with_path(e)[0]]
                for e in errs]
    if any(len(lg) != len(leaves_g[0]) for lg in leaves_g) or \
            any(len(le) != len(leaves_g[0]) for le in leaves_e):
        raise ValueError("compressed_psum_grads: gradient and error trees "
                         "are not congruent")
    means: List[torch.Tensor] = []
    new_errs: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for i in range(len(leaves_g[0])):
        coded = [ef_compress(leaves_g[k][i], leaves_e[k][i])
                 for k in range(n)]
        qg = all_gather(mesh, axis_name, [c[0] for c in coded])
        sg = all_gather(mesh, axis_name, [c[1] for c in coded])
        g = leaves_g[0][i]
        deq = _ftz(qg.float() * sg.reshape((-1,) + (1,) * g.dim()))
        total = deq[0]
        for row in deq[1:]:         # in entry order, the same on any device
            total = _ftz(total + row)
        means.append(_ftz(total / n))
        for k in range(n):
            new_errs[k].append(coded[k][2])
    mean_tree = tree_unflatten(treedef, means)
    return ([mean_tree] * n,
            [tree_unflatten(treedef, e) for e in new_errs])

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
