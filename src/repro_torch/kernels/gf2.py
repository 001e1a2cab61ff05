"""Bit-packed GF(2) column reduction: CUDA kernels, plain versions, host
primitives.

Port of ``src/repro/kernels/gf2.py``.  The three Pallas TPU kernels become
hand-written CUDA for sm_90a in ``csrc/gf2.cu``:

* :func:`gf2_find_low` — per row, the index of the first set bit (the
  paper's ``low``), ``NO_LOW`` for an empty row (``_find_low_kernel``);
* :func:`gf2_parallel_xor` — elementwise XOR of a row block with the
  gathered addend block, the parallel phase (``_parallel_xor_kernel``);
* :func:`gf2_serial_reduce` — per block, the in-order serial phase: while
  a row's low equals an earlier row's low, XOR the first such row in
  (``_serial_reduce_kernel``).

Blocks are ``torch.int32`` tensors carrying the uint32 bit patterns (torch
on the CPU has no ``~``, unary ``-`` or ``>>`` for ``torch.uint32``); the
CUDA code reads them as ``uint32_t``.  Each wrapper runs its kernel for a
CUDA tensor and its plain PyTorch version (``*_plain``, same module) for a
CPU tensor; a CUDA tensor it cannot take raises.  ``<wrapper>.launches``
counts kernel launches.

The host-side rank-compression primitives (numpy, as in the reference)
live here too: key ``universe[i]`` maps to bit ``i`` (word ``i >> 5``, bit
``i & 31``), so ascending keys are ascending bit indices and the first set
bit *is* the engines' ``low``.  The packed engine moves between key arrays
and bit blocks with ``scatter_bits`` / ``scatter_xor_bits`` /
``set_bit_positions`` (plus ``find_low_np``); ``pack_keys_to_bits`` /
``bits_to_keys`` are the whole-block forms of the same mapping.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

NO_LOW = 2**31 - 1

_SIGNATURES = {
    "gf2_find_low": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p),
    "gf2_parallel_xor": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_void_p),
    "gf2_serial_reduce": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p),
}
_MAX_SERIAL_ROWS = 8192     # the serial kernel keeps C lows in shared memory


# ---------------------------------------------------------------------------
# Host-side bit packing (rank compression into the block bit-space)
# ---------------------------------------------------------------------------

def pack_keys_to_bits(rows: Sequence[np.ndarray], universe: np.ndarray,
                      n_words: Optional[int] = None) -> np.ndarray:
    """Pack sorted int64 key rows into a (B, W) uint32 bit block.

    ``universe`` is the sorted unique key array of the compressed bit-space;
    every key of every row must be present in it.  Key ``universe[i]`` maps
    to bit ``i`` (word ``i >> 5``, bit ``i & 31``) — ascending keys become
    ascending bit indices, so ``gf2_find_low`` on the packed block returns
    the rank of each row's minimum key.  ``n_words`` widens the block (extra
    zero words) so callers can append augmentation bits.
    """
    W = max(1, (len(universe) + 31) // 32)
    if n_words is not None:
        W = max(W, int(n_words))
    B = len(rows)
    packed = np.zeros((B, W), dtype=np.uint32)
    lens = np.array([len(r) for r in rows], dtype=np.int64)
    if lens.sum() == 0:
        return packed
    keys = np.concatenate([np.asarray(r, dtype=np.int64) for r in rows])
    ridx = np.repeat(np.arange(B, dtype=np.int64), lens)
    pos = np.searchsorted(universe, keys)
    scatter_bits(packed, ridx, pos)
    return packed


def _scatter_groups(block: np.ndarray, ridx: np.ndarray, pos: np.ndarray):
    """Shared grouping for the bit scatters: flat word indices + per-word
    bit sums.

    ``pos`` must be ascending within each row and each (row, rank) pair
    unique — then the flat word index is globally sorted, distinct bits of
    one word sum without carries, and the whole grouping is one
    ``add.reduceat`` over the nnz coordinates (no full-width buffer, unlike
    ``bincount``; no per-element loop, unlike ``ufunc.at``)."""
    W = block.shape[1]
    word = ridx * W + (pos >> 5)
    val = np.uint32(1) << (pos & 31).astype(np.uint32)
    first = np.empty(len(word), dtype=bool)
    first[0] = True
    np.not_equal(word[1:], word[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    return word[starts], np.add.reduceat(val, starts)


def scatter_bits(block: np.ndarray, ridx: np.ndarray,
                 pos: np.ndarray) -> None:
    """OR bits at ``(row, bit-rank)`` coordinates into a uint32 block
    (packing into fresh/zero words; see :func:`_scatter_groups` for the
    coordinate contract)."""
    if not pos.size:
        return
    idx, sums = _scatter_groups(block, ridx, pos)
    block.reshape(-1)[idx] |= sums


def scatter_xor_bits(block: np.ndarray, ridx: np.ndarray,
                     pos: np.ndarray) -> None:
    """XOR bits at ``(row, bit-rank)`` coordinates into a uint32 block —
    the in-place GF(2) column add of the packed engine's parallel phase
    (same coordinate contract as :func:`scatter_bits`)."""
    if not pos.size:
        return
    idx, sums = _scatter_groups(block, ridx, pos)
    block.reshape(-1)[idx] ^= sums


def set_bit_positions(block: np.ndarray):
    """Set-bit coordinates of a (B, W) uint32 block, word-granular.

    Returns ``(ridx, pos, counts)`` — row index and bit rank of every set
    bit (ascending rank within each row) and the per-row set-bit counts.
    Only the non-zero *words* are expanded to bits, so sparse blocks cost
    ``O(B·W)`` word scans plus ``O(32·nnz_words)``, not ``O(32·B·W)``.
    """
    block = np.ascontiguousarray(block, dtype=np.uint32)
    B, _ = block.shape
    rw, cw = np.nonzero(block)
    words = block[rw, cw]
    bits = np.unpackbits(words.view(np.uint8).reshape(-1, 4),
                         axis=1, bitorder="little")
    m, b = np.nonzero(bits)
    ridx = rw[m]
    pos = cw[m] * 32 + b
    counts = np.bincount(ridx, minlength=B).astype(np.int64)
    return ridx, pos, counts


def bits_to_keys(block: np.ndarray, universe: np.ndarray) -> List[np.ndarray]:
    """Inverse of :func:`pack_keys_to_bits`: bit block -> sorted key rows.

    Bits at rank >= len(universe) (augmentation words) are ignored.
    """
    ridx, pos, counts = set_bit_positions(block)
    keep = pos < len(universe)
    if not keep.all():
        counts = np.bincount(ridx[keep],
                             minlength=block.shape[0]).astype(np.int64)
        pos = pos[keep]
    return np.split(universe[pos], np.cumsum(counts)[:-1])


def find_low_np(block: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`gf2_find_low` (host fast path): first-set-bit
    rank per row of a (B, W) uint32 block; NO_LOW for all-zero rows.

    Word-granular like the kernel: first non-zero word by argmax, then the
    isolated lowest set bit's exponent via ``frexp`` (exact for powers of
    two) — no per-bit expansion of the block.
    """
    block = np.asarray(block, dtype=np.uint32)
    B, _ = block.shape
    nzw = block != 0
    any_set = nzw.any(axis=1)
    w = nzw.argmax(axis=1)
    words = block[np.arange(B), w].astype(np.int64)
    lsb = (words & -words).astype(np.float64)
    bit = np.frexp(lsb)[1] - 1
    return np.where(any_set, w * 32 + bit, NO_LOW).astype(np.int32)


# ---------------------------------------------------------------------------
# numpy <-> tensor hand-off
# ---------------------------------------------------------------------------

def to_tensor(block: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 numpy block as an int32 tensor on ``device`` (same bits)."""
    arr = np.ascontiguousarray(block, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 bit tensor back as a uint32 numpy block (same bits)."""
    return t.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as non-negative int64 words."""
    return t.to(torch.int64) & 0xFFFFFFFF


def gf2_find_low_plain(cols: torch.Tensor) -> torch.Tensor:
    """First-set-bit index per row of a (C, W) int32 bit block; NO_LOW for
    an empty row.  Word-granular: the first non-zero word, then the
    exponent of its isolated lowest bit."""
    C, W = cols.shape
    words = _u32(cols)
    if W == 0:
        return torch.full((C,), NO_LOW, dtype=torch.int32, device=cols.device)
    nz = words != 0
    any_nz = nz.any(dim=1)
    w = nz.to(torch.int8).argmax(dim=1)
    word = words.gather(1, w[:, None])[:, 0]
    lsb = word & -word
    pow2 = torch.ones(32, dtype=torch.int64, device=cols.device) << \
        torch.arange(32, dtype=torch.int64, device=cols.device)
    bit = (lsb[:, None] == pow2[None, :]).to(torch.int8).argmax(dim=1)
    low = w * 32 + bit
    return torch.where(any_nz, low, torch.full_like(low, NO_LOW)).to(
        torch.int32)


def gf2_parallel_xor_plain(cols: torch.Tensor,
                           addends: torch.Tensor) -> torch.Tensor:
    """Elementwise XOR of two (C, W) int32 bit blocks."""
    return torch.bitwise_xor(cols, addends)


def gf2_serial_reduce_plain(blocks: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The standard column algorithm restricted to each (C, W) block of a
    (G, C, W) int32 batch: returns (reduced, lows (G, C), n_red (G,))."""
    G, C, _ = blocks.shape
    out = blocks.clone()
    lows = torch.full((G, C), NO_LOW, dtype=torch.int32, device=blocks.device)
    reds = torch.zeros(G, dtype=torch.int32, device=blocks.device)
    for g in range(G):
        n_red = 0
        for c in range(C):
            low = int(gf2_find_low_plain(out[g, c:c + 1])[0])
            while low != NO_LOW:
                hit = torch.nonzero(lows[g, :c] == low)
                if hit.numel() == 0:
                    break
                j = int(hit[0, 0])
                out[g, c] ^= out[g, j]
                n_red += 1
                low = int(gf2_find_low_plain(out[g, c:c + 1])[0])
            lows[g, c] = low
        reds[g] = n_red
    return out, lows, reds


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_bits(t: torch.Tensor, ndim: int, name: str) -> None:
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 bit patterns, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    return _build.library("gf2", _SIGNATURES)


def gf2_find_low(cols: torch.Tensor) -> torch.Tensor:
    """First-set-bit index per row of a (C, W) int32 bit block -> (C,)
    int32, ``NO_LOW`` for an empty row.  Any C and W: padding rows or
    words, where a caller wants fixed shapes, is the caller's."""
    _check_bits(cols, 2, "cols")
    if cols.device.type == "cpu":
        return gf2_find_low_plain(cols)
    C, W = cols.shape
    lows = torch.empty(C, dtype=torch.int32, device=cols.device)
    if C:
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = _lib().gf2_find_low(cols.data_ptr(), lows.data_ptr(), C, W,
                                  stream)
        gf2_find_low.launches += 1
        _build.check_launch(err, "gf2_find_low")
    return lows


def gf2_parallel_xor(cols: torch.Tensor,
                     addends: torch.Tensor) -> torch.Tensor:
    """Parallel-phase GF(2) add: ``cols ^ addends`` for two (C, W) int32 bit
    blocks, into a new tensor."""
    _check_bits(cols, 2, "cols")
    _check_bits(addends, 2, "addends")
    if cols.shape != addends.shape or cols.device != addends.device:
        raise ValueError(f"cols {tuple(cols.shape)} on {cols.device} vs "
                         f"addends {tuple(addends.shape)} on "
                         f"{addends.device}")
    if cols.device.type == "cpu":
        return gf2_parallel_xor_plain(cols, addends)
    out = torch.empty_like(cols)
    n = cols.numel()
    if n:
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = _lib().gf2_parallel_xor(cols.data_ptr(), addends.data_ptr(),
                                      out.data_ptr(), n, stream)
        gf2_parallel_xor.launches += 1
        _build.check_launch(err, "gf2_parallel_xor")
    return out


def gf2_serial_reduce(blocks: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-block serial reduction of a (G, C, W) int32 batch.

    Returns (reduced (G, C, W), lows (G, C) int32, n_reductions (G,)
    int32).  Afterwards every block's non-empty rows have pairwise-distinct
    lows — the invariant the clearance step commits."""
    _check_bits(blocks, 3, "blocks")
    if blocks.device.type == "cpu":
        return gf2_serial_reduce_plain(blocks)
    G, C, W = blocks.shape
    if C > _MAX_SERIAL_ROWS:
        raise ValueError(f"C={C} exceeds the serial kernel's limit of "
                         f"{_MAX_SERIAL_ROWS} rows")
    out = torch.empty_like(blocks)
    lows = torch.empty((G, C), dtype=torch.int32, device=blocks.device)
    reds = torch.empty(G, dtype=torch.int32, device=blocks.device)
    if G:
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = _lib().gf2_serial_reduce(blocks.data_ptr(), out.data_ptr(),
                                       lows.data_ptr(), reds.data_ptr(),
                                       G, C, W, stream)
        gf2_serial_reduce.launches += 1
        _build.check_launch(err, "gf2_serial_reduce")
    return out, lows, reds


gf2_find_low.launches = 0
gf2_parallel_xor.launches = 0
gf2_serial_reduce.launches = 0
