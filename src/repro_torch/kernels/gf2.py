"""Bit-packed GF(2) column reduction: CUDA kernels, plain versions, host
primitives.

Port of ``src/repro/kernels/gf2.py``.  The three Pallas TPU kernels become
hand-written CUDA for sm_90a in ``csrc/gf2.cu``:

* :func:`gf2_find_low` — per row, the index of the first set bit (the
  paper's ``low``), ``NO_LOW`` for an empty row (``_find_low_kernel``); it
  reads any row-strided view, such as one segment's window of a block;
* :func:`gf2_scatter_xor` — the parallel phase (``_parallel_xor_kernel``)
  as the packed reduction runs it: the gathered addend block, given as one
  flat bit index per set bit, XORed into the row block in place;
  :func:`gf2_parallel_xor` keeps the reference's dense form (a row block
  XOR an addend block of the same shape), off the reduction's path;
* :func:`gf2_serial_reduce` — per block, the in-order serial phase: while
  a row's low equals an earlier row's low, XOR the first such row in
  (``_serial_reduce_kernel``); :func:`serial_plan` picks its route from
  (C, W): the block in one thread block's shared memory, sliced across a
  thread-block cluster of up to 16, or in device memory beyond that.

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
``stack_wire_payloads`` / ``unstack_wire_payloads`` pack the pivot
exchange's per-shard payloads into one ``(P, L)`` buffer and back.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

NO_LOW = 2**31 - 1

_SIGNATURES = {
    "gf2_find_low": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p),
    "gf2_scatter_xor": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_void_p),
    "gf2_parallel_xor": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_void_p),
    "gf2_serial_reduce": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p),
}
_MAX_SERIAL_ROWS = 8192     # the serial kernel keeps C lows in shared memory
SMEM_PER_BLOCK = 232_448    # an H100 thread block's dynamic shared memory
MAX_CLUSTER = 16            # ranks a cluster (above 8: non-portable, allowed)


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


def stack_wire_payloads(payloads: Sequence[np.ndarray],
                        min_words: int = 1024):
    """Stack per-shard packed uint32 wire payloads into one ``(P, L)``
    collective buffer, ``L`` bucketed to a power of two.

    The distributed engine's pivot exchange gathers the buffer onto every
    mesh device (``repro_torch.core.packed_reduce._make_exchange``);
    bucketing ``L`` keeps the buffer at a handful of shapes instead of one
    per superstep, and ``min_words`` floors the bucket so early (small)
    rounds share one shape.  Returns ``(buf, lens)``;
    :func:`unstack_wire_payloads` crops the gather result back to the real
    payloads.
    """
    lens = [int(p.size) for p in payloads]
    L = max(int(min_words), max(lens, default=1))
    L = 1 << (L - 1).bit_length()
    buf = np.zeros((len(payloads), L), dtype=np.uint32)
    for k, p in enumerate(payloads):
        buf[k, :p.size] = p
    return buf, lens


def unstack_wire_payloads(gathered: np.ndarray,
                          lens: Sequence[int]) -> List[np.ndarray]:
    """Inverse of :func:`stack_wire_payloads` on the gathered ``(P, L)``
    buffer: every shard's payload, zero padding cropped."""
    out = np.asarray(gathered, dtype=np.uint32)
    return [out[k, :n] for k, n in enumerate(lens)]


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


def gf2_scatter_xor_plain(rows: torch.Tensor,
                          flat_bits: torch.Tensor) -> torch.Tensor:
    """XOR the bits at flat indices ``row * (W * 32) + rank`` into a (C, W)
    int32 bit block in place; returns ``rows``.  A coordinate given twice
    cancels: the parity of each coordinate's count decides its bit, so the
    words are assembled from distinct bits only and no sum carries."""
    C, W = rows.shape
    if not flat_bits.numel():
        return rows
    coords, counts = torch.unique(
        flat_bits.to(device=rows.device, dtype=torch.int64),
        return_counts=True)
    coords = coords[(counts & 1) == 1]
    words = torch.zeros(C * W, dtype=torch.int64, device=rows.device)
    words.index_add_(0, coords >> 5,
                     torch.ones_like(coords) << (coords & 31))
    # uint32 patterns back into int32's range, bit for bit
    words = torch.where(words >= 2**31, words - 2**32, words)
    rows.bitwise_xor_(words.to(torch.int32).view(C, W))
    return rows


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


def _check_contiguous(t: torch.Tensor, name: str) -> None:
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride in words of a 2-D view whose words lie contiguous within
    each row (a window ``block[:, off:off + w]``); raises for other
    strides."""
    C, W = t.shape
    if W > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: words within a row must be contiguous "
                         f"(strides {t.stride()})")
    ld = t.stride(0) if C > 1 else W
    if C > 1 and ld < W:
        raise ValueError(f"{name}: rows overlap (strides {t.stride()})")
    return ld


def _lib():
    return _build.library("gf2", _SIGNATURES)


def gf2_find_low(cols: torch.Tensor,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-set-bit index per row of a (C, W) int32 bit block -> (C,)
    int32, ``NO_LOW`` for an empty row.  Any C and W, and any view whose
    words are contiguous within each row (a segment's window of a wider
    block needs no copy); padding, where a caller wants fixed shapes, is
    the caller's.  ``out``, a contiguous (C,) int32 tensor on the same
    device, receives the lows where given."""
    _check_bits(cols, 2, "cols")
    C, W = cols.shape
    if out is None:
        out = torch.empty(C, dtype=torch.int32, device=cols.device)
    elif (out.shape != (C,) or out.dtype != torch.int32
          or out.device != cols.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({C},) int32 tensor on "
                         f"{cols.device}")
    if cols.device.type == "cpu":
        out.copy_(gf2_find_low_plain(cols))
        return out
    ld = _row_stride(cols, "cols")
    if C:
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = _lib().gf2_find_low(cols.data_ptr(), out.data_ptr(), C, W, ld,
                                  stream)
        gf2_find_low.launches += 1
        _build.check_launch(err, "gf2_find_low")
    return out


def gf2_scatter_xor(rows: torch.Tensor,
                    flat_bits: torch.Tensor) -> torch.Tensor:
    """Parallel-phase GF(2) add in place: XOR the gathered addend block,
    given as one flat index ``local_row * (W * 32) + bit_rank`` a set bit,
    into the (C, W) int32 bit block ``rows``; returns ``rows``.

    ``flat_bits`` is a 1-D int32 or int64 tensor on the host, whatever
    device ``rows`` lies on: it is range-checked there (an index outside the
    block raises ``ValueError``) and, for rows on a card, crosses in one
    copy from pinned memory, as int32 where ``C * W * 32 < 2**31`` and as
    int64 otherwise.  Repeated coordinates cancel; the order of the
    coordinates does not matter."""
    _check_bits(rows, 2, "rows")
    if flat_bits.dim() != 1 or flat_bits.dtype not in (torch.int32,
                                                       torch.int64):
        raise TypeError("flat_bits must be a 1-D int32 or int64 tensor, got "
                        f"{flat_bits.dtype} {tuple(flat_bits.shape)}")
    if flat_bits.device.type != "cpu":
        raise ValueError(f"flat_bits must be on the host, got "
                         f"{flat_bits.device}")
    C, W = rows.shape
    n_bits = C * W * 32
    n = flat_bits.numel()
    host = flat_bits.numpy()            # numpy's reductions cost less here
    if n:
        lo, hi = int(host.min()), int(host.max())
        if lo < 0 or hi >= n_bits:
            raise ValueError(f"flat_bits span [{lo}, {hi}], outside the "
                             f"block's {n_bits} bits")
    if rows.device.type == "cpu":
        return gf2_scatter_xor_plain(rows, flat_bits)
    ld = _row_stride(rows, "rows")
    if not n:
        return rows
    idx64 = n_bits >= 2**31
    staged = torch.empty(n, dtype=torch.int64 if idx64 else torch.int32,
                         pin_memory=True)
    np.copyto(staged.numpy(), host, casting="unsafe")
    flat_dev = staged.to(rows.device, non_blocking=True)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = _lib().gf2_scatter_xor(rows.data_ptr(), flat_dev.data_ptr(), n,
                                 int(idx64), W * 32, ld, stream)
    gf2_scatter_xor.launches += 1
    _build.check_launch(err, "gf2_scatter_xor")
    return rows


def gf2_parallel_xor(cols: torch.Tensor,
                     addends: torch.Tensor) -> torch.Tensor:
    """Parallel-phase GF(2) add in the reference's dense form: ``cols ^
    addends`` for two (C, W) int32 bit blocks, into a new tensor.  The
    packed reduction no longer calls it (it runs :func:`gf2_scatter_xor` on
    the addends' coordinates), so it launches 0 times on that path."""
    _check_bits(cols, 2, "cols")
    _check_bits(addends, 2, "addends")
    _check_contiguous(cols, "cols")
    _check_contiguous(addends, "addends")
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


class SerialPlan(NamedTuple):
    """How ``gf2_serial_reduce``'s kernel holds a (C, W) block: ``route``
    "smem" (the block in one thread block's shared memory, ``k`` = 1),
    "cluster" (``k`` ranks of a thread-block cluster, each holding words
    ``[r*S, r*S + S)`` of every row) or "global" (the rows in device memory,
    ``k`` = 0, ``S`` = 0); ``threads`` a thread block and the dynamic shared
    memory each takes."""
    route: str
    k: int
    S: int
    threads: int
    smem_bytes: int


def _serial_threads(words: int) -> int:
    """Threads of a rank holding ``words`` of a row: about one word each."""
    return 128 if words <= 128 else 256 if words <= 256 else 512


def _serial_header_bytes(C: int, k: int, threads: int) -> int:
    """Shared memory ahead of the table and the rows
    (``serial_header_bytes`` in ``csrc/gf2.cu``): the walk's lows (C padded
    to 32), the ranks' slice lows where k > 1, two buffers of k minima a
    warp; 16-byte rounded."""
    cp = -(-C // 32) * 32
    ints = cp * (2 if k > 1 else 1) + 2 * k * (threads // 32)
    return -(-ints * 4 // 16) * 16


def _serial_table_bytes(W: int) -> int:
    """The one-block route's table low -> row: W * 32 uint16 entries,
    16-byte rounded (``serial_table_bytes`` in ``csrc/gf2.cu``)."""
    return -(-W * 64 // 16) * 16


def serial_plan(C: int, W: int) -> SerialPlan:
    """The serial kernel's route for (C, W) blocks: the fewest ranks k whose
    slices of S words a row (a multiple of 4, so rows stay 16-byte aligned)
    fit ``SMEM_PER_BLOCK`` each, up to ``MAX_CLUSTER`` (k = 1 also holds the
    table low -> row); the global route beyond."""
    for k in range(1, MAX_CLUSTER + 1):
        S = -(-(-(-W // k)) // 4) * 4
        ranks = -(-W // S) if S else 1
        threads = _serial_threads(S)
        smem = (_serial_header_bytes(C, ranks, threads) + C * S * 4
                + (_serial_table_bytes(W) if ranks == 1 else 0))
        if smem <= SMEM_PER_BLOCK:
            return SerialPlan("smem" if ranks == 1 else "cluster", ranks, S,
                              threads, smem)
    return SerialPlan("global", 0, 0, 512, _serial_header_bytes(C, 1, 512))


def gf2_serial_reduce(blocks: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-block serial reduction of a (G, C, W) int32 batch.

    Returns (reduced (G, C, W), lows (G, C) int32, n_reductions (G,)
    int32).  Afterwards every block's non-empty rows have pairwise-distinct
    lows — the invariant the clearance step commits.  On a card the kernel
    takes the route of :func:`serial_plan`; a route that fails to launch
    raises."""
    _check_bits(blocks, 3, "blocks")
    _check_contiguous(blocks, "blocks")
    if blocks.device.type == "cpu":
        return gf2_serial_reduce_plain(blocks)
    G, C, W = blocks.shape
    if C > _MAX_SERIAL_ROWS:
        raise ValueError(f"C={C} exceeds the serial kernel's limit of "
                         f"{_MAX_SERIAL_ROWS} rows")
    if W * 32 >= NO_LOW:
        raise ValueError(f"W={W} words: bit indices reach NO_LOW")
    out = torch.empty_like(blocks)
    lows = torch.empty((G, C), dtype=torch.int32, device=blocks.device)
    reds = torch.empty(G, dtype=torch.int32, device=blocks.device)
    if G and C:
        plan = serial_plan(C, W)
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = _lib().gf2_serial_reduce(blocks.data_ptr(), out.data_ptr(),
                                       lows.data_ptr(), reds.data_ptr(),
                                       G, C, W, plan.k, plan.S, plan.threads,
                                       stream)
        gf2_serial_reduce.launches += 1
        _build.check_launch(err, f"gf2_serial_reduce ({plan.route}, "
                            f"k={plan.k})")
    elif G:
        reds.zero_()
    return out, lows, reds


gf2_find_low.launches = 0
gf2_scatter_xor.launches = 0
gf2_parallel_xor.launches = 0
gf2_serial_reduce.launches = 0
