"""The serial kernel's design on the CPU: the launcher's route choice
(``repro_torch.kernels.gf2.serial_plan``) and a numpy model of the walk
``csrc/gf2.cu``'s ``gf2_serial_reduce_kernel`` runs, bit-exact against the
JAX package's oracle (``repro.kernels.ref.gf2_serial_reduce_ref``) and its
Pallas kernel in interpret mode.

The model keeps the kernel's structure: the row words split into k rank
slices of S words (k = 0: the global route, one slice of W); initial lows
as the minimum of the slices' first bits; the walk 32 rows at a time, a
lane a row, a lane colliding with a final row below its group or with an
earlier lane; each reduction an XOR from the low's word within each slice
and the slices' first bits combined by min.  It asserts the kernel's
premise that a low has at most one final row.  Every result is exact.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.kernels import gf2 as jgf2
from repro.kernels import ref as kref
from repro_torch.kernels import gf2 as tgf2
from repro_torch.kernels.gf2 import (MAX_CLUSTER, NO_LOW, SMEM_PER_BLOCK,
                                     serial_plan)

CSRC = Path(tgf2.__file__).resolve().parent / "csrc" / "gf2.cu"


# ---------------------------------------------------------------------------
# the launcher's route
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(128, 256), (128, 2176), (128, 128), (128, 600), (128, 3500),
               (128, 7000), (128, 8000), (96, 4), (32, 1), (1, 1), (128, 0),
               (45, 13), (8192, 1), (8192, 8), (8192, 64), (8192, 2176),
               (64, 100_000), (2, 58_112), (300, 1_000)]


def _fits(C: int, W: int, k: int) -> bool:
    S = -(-(-(-W // k)) // 4) * 4
    ranks = -(-W // S) if S else 1
    table = tgf2._serial_table_bytes(W) if ranks == 1 else 0
    return (tgf2._serial_header_bytes(C, ranks, tgf2._serial_threads(S))
            + table + C * S * 4) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("C,W", PLAN_SHAPES)
def test_serial_plan_covers_the_row_and_fits(C, W):
    p = serial_plan(C, W)
    if p.route == "global":
        assert (p.k, p.S, p.threads) == (0, 0, 512)
        assert not any(_fits(C, W, k) for k in range(1, MAX_CLUSTER + 1))
        assert p.smem_bytes <= SMEM_PER_BLOCK
        return
    assert p.route == ("smem" if p.k == 1 else "cluster")
    assert 1 <= p.k <= MAX_CLUSTER
    assert p.S % 4 == 0
    assert p.k * p.S >= W                       # the slices cover the row
    assert W == 0 or (p.k - 1) * p.S < W        # and no rank is empty
    assert p.threads == tgf2._serial_threads(p.S)
    table = tgf2._serial_table_bytes(W) if p.k == 1 else 0
    assert p.smem_bytes == (tgf2._serial_header_bytes(C, p.k, p.threads)
                            + table + C * p.S * 4)
    assert p.smem_bytes <= SMEM_PER_BLOCK
    assert not any(_fits(C, W, k) for k in range(1, p.k))   # fewest ranks


@pytest.mark.parametrize("C,W,route,k", [
    (128, 256, "smem", 1),      # the path's narrow pre-pass block
    (128, 2176, "cluster", 5),  # the path's wide one
    (128, 600, "cluster", 2), (128, 3500, "cluster", 8),
    (128, 7000, "cluster", 16), (128, 8000, "global", 0),
])
def test_serial_plan_routes_of_the_card_tests(C, W, route, k):
    """The shapes tests/test_torch_cuda.py and chip_smoke.py launch each
    route with."""
    p = serial_plan(C, W)
    assert (p.route, p.k) == (route, k)


def test_serial_header_mirrors_the_kernel():
    """_serial_header_bytes and _serial_table_bytes are the layout the
    kernel carves out: lows (C padded to 32), slice lows where k > 1, two
    k-by-warps minima buffers; for k = 1 a uint16 table of W * 32 rows."""
    src = CSRC.read_text()
    body = src[src.index("serial_header_bytes(int C"):]
    body = body[:body.index("}")]
    assert "(C + 31) & ~31" in body
    assert "cp * (k > 1 ? 2 : 1) + 2 * (size_t)k * warps" in body
    assert "(ints * sizeof(int) + 15) & ~(size_t)15" in body
    body = src[src.index("serial_table_bytes(int W"):]
    body = body[:body.index("}")]
    assert "(size_t)W * 32 * sizeof(uint16_t) + 15) & ~(size_t)15" in body
    assert tgf2._serial_header_bytes(45, 1, 128) == (64 + 8) * 4
    assert tgf2._serial_header_bytes(128, 5, 512) == (256 + 160) * 4
    assert tgf2._serial_header_bytes(1, 3, 32) == 288   # 70 ints, 16-rounded
    assert tgf2._serial_header_bytes(1, 1, 32) == 144   # 34 ints, 16-rounded
    assert tgf2._serial_table_bytes(256) == 16384
    assert tgf2._serial_table_bytes(13) == 832


_C_TO_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
                "int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("name", sorted(tgf2._SIGNATURES))
def test_ctypes_signatures_match_the_c_entry_points(name):
    src = CSRC.read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, name
    params = [re.sub(r"\s+", " ", p).strip() for p in m.group(1).split(",")]
    types = [_C_TO_CTYPES[p.rsplit(" ", 1)[0].replace(" *", "*")]
             for p in params]
    assert types == list(tgf2._SIGNATURES[name])


# ---------------------------------------------------------------------------
# the numpy model of the kernel's walk
# ---------------------------------------------------------------------------

def _first_bit(row: np.ndarray, lo: int, hi: int) -> int:
    nz = np.flatnonzero(row[lo:hi])
    if not nz.size:
        return NO_LOW
    w = lo + int(nz[0])
    v = int(row[w])
    return w * 32 + (v & -v).bit_length() - 1


def sliced_walk(blocks: np.ndarray, k: int, S: int):
    """(reduced, lows, n_reductions) of a (G, C, W) uint32 batch as the
    kernel computes them with k ranks of S words (k = 0: one of W)."""
    out = np.array(blocks, dtype=np.uint32, copy=True)
    G, C, W = out.shape
    slices = ([(0, W)] if k == 0 else
              [(r * S, min(W, r * S + S)) for r in range(k)])
    lows_out = np.full((G, C), NO_LOW, dtype=np.int32)
    reds = np.zeros(G, dtype=np.int32)
    for g in range(G):
        rows = out[g]

        def low_of(c: int, from_word: int = 0) -> int:
            # each rank's first bit in its slice, combined by min
            return min([_first_bit(rows[c], max(lo, from_word), hi)
                        for lo, hi in slices if hi > max(lo, from_word)],
                       default=NO_LOW)

        lows = [low_of(c) for c in range(C)]
        n_red = 0
        for base in range(0, C, 32):
            L = [lows[base + i] if base + i < C else NO_LOW
                 for i in range(32)]
            H = []
            for i in range(32):
                below = [j for j in range(base)
                         if L[i] != NO_LOW and lows[j] == L[i]]
                assert len(below) <= 1
                H.append(below[0] if below else -1)
            pos = 0
            while True:
                hit = [i >= pos and L[i] != NO_LOW
                       and (H[i] >= 0 or L[i] in L[:i]) for i in range(32)]
                if not any(hit):
                    break
                f = hit.index(True)
                R, low = base + f, L[f]
                j = H[f] if H[f] >= 0 else base + L[:f].index(low)
                while True:
                    w0 = low >> 5
                    for lo, hi in slices:        # each rank its own words
                        a = max(lo, w0)
                        rows[R, a:hi] ^= rows[j, a:hi]
                    low = low_of(R, w0)
                    n_red += 1
                    mates = ([t for t in range(base) if lows[t] == low]
                             + [base + i for i in range(f) if L[i] == low]
                             if low != NO_LOW else [])
                    assert len(mates) <= 1
                    if not mates:
                        break
                    j = mates[0]
                L[f], H[f], pos = low, -1, f + 1
            for i in range(min(32, C - base)):
                lows[base + i] = L[i]
        lows_out[g] = lows
        reds[g] = n_red
    return out, lows_out, reds


def prepass_blocks(rng, G: int, C: int, W: int, planted: int,
                   vtail: bool = True, copies: int = 0) -> np.ndarray:
    """Blocks laid out as the packed engine's serial pre-pass sends them:
    R words whose lows spread over the row, ``planted`` rows given an
    earlier row's words up to its low (a collision), ``copies`` rows given
    an earlier row's whole R part (emptied by the XOR, or left with V bits
    only), some R parts empty, and V identity bits at the tail."""
    vw = (C + 31) // 32 if vtail else 0
    cap = W - vw
    assert cap >= 1
    out = np.zeros((G, C, W), dtype=np.uint32)
    for g in range(G):
        r = (rng.integers(0, 2**32, size=(C, cap), dtype=np.uint32)
             & rng.integers(0, 2**32, size=(C, cap), dtype=np.uint32))
        first = rng.integers(0, cap, size=C)
        r[np.arange(cap)[None, :] < first[:, None]] = 0
        r[np.arange(C), first] |= np.uint32(1) << rng.integers(
            0, 32, size=C).astype(np.uint32)
        r[::9] = 0
        for _ in range(planted if C > 1 else 0):
            i = int(rng.integers(1, C))
            j = int(rng.integers(0, i))
            r[i, :first[j] + 1] = r[j, :first[j] + 1]
        for _ in range(copies if C > 1 else 0):
            i = int(rng.integers(1, C))
            r[i] = r[int(rng.integers(0, i))]
        out[g, :, :cap] = r
        if vtail:
            rows = np.arange(C)
            out[g, rows, cap + (rows >> 5)] = (np.uint32(1) << (
                rows & 31).astype(np.uint32))
    return out


def _check_against_reference(blocks, got, pallas=True):
    exp_b, exp_l, exp_r = kref.gf2_serial_reduce_ref(blocks)
    red, lows, reds = got
    np.testing.assert_array_equal(red, exp_b)
    np.testing.assert_array_equal(lows, exp_l)
    np.testing.assert_array_equal(reds, exp_r)
    if pallas:
        pb, pl, pr = jgf2.gf2_serial_reduce(jnp.asarray(blocks),
                                            interpret=True)
        np.testing.assert_array_equal(red, np.asarray(pb))
        np.testing.assert_array_equal(lows, np.asarray(pl))
        np.testing.assert_array_equal(reds, np.asarray(pr))
    return int(exp_r.sum())


# (G, C, W, planted, copies, vtail, slicings): slicings are (k, S) pairs
# beside serial_plan's own; k = 0 is the global route.
WALK_CASES = [
    pytest.param(1, 128, 12, 40, 0, True, [(3, 4), (0, 0)],
                 id="planted-collisions"),
    pytest.param(1, 64, 9, 10, 24, False, [(2, 8), (0, 0)],
                 id="rows-emptied"),
    pytest.param(1, 70, 6, 20, 30, True, [(2, 4), (6, 1)],
                 id="lows-in-the-v-tail"),
    pytest.param(1, 45, 8, 20, 4, True, [(2, 4), (16, 4)],
                 id="c-not-a-multiple-of-32"),
    pytest.param(2, 40, 8, 16, 4, True, [(2, 4), (0, 0)], id="g-2"),
    pytest.param(2, 33, 13, 16, 4, True, [(4, 4), (3, 5), (0, 0)],
                 id="w-not-a-multiple-of-4"),
]


@pytest.mark.parametrize("G,C,W,planted,copies,vtail,slicings", WALK_CASES)
def test_sliced_walk_matches_reference_and_pallas(G, C, W, planted, copies,
                                                  vtail, slicings):
    rng = np.random.default_rng(C * 1000 + W)
    blocks = prepass_blocks(rng, G, C, W, planted, vtail, copies)
    plan = serial_plan(C, W)
    n_red = None
    for k, S in [(plan.k, plan.S)] + slicings:
        got = sliced_walk(blocks, k, S)
        n = _check_against_reference(blocks, got, pallas=n_red is None)
        n_red = n
    assert n_red > 0
    # the port's plain version, the kernel's yardstick on the card
    red, lows, reds = tgf2.gf2_serial_reduce(
        torch.from_numpy(blocks.view(np.int32).copy()))
    np.testing.assert_array_equal(red.numpy().view(np.uint32),
                                  sliced_walk(blocks, plan.k, plan.S)[0])


def test_sliced_walk_reaches_the_v_tail():
    """Rows whose R words an XOR clears end with their low in the V words,
    where an earlier row's low may be again."""
    rng = np.random.default_rng(5)
    C, W = 70, 6
    blocks = prepass_blocks(rng, 1, C, W, 20, True, 30)
    got = sliced_walk(blocks, 2, 4)
    first = tgf2.find_low_np(blocks[0])
    vbits = (W - 3) * 32
    moved = (first < vbits) & (got[1][0] >= vbits) & (got[1][0] != NO_LOW)
    assert moved.sum() >= 2
    _check_against_reference(blocks, got, pallas=False)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 2), st.integers(1, 80), st.integers(1, 24),
       st.integers(0, 16), st.integers(0, 2**31 - 1))
def test_sliced_walk_hypothesis(G, C, W, k, seed):
    rng = np.random.default_rng(seed)
    vtail = W > (C + 31) // 32
    blocks = prepass_blocks(rng, G, C, W, int(rng.integers(0, C + 1)),
                            vtail, int(rng.integers(0, C // 4 + 1)))
    S = 0 if k == 0 else -(-W // k)
    _check_against_reference(blocks, sliced_walk(blocks, k, S),
                             pallas=False)
