"""The packed reduction's parallel-phase round on the CPU: the port's
``gf2_scatter_xor`` (its plain version here) and ``gf2_find_low`` on
strided windows against the JAX package's dense ``gf2_parallel_xor`` and
``gf2_find_low`` (Pallas in interpret mode) and its numpy primitives, and
the rewired round (``_PackedBatch.xor_rows_kernels``) against the
reference's kernel path, on the same numpy inputs made from seeds.

Every result is exact: GF(2) adds and first-set-bit scans have one right
answer.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import build_filtration as ref_build
from repro.core import packed_reduce as rpr
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.data.pointclouds import clifford_torus as ref_torus
from repro.kernels import gf2 as jgf2
from repro_torch.core import packed_reduce as tpr
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core.pairing import EMPTY_KEY
from repro_torch.data.pointclouds import clifford_torus
from repro_torch.kernels import gf2 as tgf2


def _bits(arr):
    """uint32 numpy block -> int32 CPU tensor carrying the same bits."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _coords(rng, c, w, density, repeat):
    """Flat bit indices ``row * (w * 32) + rank`` at ``density`` of the
    block's bits, in random order; with ``repeat``, a third of them again
    (and some of those a third time)."""
    n_bits = c * w * 32
    flat = rng.choice(n_bits, size=int(density * n_bits), replace=False)
    if repeat and flat.size:
        again = rng.choice(flat, size=max(1, flat.size // 3))
        flat = np.concatenate([flat, again, again[::2]])
        rng.shuffle(flat)
    return flat.astype(np.int64)


def _odd(flat, w):
    """The coordinates given an odd number of times, as (row, rank) sorted
    by row and rank: the bits a GF(2) add flips."""
    u, counts = np.unique(flat, return_counts=True)
    u = u[counts % 2 == 1]
    return u // (w * 32), u % (w * 32)


# ---------------------------------------------------------------------------
# gf2_scatter_xor
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), c=st.sampled_from([1, 7, 40, 128]),
       w=st.sampled_from([1, 3, 128, 130]),
       density=st.sampled_from([0.0, 0.01, 0.11, 0.5]), repeat=st.booleans())
def test_scatter_xor_matches_reference_dense_xor(seed, c, w, density,
                                                 repeat):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    flat = _coords(rng, c, w, density, repeat)
    ridx, pos = _odd(flat, w)
    # the reference's dense addend block, packed from sorted key rows
    dense = jgf2.pack_keys_to_bits([pos[ridx == r] for r in range(c)],
                                   np.arange(w * 32, dtype=np.int64),
                                   n_words=w)
    pallas = np.asarray(jgf2.gf2_parallel_xor(
        jnp.asarray(rows), jnp.asarray(dense), interpret=True))
    host = rows.copy()
    jgf2.scatter_xor_bits(host, ridx, pos)
    np.testing.assert_array_equal(host, pallas)

    got = tgf2.gf2_scatter_xor_plain(_bits(rows), torch.from_numpy(flat))
    np.testing.assert_array_equal(_u32(got), pallas)
    # the wrapper on a CPU tensor: in place, int32 indices too
    t = _bits(rows)
    out = tgf2.gf2_scatter_xor(t, torch.from_numpy(flat.astype(np.int32)))
    assert out is t
    np.testing.assert_array_equal(_u32(t), pallas)


@pytest.mark.parametrize("times,flips", [(1, True), (2, False), (3, True),
                                         (4, False)])
def test_scatter_xor_repeated_coordinate_cancels(times, flips):
    rows = np.zeros((3, 2), dtype=np.uint32)
    flat = torch.tensor([1 * 64 + 37] * times + [5], dtype=torch.int64)
    got = _u32(tgf2.gf2_scatter_xor(_bits(rows), flat))
    want = np.zeros_like(rows)
    want[0, 0] = 1 << 5
    want[1, 1] = (1 << 5) if flips else 0
    np.testing.assert_array_equal(got, want)


def test_scatter_xor_rejects_bad_input():
    rows = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        tgf2.gf2_scatter_xor(rows, torch.tensor([2 * 3 * 32]))
    with pytest.raises(ValueError):
        tgf2.gf2_scatter_xor(rows, torch.tensor([-1]))
    with pytest.raises(TypeError):
        tgf2.gf2_scatter_xor(rows, torch.tensor([1.0]))
    with pytest.raises(TypeError):
        tgf2.gf2_scatter_xor(rows.to(torch.int64), torch.tensor([1]))
    with pytest.raises(ValueError):
        tgf2.gf2_scatter_xor(rows[0], torch.tensor([1]))
    with pytest.raises(ValueError, match="on the host"):
        tgf2.gf2_scatter_xor(rows, torch.tensor([1], device="meta"))


# ---------------------------------------------------------------------------
# gf2_find_low on a segment's window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 3, 128, 2176])
@pytest.mark.parametrize("off", [0, 128, 2176])
@pytest.mark.parametrize("c", [1, 31, 128])
def test_find_low_on_window_matches_reference(c, off, w):
    rng = np.random.default_rng(c * 7919 + off + w)
    block = np.zeros((c, off + w + 64), dtype=np.uint32)
    sub = (rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
           & rng.integers(0, 2**32, size=(c, w), dtype=np.uint32))
    first = rng.integers(0, w + 1, size=c)
    sub[np.arange(w)[None, :] < first[:, None]] = 0
    block[:, off:off + w] = sub
    block[:, :off] = 0xFFFFFFFF          # bits outside the window are not read
    block[:, off + w:] = 0xFFFFFFFF
    window = _bits(block)[:, off:off + w]
    assert c == 1 or not window.is_contiguous()
    want = jgf2.find_low_np(sub)
    pallas = np.asarray(jgf2.gf2_find_low(jnp.asarray(sub), interpret=True))
    np.testing.assert_array_equal(want, pallas)
    np.testing.assert_array_equal(tgf2.gf2_find_low(window).numpy(), want)
    out = torch.full((c,), -5, dtype=torch.int32)
    assert tgf2.gf2_find_low(window, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_find_low_rejects_bad_out():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        tgf2.gf2_find_low(cols, out=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tgf2.gf2_find_low(cols, out=torch.zeros(4, dtype=torch.int64))


# ---------------------------------------------------------------------------
# the rewired round
# ---------------------------------------------------------------------------

@pytest.fixture
def counted_rounds(monkeypatch):
    """Counts the calls of the port's kernel-path round."""
    calls = []
    real = tpr._PackedBatch.xor_rows_kernels

    def wrapped(self, packed_hit, ridx, pos):
        calls.append((len(packed_hit), len(self.segs)))
        return real(self, packed_hit, ridx, pos)

    monkeypatch.setattr(tpr._PackedBatch, "xor_rows_kernels", wrapped)
    return calls


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_round_matches_reference_kernel_path(counted_rounds, mode):
    """torus4 at n = 600, batch 256: rounds that append segments (then
    consolidate, as the kernel path always does) and rounds that evict
    rows, through the plain versions, against the reference's kernel path
    (Pallas interpret) and the port's host path."""
    pts = clifford_torus(600, seed=0)
    np.testing.assert_array_equal(pts, ref_torus(600, seed=0))
    rf, tf = ref_build(points=pts, tau_max=0.35), \
        build_filtration(points=pts, tau_max=0.35)
    cols = np.arange(tf.n_e - 1, -1, -1, dtype=np.int64)
    ref = rpr.reduce_dimension_packed(
        ref_h1_adapter(rf), cols, mode=mode, cleared=ref_h0(rf).death_edges,
        use_kernels=True, batch_size=256)
    kw = dict(mode=mode, cleared=compute_h0(tf).death_edges,
              batch_size=256, device="cpu")
    mine = tpr.reduce_dimension_packed(make_h1_adapter(tf), cols,
                                       use_kernels=True, **kw)
    host = tpr.reduce_dimension_packed(make_h1_adapter(tf), cols,
                                       use_kernels=False, **kw)
    assert counted_rounds, "the kernel-path round never ran"
    assert np.array_equal(ref.diagram(), mine.diagram())
    assert np.array_equal(host.diagram(), mine.diagram())
    np.testing.assert_array_equal(ref.pivot_lows, mine.pivot_lows)
    assert mine.stats["n_expansions"] > 0 and mine.stats["n_evictions"] > 0
    for k in ("n_reductions", "n_rounds", "n_consolidations", "n_evictions",
              "n_expansions", "n_pairs", "peak_block_bytes"):
        assert mine.stats[k] == ref.stats[k], k


def _append_segment(batch, words, keys):
    """Append ``keys`` as a segment without the kernel path's eager
    consolidation, as ``add_segment`` lays it out."""
    w = words(len(keys), batch.use_kernels)
    if batch.r_words + w > batch.cap:
        batch._grow_cap(batch.r_words + w)
    batch.segs.append(keys)
    batch.seg_off.append(batch.r_words)
    batch.r_words += w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_with_several_segments_matches_reference(seed):
    """A round with three segments alive (windows at word offsets 0, 128
    and 256 of the 128-word buckets): the port's round reads each window
    of the device copy, the reference builds the dense addend block and
    finds each window's low on the host's copy; blocks, lows and the peak
    account agree."""
    rng = np.random.default_rng(seed)
    B, K = 40, 6
    pool = np.sort(rng.choice(10**6, size=9000, replace=False)).astype(
        np.int64)
    cob = np.stack([np.sort(rng.choice(pool[:3000], size=K, replace=False))
                    for _ in range(B)])
    cob[::7, 3:] = EMPTY_KEY                   # short coboundaries
    cob[5] = EMPTY_KEY                          # an empty row
    seg1 = np.sort(rng.choice(pool[3000:6000], size=2000, replace=False))
    seg2 = np.sort(rng.choice(pool[6000:], size=300, replace=False))
    batches = []
    for mod, kw in ((tpr, dict(device=torch.device("cpu"))), (rpr, {})):
        b = mod._PackedBatch(cob, [], True, **kw)
        for keys in (seg1, seg2):
            _append_segment(b, mod._words, keys)
        batches.append(b)
    mine, ref = batches
    assert mine.seg_off == ref.seg_off == [0, 128, 256]
    # the same bits in the later segments of both blocks
    rows = rng.integers(0, B, size=500)
    segk = rng.integers(1, 3, size=500)
    rank = np.array([rng.integers(0, len((seg1, seg2)[s - 1])) for s in segk])
    pos = np.array(mine.seg_off)[segk] * 32 + rank
    order = np.lexsort((pos, rows))
    keep = np.ones(len(order), dtype=bool)
    keep[1:] = (rows[order][1:] != rows[order][:-1]) | \
        (pos[order][1:] != pos[order][:-1])
    for b in batches:
        jgf2.scatter_xor_bits(b.block, rows[order][keep], pos[order][keep])
    mine.refresh_lows(np.arange(B))
    ref.lows[:] = mine.lows
    universe = np.concatenate([mine.segs[0], seg1, seg2])
    hit = sorted(rng.choice(B, size=25, replace=False).tolist())
    addends = [None] * B
    for i in hit:
        addends[i] = np.sort(rng.choice(universe, size=int(
            rng.integers(1, 60)), replace=False))
    mine.xor_addends(hit, addends)
    ref.xor_addends(hit, addends)
    assert len(mine.segs) == 3 and mine.n_expansions == 0
    np.testing.assert_array_equal(mine.block, ref.block)
    np.testing.assert_array_equal(mine.lows, ref.lows)
    assert mine.peak_bytes == ref.peak_bytes
    assert (mine.lows[hit] >= 0).any()


def test_round_raises_for_an_addend_row_outside_the_hit_rows():
    """A coordinate whose row is not among the round's hit rows raises
    before anything reaches the block."""
    rng = np.random.default_rng(5)
    B, K = 8, 4
    cob = np.sort(rng.choice(10**4, size=(B, K), replace=False), axis=1)
    b = tpr._PackedBatch(cob.astype(np.int64), [], True,
                         device=torch.device("cpu"))
    block = b.block.copy()
    with pytest.raises(KeyError, match="not among the round's hit rows"):
        b.xor_rows_kernels([0, 2], np.array([0, 3, 2]), np.array([1, 2, 3]))
    np.testing.assert_array_equal(b.block, block)
