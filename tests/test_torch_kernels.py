"""Port kernels on the CPU: each plain PyTorch version against the JAX
package's oracle (``repro.kernels.ref``) and its Pallas kernel in interpret
mode, and the host bit primitives against ``repro.kernels.gf2``'s, on the
same numpy inputs made from seeds.

Tolerances: pairwise ``rtol=1e-5, atol=1e-4`` (float32 sums in another
order, unit-scale data, as ``tests/test_kernels.py`` holds the Pallas
kernel); every GF(2) result exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import gf2 as jgf2
from repro.kernels import ops as jops
from repro.kernels import ref as kref
from repro.kernels.pairwise_dist import pairwise_sq_dists as jax_pairwise
from repro_torch.kernels import gf2 as tgf2
from repro_torch.kernels import ops as tops
from repro_torch.kernels.pairwise_dist import (pairwise_sq_dists,
                                               pairwise_sq_dists_plain)


def _bits(arr):
    """uint32 numpy block -> int32 CPU tensor carrying the same bits."""
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# pairwise_sq_dists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d,block", [
    (256, 256, 3, 128), (128, 256, 9, 128), (256, 128, 4, 64),
    (512, 256, 16, 256), (77, 45, 4, 64),
])
def test_pairwise_plain_matches_reference_and_pallas(m, n, d, block):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, d)).astype(np.float32)
    y = rng.normal(size=(n, d)).astype(np.float32)
    got = pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(
        got, pairwise_sq_dists_plain(torch.from_numpy(x),
                                     torch.from_numpy(y)).numpy())
    expect = np.asarray(kref.pairwise_sq_dists_ref(jnp.asarray(x),
                                                   jnp.asarray(y)))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-4)
    pallas = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(y),
                                     block_m=block, block_n=block,
                                     interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-4)
    assert got.shape == (m, n) and got.dtype == np.float32
    assert (got >= 0).all()


def test_pairwise_wrapper_rejects_bad_shapes():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        pairwise_sq_dists(x, torch.zeros((4, 2)))
    with pytest.raises(ValueError):
        pairwise_sq_dists(x[0], x)


# ---------------------------------------------------------------------------
# GF(2) kernels: plain versions vs oracle + Pallas interpret
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,w", [(128, 8), (256, 64), (128, 1), (37, 130)])
def test_find_low_plain(c, w):
    rng = np.random.default_rng(3)
    cols = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    cols[::7] = 0                             # some empty rows
    cols[1::5, : w // 2] = 0                  # lows deep in the row
    got = tgf2.gf2_find_low(_bits(cols)).numpy()
    np.testing.assert_array_equal(got, kref.gf2_find_low_ref(cols))
    np.testing.assert_array_equal(got, jgf2.find_low_np(cols))
    pallas = np.asarray(jgf2.gf2_find_low(jnp.asarray(cols), block_c=128,
                                          interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32


@pytest.mark.parametrize("seed", range(6))
def test_find_low_plain_sparse_rows(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.integers(1, 16))
    cols = (rng.integers(0, 2**32, size=(64, w), dtype=np.uint32)
            * rng.integers(0, 2, size=(64, w), dtype=np.uint32))
    np.testing.assert_array_equal(tgf2.gf2_find_low(_bits(cols)).numpy(),
                                  kref.gf2_find_low_ref(cols))


def test_find_low_plain_high_bit():
    """Bit 31 set (a negative int32 pattern) and single-bit rows."""
    cols = np.zeros((33, 3), dtype=np.uint32)
    for i in range(32):
        cols[i, 1] = np.uint32(1) << np.uint32(i)
    cols[32, 2] = np.uint32(0x80000000)
    np.testing.assert_array_equal(tgf2.gf2_find_low(_bits(cols)).numpy(),
                                  kref.gf2_find_low_ref(cols))


@pytest.mark.parametrize("c,w", [(8, 4), (128, 16), (130, 3)])
def test_parallel_xor_plain(c, w):
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    got = _u32(tgf2.gf2_parallel_xor(_bits(a), _bits(b)))
    np.testing.assert_array_equal(got, a ^ b)
    pallas = np.asarray(jgf2.gf2_parallel_xor(jnp.asarray(a), jnp.asarray(b),
                                              interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("g,c,w", [(1, 8, 4), (2, 16, 8), (4, 32, 2),
                                   (1, 40, 5)])
def test_serial_reduce_plain(g, c, w):
    rng = np.random.default_rng(4)
    # sparse-ish random rows so collisions actually happen
    blocks = (rng.integers(0, 2**32, size=(g, c, w), dtype=np.uint32)
              & rng.integers(0, 2**32, size=(g, c, w), dtype=np.uint32)
              & rng.integers(0, 2**32, size=(g, c, w), dtype=np.uint32))
    red, lows, reds = tgf2.gf2_serial_reduce(_bits(blocks))
    exp_b, exp_l, exp_r = kref.gf2_serial_reduce_ref(blocks)
    np.testing.assert_array_equal(_u32(red), exp_b)
    np.testing.assert_array_equal(lows.numpy(), exp_l)
    np.testing.assert_array_equal(reds.numpy(), exp_r)
    pb, pl, pr = jgf2.gf2_serial_reduce(jnp.asarray(blocks), interpret=True)
    np.testing.assert_array_equal(_u32(red), np.asarray(pb))
    np.testing.assert_array_equal(lows.numpy(), np.asarray(pl))
    np.testing.assert_array_equal(reds.numpy(), np.asarray(pr))
    assert int(reds.sum()) > 0


def test_serial_reduce_plain_planted_collisions():
    """Rows with equal lows by construction (the V-word layout of the
    packed engine's pre-pass: identity bits at the tail)."""
    rng = np.random.default_rng(9)
    C, W = 24, 6
    blocks = np.zeros((1, C, W), dtype=np.uint32)
    for c in range(C):
        blocks[0, c, 0] = np.uint32(1) << np.uint32(c % 5)
        blocks[0, c, 1:4] = rng.integers(0, 2**32, size=3, dtype=np.uint32)
        blocks[0, c, 4 + (c >> 5)] = np.uint32(1) << np.uint32(c & 31)
    red, lows, reds = tgf2.gf2_serial_reduce(_bits(blocks))
    exp_b, exp_l, exp_r = kref.gf2_serial_reduce_ref(blocks)
    np.testing.assert_array_equal(_u32(red), exp_b)
    np.testing.assert_array_equal(lows.numpy(), exp_l)
    np.testing.assert_array_equal(reds.numpy(), exp_r)


def test_gf2_wrappers_reject_bad_input():
    with pytest.raises(TypeError):
        tgf2.gf2_find_low(torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        tgf2.gf2_serial_reduce(torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tgf2.gf2_parallel_xor(torch.zeros((4, 2), dtype=torch.int32),
                              torch.zeros((4, 3), dtype=torch.int32))


def test_tensor_handoff_roundtrip():
    rng = np.random.default_rng(2)
    block = rng.integers(0, 2**32, size=(5, 7), dtype=np.uint32)
    t = tgf2.to_tensor(block, torch.device("cpu"))
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tgf2.to_numpy(t), block)


# ---------------------------------------------------------------------------
# kernels.ops: the dispatch wrappers against repro.kernels.ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,d", [(40, None, 3), (33, 17, 5), (64, None, 9)])
def test_ops_pairwise_distances_matches_jax(m, n, d):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(m, d)).astype(np.float32)
    y = None if n is None else rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(jops.pairwise_distances(x, y, use_pallas=False))
    got = tops.pairwise_distances(
        torch.from_numpy(x), None if y is None else torch.from_numpy(y))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_ops_pairwise_distances_zeroes_the_diagonal():
    """Far from the origin, |x|^2 + |x|^2 - 2 x.x leaves float32 residue
    on the diagonal; both packages zero it, and only for self-distances."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(50, 16)) + 30.0).astype(np.float32)
    tx = torch.from_numpy(x)
    residue = torch.sqrt(pairwise_sq_dists(tx, tx)).diagonal()
    assert float(residue.max()) > 0          # the residue is there to kill
    got = tops.pairwise_distances(tx).numpy()
    want = np.asarray(jops.pairwise_distances(x, use_pallas=False))
    np.testing.assert_array_equal(np.diag(got), 0.0)
    np.testing.assert_array_equal(np.diag(want), 0.0)
    cross = tops.pairwise_distances(tx, tx).diagonal()
    np.testing.assert_array_equal(cross.numpy(), residue.numpy())


@pytest.mark.parametrize("c,w", [(16, 4), (37, 9)])
def test_ops_find_low_matches_jax(c, w):
    rng = np.random.default_rng(12)
    cols = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    cols[::3, : w // 2] = 0
    cols[::4] = 0
    np.testing.assert_array_equal(
        tops.find_low(_bits(cols)).numpy(),
        np.asarray(jops.find_low(cols, use_pallas=False)))


@pytest.mark.parametrize("g,c,w", [(1, 24, 3), (3, 8, 5)])
def test_ops_serial_reduce_bits_matches_jax(g, c, w):
    rng = np.random.default_rng(13)
    blocks = (rng.integers(0, 2**32, size=(g, c, w), dtype=np.uint32)
              & rng.integers(0, 2**32, size=(g, c, w), dtype=np.uint32)
              & rng.integers(0, 2**32, size=(g, c, w), dtype=np.uint32))
    red, lows, reds = tops.serial_reduce_bits(_bits(blocks))
    wb, wl, wr = jops.serial_reduce_bits(blocks, use_pallas=False)
    np.testing.assert_array_equal(_u32(red), np.asarray(wb))
    np.testing.assert_array_equal(lows.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(reds.numpy(), np.asarray(wr))
    assert int(reds.sum()) > 0


# ---------------------------------------------------------------------------
# host bit primitives: exactly the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_host_primitives_match_reference(seed):
    rng = np.random.default_rng(seed)
    universe = np.unique(rng.integers(0, 2**40, size=90).astype(np.int64))
    rows = [np.sort(rng.choice(universe, size=int(rng.integers(0, 40)),
                               replace=False))
            for _ in range(int(rng.integers(1, 9)))]
    packed = tgf2.pack_keys_to_bits(rows, universe, n_words=5)
    np.testing.assert_array_equal(
        packed, jgf2.pack_keys_to_bits(rows, universe, n_words=5))
    for a, b in zip(tgf2.bits_to_keys(packed, universe),
                    jgf2.bits_to_keys(packed, universe)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgf2.set_bit_positions(packed),
                    jgf2.set_bit_positions(packed)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgf2.find_low_np(packed),
                                  jgf2.find_low_np(packed))

    lens = np.array([len(r) for r in rows])
    ridx = np.repeat(np.arange(len(rows)), lens)
    pos = np.searchsorted(universe, np.concatenate(rows)) if lens.sum() \
        else np.zeros(0, dtype=np.int64)
    base = rng.integers(0, 2**32, size=packed.shape, dtype=np.uint32)
    for name in ("scatter_bits", "scatter_xor_bits"):
        mine, theirs = base.copy(), base.copy()
        getattr(tgf2, name)(mine, ridx, pos)
        getattr(jgf2, name)(theirs, ridx, pos)
        np.testing.assert_array_equal(mine, theirs)
    assert tgf2.NO_LOW == jgf2.NO_LOW
