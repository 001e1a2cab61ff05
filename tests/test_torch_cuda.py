"""The port's CUDA kernels against their plain versions on the card, at
small shapes (the checks ``chip_smoke.py`` makes at the main path's shapes).

Marked ``cuda``; every test skips, in the fixture, where there is no card.
Run on a card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: pairwise ``atol = 1e-4 * max(1, max |x|^2)``, ``rtol = 1e-5``
(float32 sums in another order); GF(2) exact; flash attention ``2e-4`` in
float32 and ``1e-2`` in bfloat16, and a reduced prefill on the card
against the CPU ``2e-4`` (float32 compute, TF32 off); one reduced train
step on the card against the CPU: loss and gradient norm within 1e-5, the
weights by the median and 99.9th percentile of their difference; the
same for one meshed step over a (4, 2) mesh of the card's entries
against a CPU mesh, and ``_moe_a2a`` there against the CPU's (the same
routings dropped, outputs within 1e-5).  In bfloat16 the
kernel rounds the probabilities to bfloat16 for P.V where the plain
version keeps them in float32, and both round the output once:
``tests/test_torch_flash_numerics.py`` shows on the CPU that this stays
inside ``1e-2``, which stays below a typical ``|o|`` (unit-normal inputs
give outputs of standard deviation about ``sqrt(e / S)``), as the ``3e-2``
of ``tests/test_kernels.py`` does not at long S.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import compute_ph
from repro_torch.configs import get_config
from repro_torch.kernels import gf2
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.pairwise_dist import (pairwise_sq_dists,
                                               pairwise_sq_dists_plain)
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models.transformer import forward, init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(arr, dev):
    return gf2.to_tensor(arr, dev)


@pytest.mark.parametrize("m,n,d", [(256, 256, 4), (77, 45, 9), (130, 64, 64),
                                   (1, 3, 1), (64, 63, 3)])
def test_pairwise_kernel_matches_plain(dev, m, n, d):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                        device=dev)
    before = pairwise_sq_dists.launches
    got = pairwise_sq_dists(x, y)
    torch.cuda.synchronize()
    assert pairwise_sq_dists.launches == before + 1
    want = pairwise_sq_dists_plain(x, y)
    scale = max(1.0, float((x * x).sum(1).max()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * scale)


def test_pairwise_kernel_rejects_wide_points(dev):
    x = torch.zeros((4, 65), device=dev)
    with pytest.raises(ValueError):
        pairwise_sq_dists(x, x)


@pytest.mark.parametrize("c,w", [(128, 128), (37, 130), (8, 1), (64, 2048)])
def test_find_low_kernel_matches_plain(dev, c, w):
    rng = np.random.default_rng(1)
    cols = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    cols *= rng.integers(0, 2, size=(c, w), dtype=np.uint32)
    cols[::5] = 0
    cols[1::3, : w // 2] = 0
    t = _bits(cols, dev)
    got = gf2.gf2_find_low(t)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gf2.gf2_find_low_plain(t.cpu()))


def _window_rows(rng, c, w):
    """Bit rows whose first set word lies anywhere in the row, some
    empty."""
    rows = (rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
            & rng.integers(0, 2**32, size=(c, w), dtype=np.uint32))
    first = rng.integers(0, w + 1, size=c)
    rows[np.arange(w)[None, :] < first[:, None]] = 0
    rows[::4] = 0
    return rows


# (word offset of the window, words before the block's start): a whole
# block, a 16-byte-aligned window of a wider block, an unaligned window.
VIEWS = {"whole": (0, 0), "aligned": (128, 0), "unaligned": (1, 1)}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("w", [1, 3, 128, 2048, 2176])
@pytest.mark.parametrize("c", [1, 31, 128, 256])
def test_find_low_kernel_on_windows_matches_plain(dev, c, w, view):
    rng = np.random.default_rng(c * 31 + w)
    off, lead = VIEWS[view]
    width = off + w + (64 if view != "whole" else 0)
    flat = np.full(lead + c * width, 0xFFFFFFFF, dtype=np.uint32)
    block = flat[lead:].reshape(c, width)
    block[:, off:off + w] = _window_rows(rng, c, w)
    window = _bits(flat, dev)[lead:].view(c, width)[:, off:off + w]
    before = gf2.gf2_find_low.launches
    got = gf2.gf2_find_low(window)
    torch.cuda.synchronize()
    assert gf2.gf2_find_low.launches == before + 1
    want = gf2.gf2_find_low_plain(window.cpu())
    assert torch.equal(got.cpu(), want)
    np.testing.assert_array_equal(want.numpy(),
                                  gf2.find_low_np(block[:, off:off + w]))


def test_find_low_kernel_rejects_strided_words(dev):
    cols = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        gf2.gf2_find_low(cols[:, ::2])


@pytest.mark.parametrize("index", ["host64", "host32"])
@pytest.mark.parametrize("repeat", [False, True])
@pytest.mark.parametrize("w", [1, 3, 128, 2048, 2176])
@pytest.mark.parametrize("c", [1, 31, 128, 256])
def test_scatter_xor_kernel_matches_plain(dev, c, w, repeat, index):
    rng = np.random.default_rng(c * 7 + w)
    rows = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    n_bits = c * w * 32
    flat = rng.choice(n_bits, size=max(1, n_bits // 9), replace=False)
    if repeat:
        flat = np.concatenate([flat, flat[::3], flat[::6]])
        rng.shuffle(flat)
    idx = torch.from_numpy(flat.astype(np.int64 if index == "host64"
                                       else np.int32))
    t = _bits(rows, dev)
    want = gf2.gf2_scatter_xor_plain(t.clone(), idx)
    before = gf2.gf2_scatter_xor.launches
    assert gf2.gf2_scatter_xor(t, idx) is t
    torch.cuda.synchronize()
    assert gf2.gf2_scatter_xor.launches == before + 1
    assert torch.equal(t, want)
    u, counts = np.unique(flat, return_counts=True)
    u = u[counts % 2 == 1]
    host = rows.copy()
    gf2.scatter_xor_bits(host, u // (w * 32), u % (w * 32))
    np.testing.assert_array_equal(gf2.to_numpy(t), host)


def test_scatter_xor_kernel_int64_index(dev):
    """C * W * 32 = 2**31 bits: the flat indices cross as int64."""
    c, w = 2**15, 2048
    rows = torch.zeros((c, w), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(9)
    flat = np.concatenate([rng.integers(2**31 - 2**20, 2**31, size=5000),
                           rng.integers(0, 2**20, size=5000)])
    flat = np.concatenate([flat, flat[::4]])
    idx = torch.from_numpy(flat)
    want = gf2.gf2_scatter_xor_plain(rows.clone(), idx)
    gf2.gf2_scatter_xor(rows, idx)
    torch.cuda.synchronize()
    assert torch.equal(rows, want)
    assert int((rows[-1] != 0).sum()) > 0


def test_scatter_xor_kernel_fused_block_past_2_31_bits(dev):
    """The distributed reduction's fused block at P = 4: 4 x 128 hit rows, a
    bucketed width of 131,200 words, 512 * 131,200 * 32 > 2**31 bits, so
    the flat indices ``local * cap * 32 + pos`` cross as int64; every
    slice's rows get coordinates, the last row near the top bit."""
    c, w = 4 * 128, 131_200
    assert c * w * 32 > 2**31
    rows = torch.zeros((c, w), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(11)
    local = rng.integers(0, c, size=20_000)
    pos = rng.integers(0, w * 32, size=20_000)
    flat = np.concatenate([local * (w * 32) + pos,
                           [c * w * 32 - 1, (c - 1) * w * 32, 5]])
    flat = np.concatenate([flat, flat[::7]])     # repeats cancel
    idx = torch.from_numpy(flat.astype(np.int64))
    want = gf2.gf2_scatter_xor_plain(rows.clone(), idx)
    before = gf2.gf2_scatter_xor.launches
    gf2.gf2_scatter_xor(rows, idx)
    torch.cuda.synchronize()
    assert gf2.gf2_scatter_xor.launches == before + 1
    assert torch.equal(rows, want)
    assert int(rows[-1, -1]) != 0


@pytest.mark.parametrize("bad", [-1, 4 * 8 * 32, 2**40])
def test_scatter_xor_kernel_rejects_index_outside_block(dev, bad):
    """An index outside the (4, 8) block raises before any launch and
    leaves the rows as they were."""
    rows = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    before = gf2.gf2_scatter_xor.launches
    with pytest.raises(ValueError, match="outside the block"):
        gf2.gf2_scatter_xor(rows, torch.tensor([3, bad, 40]))
    assert gf2.gf2_scatter_xor.launches == before
    assert not bool(rows.any())


def test_scatter_xor_kernel_refuses_indices_on_the_card(dev):
    rows = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="on the host"):
        gf2.gf2_scatter_xor(rows, torch.tensor([3, 40], device=dev))


class _FailingLib:
    """Stands in for the built library: every launcher reports
    cudaErrorInvalidConfiguration (9)."""

    def __getattr__(self, name):
        return lambda *args: 9


def test_gf2_kernels_raise_on_failed_launch(dev, monkeypatch):
    monkeypatch.setattr(gf2, "_lib", lambda: _FailingLib())
    cols = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="gf2_find_low.*error 9"):
        gf2.gf2_find_low(cols)
    with pytest.raises(RuntimeError, match="gf2_scatter_xor.*error 9"):
        gf2.gf2_scatter_xor(cols, torch.tensor([3, 40]))
    with pytest.raises(RuntimeError, match="gf2_parallel_xor.*error 9"):
        gf2.gf2_parallel_xor(cols, cols)


@pytest.mark.parametrize("c,w", [(128, 128), (130, 3), (5, 7)])
def test_parallel_xor_kernel_matches_plain(dev, c, w):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    got = gf2.to_numpy(gf2.gf2_parallel_xor(_bits(a, dev), _bits(b, dev)))
    np.testing.assert_array_equal(got, a ^ b)
    # an unaligned view takes the scalar path
    ta, tb = _bits(a, dev).reshape(-1)[1:], _bits(b, dev).reshape(-1)[1:]
    got = gf2.gf2_parallel_xor(ta[None], tb[None])
    np.testing.assert_array_equal(gf2.to_numpy(got)[0],
                                  (a ^ b).reshape(-1)[1:])


@pytest.mark.parametrize("g,c,w", [(1, 32, 4), (2, 16, 40), (1, 128, 256)])
def test_serial_reduce_kernel_matches_plain(dev, g, c, w):
    rng = np.random.default_rng(3)
    blocks = np.zeros((g, c, w), dtype=np.uint32)
    blocks[:, :, 0] = np.uint32(1) << rng.integers(0, 6, size=(g, c)).astype(
        np.uint32)                            # planted low collisions
    blocks[:, :, 1:] = (rng.integers(0, 2**32, size=(g, c, w - 1),
                                     dtype=np.uint32)
                        & rng.integers(0, 2**32, size=(g, c, w - 1),
                                       dtype=np.uint32))
    t = _bits(blocks, dev)
    red, lows, reds = gf2.gf2_serial_reduce(t)
    torch.cuda.synchronize()
    pred, plows, preds = gf2.gf2_serial_reduce_plain(t.cpu())
    assert torch.equal(red.cpu(), pred)
    assert torch.equal(lows.cpu(), plows)
    assert torch.equal(reds.cpu(), preds)
    assert int(preds.sum()) > 0


def _prepass_blocks(rng, g, c, w, planted):
    """The packed engine's pre-pass layout: R words whose lows spread over
    the row, rows planted onto an earlier row's low or whole R part (emptied
    by the XOR), V identity bits at the tail."""
    vw = (c + 31) // 32
    cap = w - vw
    blocks = np.zeros((g, c, w), dtype=np.uint32)
    for b in range(g):
        r = (rng.integers(0, 2**32, size=(c, cap), dtype=np.uint32)
             & rng.integers(0, 2**32, size=(c, cap), dtype=np.uint32))
        first = rng.integers(0, cap, size=c)
        r[np.arange(cap)[None, :] < first[:, None]] = 0
        r[np.arange(c), first] |= np.uint32(1) << rng.integers(
            0, 32, size=c).astype(np.uint32)
        for n in range(planted):
            i = int(rng.integers(1, c))
            j = int(rng.integers(0, i))
            r[i, :first[j] + 1] = r[j, :first[j] + 1]
            if n % 4 == 0:
                r[i] = r[j]
        blocks[b, :, :cap] = r
        rows = np.arange(c)
        blocks[b, rows, cap + (rows >> 5)] = np.uint32(1) << (
            rows & 31).astype(np.uint32)
    return blocks


@pytest.mark.parametrize("g,c,w,route,k", [
    (1, 128, 256, "smem", 1), (1, 128, 2176, "cluster", 5),
    (1, 128, 600, "cluster", 2), (1, 128, 3500, "cluster", 8),
    (1, 128, 7000, "cluster", 16), (1, 128, 8000, "global", 0),
    (2, 128, 2176, "cluster", 5), (2, 70, 13, "smem", 1),
    (2, 45, 8003, "cluster", 7), (1, 45, 30003, "global", 0)])
def test_serial_reduce_routes_match_plain(dev, g, c, w, route, k):
    """Every route of the serial kernel, bit for bit against the plain
    version: block, lows and reduction counts."""
    assert gf2.serial_plan(c, w)[:2] == (route, k)
    rng = np.random.default_rng(w + c)
    t = _bits(_prepass_blocks(rng, g, c, w, c // 3), dev)
    before = gf2.gf2_serial_reduce.launches
    red, lows, reds = gf2.gf2_serial_reduce(t)
    torch.cuda.synchronize()
    assert gf2.gf2_serial_reduce.launches == before + 1
    pred, plows, preds = gf2.gf2_serial_reduce_plain(t.cpu())
    assert torch.equal(red.cpu(), pred)
    assert torch.equal(lows.cpu(), plows)
    assert torch.equal(reds.cpu(), preds)
    assert int(preds.min()) > 0


def test_serial_reduce_refused_plan_raises(dev, monkeypatch):
    """No fallback: a plan the launcher refuses (ranks that do not cover
    the row) raises instead of handing over to the plain version."""
    monkeypatch.setattr(gf2, "serial_plan",
                        lambda c, w: gf2.SerialPlan("cluster", 2, 4, 128, 0))
    t = _bits(np.ones((1, 32, 64), dtype=np.uint32), dev)
    with pytest.raises(RuntimeError, match="gf2_serial_reduce"):
        gf2.gf2_serial_reduce(t)


def test_compute_ph_card_matches_cpu(dev):
    pts = np.random.default_rng(4).normal(size=(60, 3))
    kw = dict(points=pts, tau_max=1.2, maxdim=2, engine="packed",
              backend="tiled", tile_m=32, tile_n=32, batch_size=32)
    counts = [f.launches for f in (pairwise_sq_dists, gf2.gf2_find_low,
                                   gf2.gf2_scatter_xor)]
    dense = gf2.gf2_parallel_xor.launches
    card = compute_ph(device="cuda", **kw)
    host = compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
    after = [f.launches for f in (pairwise_sq_dists, gf2.gf2_find_low,
                                  gf2.gf2_scatter_xor)]
    assert all(b > a for a, b in zip(counts, after))
    assert gf2.gf2_parallel_xor.launches == dense   # off the path
    assert card.stats["h1_use_kernels"] == 1.0


@pytest.mark.parametrize("exchange_every", [1, 4])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_compute_ph_dist_card_matches_cpu(dev, n_shards, exchange_every):
    """The distributed packed reduction on the card: the fused P·B-row
    block through the GF(2) kernels, diagrams equal to the CPU run's and to
    P = 1 on the card."""
    pts = np.random.default_rng(4).normal(size=(60, 3))
    kw = dict(points=pts, tau_max=1.2, maxdim=2, engine="packed",
              backend="tiled", tile_m=32, tile_n=32, batch_size=8)
    counts = [f.launches for f in (gf2.gf2_find_low, gf2.gf2_scatter_xor)]
    card = compute_ph(device="cuda", n_shards=n_shards,
                      exchange_every=exchange_every, **kw)
    after = [f.launches for f in (gf2.gf2_find_low, gf2.gf2_scatter_xor)]
    assert all(b > a for a, b in zip(counts, after))
    host = compute_ph(device="cpu", n_shards=n_shards,
                      exchange_every=exchange_every, **kw)
    one = compute_ph(device="cuda", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
        assert np.array_equal(card.diagrams[d], one.diagrams[d]), d
    assert card.stats["h2_n_shards"] == n_shards
    assert card.stats["h2_n_exchange_rounds"] > 0
    assert card.stats["h1_use_kernels"] == 1.0


_CARD_FAULTS = {
    "kill_start": dict(site="reduce.superstep", kind="kill_shard", at=2,
                       shard=1, params=(("when", "start"),)),
    "kill_mid": dict(site="reduce.superstep", kind="kill_shard", at=3,
                     shard=2, params=(("when", "mid"),)),
    "wire": dict(site="exchange.wire", kind="corrupt", at=1, shard=0,
                 params=(("bit", 37),)),
}


@pytest.mark.parametrize("case", sorted(_CARD_FAULTS))
def test_compute_ph_faulted_dist_card_matches_cpu(dev, case):
    """A faulted ``n_shards=4`` run on the card (the fused blocks through
    the kernels, fewer slices after a kill): diagrams and recovery
    counters equal the same plan's CPU run, diagrams the fault-free
    card run's."""
    from repro_torch.resilience.faults import FaultPlan, FaultSpec, inject

    pts = np.random.default_rng(4).normal(size=(60, 3))
    kw = dict(points=pts, tau_max=1.2, maxdim=2, engine="packed",
              backend="tiled", tile_m=32, tile_n=32, batch_size=8,
              n_shards=4, exchange_every=1)
    runs = {}
    for where in ("cuda", "cpu"):
        plan = FaultPlan.of(FaultSpec(**_CARD_FAULTS[case]), seed=5)
        with inject(plan) as inj:
            runs[where] = compute_ph(device=where, **kw)
            assert inj.fired
    clean = compute_ph(device="cuda", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(runs["cuda"].diagrams[d],
                              runs["cpu"].diagrams[d]), d
        assert np.array_equal(runs["cuda"].diagrams[d], clean.diagrams[d]), d
    for k, v in runs["cpu"].stats.items():
        if "resilience_n_" in k:
            assert runs["cuda"].stats[k] == v, k


@pytest.mark.parametrize("n_shards", [None, 3])
def test_compute_ph_sanitize_card_matches_cpu(dev, n_shards):
    """``compute_ph(sanitize=True)`` on the card: the checks run on the
    kernel path's blocks and the diagrams equal the CPU run's."""
    pts = np.random.default_rng(1).normal(size=(16, 3))
    kw = dict(points=pts, maxdim=2, engine="packed", batch_size=8,
              n_shards=n_shards, sanitize=True)
    card = compute_ph(device="cuda", **kw)
    host = compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
    assert card.stats["sanitize_checks"] > 0
    assert card.stats["h1_use_kernels"] == 1.0


def test_compute_ph_dist_one_slice_superstep_launches_serial_kernel(dev):
    """At P = 2 the H1 queue's last superstep holds one slice of 17 rows
    with colliding lows, so its serial pass runs unrestricted and the
    ``gf2_serial_reduce`` pre-pass launches on the card; the fused
    supersteps before it never launch it."""
    pts = np.random.default_rng(2).normal(size=(32, 3))
    kw = dict(points=pts, maxdim=2, engine="packed", n_shards=2,
              batch_size=32)
    before = gf2.gf2_serial_reduce.launches
    card = compute_ph(device="cuda", **kw)
    assert gf2.gf2_serial_reduce.launches > before
    host = compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
    assert card.stats["h1_n_supersteps"] == 8


def test_compute_ph_dist_default_device_is_the_card(dev):
    pts = np.random.default_rng(7).normal(size=(24, 3))
    res = compute_ph(points=pts, maxdim=2, engine="packed", n_shards=4)
    assert res.stats["h1_use_kernels"] == 1.0
    host = compute_ph(points=pts, maxdim=2, engine="packed", n_shards=4,
                      device="cpu")
    for d in (0, 1, 2):
        assert np.array_equal(res.diagrams[d], host.diagrams[d]), d


def _card_mesh(p):
    return make_data_mesh(p, devices=["cuda:0"] * p)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("p", [2, 4])
def test_compute_ph_mesh_card_matches_loopback_and_cpu(dev, p, mode):
    """A ``["cuda:0"] * P`` mesh: the sharded harvest launches the pairwise
    kernel once a tile, each entry on its own stream, and the reduction's
    exchange gathers on the card; diagrams and split counters equal the
    loop-back on the card and the cpu x P mesh."""
    from repro_torch.scale.tiles import tile_grid

    pts = np.random.default_rng(4).normal(size=(60, 3))
    kw = dict(points=pts, tau_max=1.2, maxdim=2, engine="packed", mode=mode,
              backend="tiled", tile_m=16, tile_n=16, batch_size=8,
              exchange_every=1)
    before = pairwise_sq_dists.launches
    card = compute_ph(mesh=_card_mesh(p), **kw)
    assert pairwise_sq_dists.launches - before == len(tile_grid(60, 16, 16))
    loop = compute_ph(n_shards=p, device="cuda", **kw)
    host = compute_ph(mesh=make_data_mesh(p, devices=["cpu"] * p), **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], loop.diagrams[d]), d
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
    for h in ("h1", "h2"):
        for k in ("n_supersteps", "n_exchange_rounds", "exchange_bytes",
                  "n_tournament_reductions", "n_reductions"):
            key = f"{h}_{k}"
            assert card.stats[key] == loop.stats[key] == host.stats[key], key
    assert card.stats["h1_use_kernels"] == 1.0
    assert card.stats["h2_n_exchange_rounds"] > 0


@pytest.mark.parametrize("which", ["points", "dists"])
def test_sharded_harvest_card_matches_cpu(dev, which):
    """The device rounds on a ``["cuda:0"] * 4`` mesh, points and a dists
    matrix: filtrations equal to the serial build on the card and to the
    cpu x 4 mesh."""
    from repro_torch.scale import build_filtration_sharded
    from repro_torch.scale.tiles import build_filtration_tiled

    pts = np.random.default_rng(9).normal(size=(300, 9))
    data = dict(points=pts)
    if which == "dists":
        data = dict(dists=np.linalg.norm(pts[:, None] - pts[None], axis=-1))
    kw = dict(tau_max=3.5, tile_m=64, tile_n=64, **data)
    card, stats = build_filtration_sharded(mesh=_card_mesh(4),
                                           return_stats=True, **kw)
    host = build_filtration_sharded(
        mesh=make_data_mesh(4, devices=["cpu"] * 4), **kw)
    serial = build_filtration_tiled(device="cuda", **kw)
    for other in (host, serial):
        assert np.array_equal(card.edges, other.edges)
        assert np.array_equal(card.edge_len, other.edge_len)
    assert stats.n_shards == 4 and stats.backend == "kernel"
    assert card.n_e > 1000


def test_mesh_device_mismatch_raises(dev):
    with pytest.raises(ValueError, match="device type"):
        compute_ph(points=np.zeros((8, 2)), maxdim=1, engine="packed",
                   mesh=_card_mesh(2), device="cpu")


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_compute_ph_batch_engine_card_matches_cpu(dev, mode):
    """The batch engine is host numpy; on the card its tiled harvest runs
    the pairwise kernel."""
    pts = np.random.default_rng(5).normal(size=(60, 3))
    kw = dict(points=pts, tau_max=1.2, maxdim=2, engine="batch", mode=mode,
              backend="tiled", tile_m=32, tile_n=32, batch_size=16)
    before = pairwise_sq_dists.launches
    card = compute_ph(device="cuda", **kw)
    assert pairwise_sq_dists.launches > before
    host = compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
    assert card.diagrams[1].shape[0] > 0


@pytest.mark.parametrize("n_shards", [None, 2])
def test_warm_resume_card_matches_cpu_and_cold(dev, n_shards):
    """Warm tau growth and point arrival through the packed engine on the
    card (the PH service's warm paths): diagrams and checkpoint hash equal
    to the same updates through the kernel path's plain versions on the
    CPU, diagrams equal to a cold ``compute_ph`` on the card, and
    ``gf2_find_low`` launching.  (The CPU's default numpy path may record
    other valid δ-expansions at P = 1, as the reference's does: the same
    diagrams, another hash.)"""
    from repro_torch.core.filtration import build_filtration
    from repro_torch.core import resume
    from repro_torch.core.packed_reduce import reduce_dimension_packed

    def plain_kernels(adapter, cols, cleared, seed_gens, commit_log,
                      essential_log):
        return reduce_dimension_packed(
            adapter, cols, mode="implicit", cleared=cleared, batch_size=32,
            use_kernels=True, n_shards=n_shards, seed_gens=seed_gens,
            commit_sink=commit_log, essential_log=essential_log,
            device="cpu")

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(120, 3))
    grown = np.concatenate([pts, rng.normal(size=(16, 3))], axis=0)
    steps = [("cold_reduce", pts, 0.7), ("warm_tau_growth", pts, 1.0),
             ("warm_point_arrival", grown, 1.0)]
    results = {}
    before = gf2.gf2_find_low.launches
    for where in ("cuda", "cpu"):
        ckpt, out = None, []
        for fn, p, tau in steps:
            args = [build_filtration(points=p, tau_max=tau)]
            kw = dict(engine="packed", batch_size=32, n_shards=n_shards,
                      device=where) if where == "cuda" \
                else dict(reducer=plain_kernels)
            if ckpt is None:
                kw["maxdim"] = 1
            else:
                args.append(ckpt)
            diagrams, ckpt = getattr(resume, fn)(*args, **kw)
            out.append((diagrams, ckpt.content_hash()))
        results[where] = out
        if where == "cuda":
            assert gf2.gf2_find_low.launches > before
    for k, (fn, p, tau) in enumerate(steps):
        (dc, hc), (dh, hh) = results["cuda"][k], results["cpu"][k]
        assert hc == hh, fn
        cold = compute_ph(points=p, tau_max=tau, maxdim=1, engine="packed",
                          device="cuda")
        for d in (0, 1):
            assert np.array_equal(dc[d], dh[d]), (fn, d)
            assert np.array_equal(resume.canonical_diagram(dc[d]),
                                  resume.canonical_diagram(
                                      cold.diagrams[d])), (fn, d)


@pytest.mark.parametrize("engine", ["packed", "batch"])
@pytest.mark.parametrize("condition", [0, 1])
def test_hic_pair_card_matches_cpu(dev, engine, condition):
    """The suite's Hi-C pair at n = 350 (tau 0.6, maxdim 2), as
    ``chip_smoke.py``'s ``hic_suite`` runs it on the card."""
    from repro_torch.data.pointclouds import hic_pair

    points = hic_pair(350, 24, seed=1)[condition]
    kw = dict(points=points, tau_max=0.6, maxdim=2, engine=engine,
              backend="tiled")
    card = compute_ph(device="cuda", **kw)
    host = compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(card.diagrams[d], host.diagrams[d]), d
    assert card.stats["n_e"] == host.stats["n_e"]


# ---------------------------------------------------------------------------
# flash attention (2e-4 in float32, 1e-2 in bfloat16: module docstring)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("bh,s,d,causal,window", [
    (2, 128, 32, True, -1), (2, 128, 128, False, -1), (1, 256, 256, True, 64),
    (3, 77, 128, True, -1), (1, 130, 32, False, 24), (2, 200, 256, True, 1),
    (1, 1, 64, True, -1), (1, 64, 40, True, 16)])
def test_flash_kernel_matches_plain(dev, dtype, tol, bh, s, d, causal,
                                    window):
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=(bh, s, d)), dtype=dtype,
                               device=dev) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("bh", [1, 130])
@pytest.mark.parametrize("window", [-1, 1, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 128, 1000, 2048])
@pytest.mark.parametrize("d", [40, 64, 128, 192, 256])
def test_flash_bf16_kernel_matches_plain(dev, d, s, causal, window, bh):
    """The tensor-core route over head widths (d = 40 runs at D = 64 with
    zero columns; d = 192, MLA's padded width, at D = 256), ragged and
    single-row S, both masks and many heads."""
    rng = np.random.default_rng(d * 7919 + s)
    q, k, v = (torch.as_tensor(rng.normal(size=(bh, s, d)),
                               dtype=torch.bfloat16, device=dev)
               for _ in range(3))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("causal,window", [(True, -1), (False, -1),
                                           (True, 1), (False, 16),
                                           (True, 50)])
@pytest.mark.parametrize("s", [1, 37, 63, 64, 200, 1000])
@pytest.mark.parametrize("d", [8, 16, 40, 64, 128, 256])
def test_flash_f32_kernel_matches_plain(dev, d, s, causal, window):
    """The SIMT route at its tile edges (128 queries and 64 keys a tile, 64
    and 32 at d = 256): S below a KV tile, ragged to the query tile, one
    row; windows below a tile; every template width, with zero columns at
    d = 8, 16 and 40; BH = 1."""
    rng = np.random.default_rng(d * 7919 + s + window)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, s, d)),
                               dtype=torch.float32, device=dev)
               for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_flash_f32_kernel_rejects_misaligned_pointer(dev):
    """cp.async copies 16 bytes from a 16-byte aligned address: a view one
    float into its storage raises before any launch."""
    flat = torch.zeros(4 * 64 + 1, dtype=torch.float32, device=dev)
    q = flat[1:].view(1, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    k = torch.zeros((1, 4, 64), dtype=torch.float32, device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(k, q, k)
    assert flash_attention.launches == before


def test_flash_bf16_kernel_rejects_misaligned_pointer(dev):
    """TMA needs a 16-byte aligned base: a view two bytes into its storage
    raises before any launch."""
    flat = torch.zeros(4 * 64 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(1, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    k = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(k, k, q)
    assert flash_attention.launches == before


def test_flash_bf16_kernel_counts_each_launch(dev):
    q = torch.randn((2, 70, 64), dtype=torch.bfloat16, device=dev)
    before = flash_attention.launches
    for i in range(3):
        flash_attention(q, q, q, causal=bool(i % 2))
        assert flash_attention.launches == before + i + 1
    torch.cuda.synchronize()


def test_flash_kernel_rejects_what_it_cannot_take(dev):
    q = torch.zeros((1, 8, 12), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                 # d not a multiple of 8
    q = torch.zeros((1, 8, 264), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                 # d > 256
    q = torch.zeros((1, 16, 8), device=dev).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                 # not contiguous
    q = torch.zeros((1, 8, 16), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)


ARCHS = ["qwen3-0.6b", "gemma3-1b", "granite-moe-1b-a400m",
         "deepseek-v2-lite-16b", "glm4-9b", "granite-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_card_matches_cpu(dev, arch):
    cfg = get_config(arch, reduced=True)
    host = init_params(cfg, seed=0, device="cpu")
    card = init_params(cfg, seed=0, device="cpu").to(dev)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    before = flash_attention.launches
    with torch.inference_mode():
        got, _ = forward(card, {"tokens": toks.to(dev)})
        want, _ = forward(host, {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_train_step_card_matches_cpu(dev, arch):
    """One train step of a reduced model (float32 compute, TF32 off) on
    the card and on the CPU from the same weights: loss and gradient norm
    within 1e-5, the weights by the median (<= 1e-7) and 99.9th percentile
    (<= 1e-6) of their difference and at most 2 lr apart (a near-zero
    gradient whose sign differs)."""
    from repro_torch.models.transformer import (params_from_arrays,
                                                params_to_arrays)
    from repro_torch.train import (AdamW, TrainState, make_train_step,
                                   warmup_cosine)

    cfg = get_config(arch, reduced=True)
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    step = make_train_step(cfg, opt, n_micro=2)
    arrays = params_to_arrays(init_params(cfg, seed=0, device="cpu"))
    states = []
    for d in ("cpu", dev):
        model = params_from_arrays(cfg, arrays, d).requires_grad_(True)
        states.append(TrainState(
            params=model, opt=opt.init(dict(model.named_parameters()))))
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 33)), dtype=torch.int32)
    (host, hm), (card, cm) = [step(st, {"tokens": toks.to(d)}) for st, d
                              in zip(states, ("cpu", dev))]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(cm[k]), float(hm[k]), rtol=1e-5,
                                   err_msg=k)
    d = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten()
                   for a, b in zip(card.params.parameters(),
                                   host.params.parameters())])
    assert float(d.median()) <= 1e-7
    assert float(torch.quantile(d, 0.999)) <= 1e-6
    assert float(d.max()) <= 2 * float(hm["lr"]) * (1 + 1e-3)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "recurrentgemma-9b"])
def test_reduced_recurrent_forward_card_matches_cpu(dev, arch):
    """The recurrent models reduced (float32, TF32 off) on the card and on
    the CPU from the same weights, 2 x 64 tokens: logits within
    ``1e-4 · max(1, max |logits|)``, and one flash launch a ``local_attn``
    layer on the card (none for xlstm)."""
    from repro_torch.models.transformer import is_attention, layer_slots

    cfg = get_config(arch, reduced=True)
    host = init_params(cfg, seed=0, device="cpu")
    card = init_params(cfg, seed=0, device="cpu").to(dev)
    toks = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32)
    before = flash_attention.launches
    with torch.inference_mode():
        got, _ = forward(card, {"tokens": toks.to(dev)})
        want, _ = forward(host, {"tokens": toks})
    torch.cuda.synchronize()
    n_attn = sum(is_attention(s.kind) for s in layer_slots(cfg))
    assert flash_attention.launches == before + n_attn
    atol = 1e-4 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


def test_griffin_prefill_launches_flash_per_local_attn_layer(dev):
    """recurrentgemma at 5 layers (a ``griffin`` superblock and the
    ``griffin_rem`` pair), bf16 compute: a prefill launches the bf16
    kernel once, for its one ``local_attn`` layer, at the layer's window;
    the decode steps after it launch none."""
    import dataclasses

    from repro_torch.serve.steps import (extend_cache, make_decode_step,
                                         make_prefill_step)

    cfg = dataclasses.replace(get_config("recurrentgemma-9b", reduced=True),
                              n_layers=5, compute_dtype="bfloat16")
    model = init_params(cfg, seed=0, device=dev)
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32, device=dev)
    before = flash_attention.launches
    with torch.inference_mode():
        logits, cache = make_prefill_step(cfg)(model, {"tokens": toks})
        assert flash_attention.launches == before + 1
        cache = extend_cache(cfg, cache, 40, 44)
        decode = make_decode_step(cfg)
        for i in range(40, 43):
            logits, cache = decode(model, cache, {"tokens": toks[:, :1],
                                                  "cache_pos": i})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_apply_card_matches_cpu(dev, capacity_factor):
    """The MoE FFN (reduced deepseek, float32, TF32 off) on the card and
    on the CPU: the same routings dropped, output within 1e-5, aux within
    1e-6."""
    import dataclasses

    from repro_torch.models.moe import moe_apply, moe_params

    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    p = moe_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.as_tensor(np.random.default_rng(9).normal(
        size=(3, 40, cfg.d_model)), dtype=torch.float32)
    want, want_aux = moe_apply(p, cfg, x)
    got, aux = moe_apply({k: v.to(dev) for k, v in p.items()}, cfg,
                         x.to(dev))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=1e-6)


def test_mla_decode_card_matches_cpu(dev):
    """Reduced deepseek: prefill (the flash route, values padded) and
    three absorbed decode steps on the card against the CPU, 2e-4."""
    from repro_torch.serve.steps import extend_cache

    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    host = init_params(cfg, seed=3, device="cpu")
    card = init_params(cfg, seed=3, device="cpu").to(dev)
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    from repro_torch.models.transformer import decode_step

    outs = []
    for model, d in ((host, "cpu"), (card, dev)):
        with torch.inference_mode():
            _, _, c = forward(model, {"tokens": toks[:, :9].to(d)},
                              return_caches=True)
            cache = extend_cache(cfg, c, 9, 16)
            steps = []
            for i in range(9, 12):
                lg, cache = decode_step(model, cache, {
                    "tokens": toks[:, i:i + 1].to(d), "cache_pos": i})
                steps.append(lg.cpu())
        outs.append(torch.cat(steps, dim=1))
    torch.testing.assert_close(outs[1], outs[0], rtol=2e-4, atol=2e-4)


def test_train_checkpoint_card_to_cpu(dev, tmp_path):
    """A train state written from the card restores on the CPU bit for
    bit, and back into a trainable state there."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import AdamW, init_train_state, warmup_cosine
    from repro_torch.train.train_step import (train_state_from_arrays,
                                              train_state_to_arrays)

    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    card = init_train_state(cfg, opt, seed=2, device=dev)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save_async(5, train_state_to_arrays(card), metadata={"step": 5})
    ckpt.wait()
    template = train_state_to_arrays(init_train_state(cfg, opt, seed=9,
                                                      device="cpu"))
    tree, meta = ckpt.restore(template)
    host = train_state_from_arrays(cfg, tree, "cpu")
    assert meta == {"step": 5} and int(host.opt.step) == 0
    for (n, a), b in zip(card.params.named_parameters(),
                         host.params.parameters()):
        assert b.device.type == "cpu" and b.requires_grad, n
        assert torch.equal(a.detach().cpu(), b.detach()), n


def test_traced_steps_wait_for_the_card(dev, monkeypatch):
    """With tracing on, a step whose metrics are not read waits for the
    card inside its span (logged steps wait reading their metrics); with
    tracing off, no step waits."""
    import contextlib
    import io

    from repro_torch.launch import train as tlaunch
    from repro_torch.obs.trace import Tracer, tracing

    calls = []
    real = torch.cuda.synchronize

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    job = tlaunch.TrainJob(cfg=get_config("qwen3-0.6b", reduced=True),
                           steps=5, global_batch=2, seq_len=16,
                           log_every=10, device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        tlaunch.run(job)
        assert calls == []
        tr = Tracer()
        with tracing(tr):
            tlaunch.run(job)
    assert len(calls) == 3                  # steps 1-3; 0 and 4 are logged
    assert [sp.attrs["step"] for sp in tr.spans
            if sp.name == "train/step"] == list(range(5))


def test_run_resumes_in_place_on_the_card(dev, tmp_path):
    """``run(restore=True)`` on the card loads the checkpoint into the
    live state and continues as the uninterrupted run does."""
    import contextlib
    import io

    from repro_torch.launch import train as tlaunch

    job = tlaunch.TrainJob(cfg=get_config("qwen3-0.6b", reduced=True),
                           steps=6, global_batch=4, seq_len=16, n_micro=2,
                           lr=1e-3, warmup=2, ckpt_every=3, log_every=1,
                           ckpt_dir=str(tmp_path), device=dev)
    with contextlib.redirect_stdout(io.StringIO()):
        whole = tlaunch.run(job)
        os.rename(tmp_path / "step_0000000005",
                  tmp_path / "step_0000000005.tmp")
        resumed = tlaunch.run(job, restore=True)
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    assert resumed["history"] == whole["history"][4:]
    for a, b in zip(whole["state"].params.parameters(),
                    resumed["state"].params.parameters()):
        assert a.device.type == "cuda" and torch.equal(a, b)


def test_flash_route_raises_under_autograd_on_the_card(dev):
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = init_params(cfg, seed=0, device=dev).requires_grad_(True)
    toks = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="forward only"):
        forward(model, {"tokens": toks})
    assert flash_attention.launches == before
    with torch.no_grad():
        forward(model, {"tokens": toks})
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers


def _same_result(a, b) -> bool:
    """Equal nested results: dicts, tuples, tensors (any device), arrays."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_result(a[k], b[k])
                                              for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same_result, a, b))
    if isinstance(a, torch.Tensor):
        a, b = a.cpu().numpy(), b.cpu().numpy()
    return np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype


def test_check_repo_card_matches_cpu(dev):
    """Every registered mesh program on a 4-entry mesh of the card: no
    violation, the registry's schedules, the CPU run's results."""
    from repro_torch.analyze import collectives

    schedules, violations = collectives.check_repo(device="cuda")
    assert not violations, "\n".join(map(str, violations))
    cpu_schedules, _ = collectives.check_repo(device="cpu")
    assert [s.signature() for s in schedules] == \
        [s.signature() for s in cpu_schedules] == \
        [p.expect for p in collectives.repo_programs(device="cuda")]
    card = {p.name: p for p in collectives.repo_programs(device="cuda")}
    for program in collectives.repo_programs(device="cpu"):
        card_fn, card_args, _, mesh = card[program.name].build()
        assert mesh.devices.flat[0].type == "cuda"
        fn, args, _, _ = program.build()
        assert _same_result(card_fn(*card_args), fn(*args)), program.name


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-1b",
                                  "granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "xlstm-1.3b",
                                  "recurrentgemma-9b", "qwen2-vl-2b",
                                  "whisper-small"])
def test_reduced_meshed_step_card_matches_cpu(dev, arch):
    """One meshed train step of a reduced model (float32 compute, TF32 off)
    over a (data 4, model 2) mesh of the card's entries and over one of the
    CPU's, from the same weights, on a batch of its input kind
    (``tests/test_torch_train_mesh_families.py``'s ``family_batch``): loss
    and gradient norm within 1e-5, the weights as
    :func:`test_reduced_train_step_card_matches_cpu` holds them."""
    from repro_torch.dist.sharding import (activation_rules,
                                           bind_activation_rules,
                                           tree_flatten_with_path)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (AdamW, init_train_state, make_train_step,
                                   warmup_cosine)
    from repro_torch.train.train_step import (shard_train_state,
                                              train_state_to_arrays)

    from test_torch_train_mesh_families import family_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, reduced=True)
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    batch = {k: torch.from_numpy(v) for k, v in
             family_batch(cfg, seed=8, seq=33).items()}
    out = []
    for d in ("cpu", dev):
        mesh = make_mesh((4, 2), ("data", "model"), devices=[d] * 8)
        step = bind_activation_rules(make_train_step(
            cfg, opt, n_micro=2, micro_batch_axes=("data",)),
            activation_rules(cfg, mesh))
        state = shard_train_state(init_train_state(cfg, opt, seed=0,
                                                   device="cpu"), mesh)
        state, m = step(state, {k: v.to(d) for k, v in batch.items()})
        out.append((m, [np.asarray(a) for _, a in tree_flatten_with_path(
            train_state_to_arrays(state).params)[0]]))
    (hm, hw), (cm, cw) = out
    for k in ("loss", "grad_norm", "lr", "aux_loss"):
        np.testing.assert_allclose(float(cm[k]), float(hm[k]), rtol=1e-5,
                                   err_msg=k)
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(cw, hw)])
    assert np.median(d) <= 1e-7
    assert np.quantile(d, 0.999) <= 1e-6
    assert d.max() <= 2 * float(hm["lr"]) * (1 + 1e-3)


@pytest.mark.parametrize("t", [64, 66])
def test_moe_a2a_card_matches_cpu(dev, t):
    """``_moe_a2a`` over a (data 2, model 2) mesh of the card's entries and
    of the CPU's (reduced granite-moe, float32, TF32 off): the same
    routings dropped, the outputs within 1e-5."""
    from repro_torch.dist.sharding import NamedSharding, spec_for_param
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import MeshPlan
    from repro_torch.models.moe import _moe_a2a

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    m = cfg.moe
    rng = np.random.default_rng(t)
    first = rng.choice(m.n_experts, size=t, p=[0.7, 0.1, 0.1, 0.1])
    te = torch.as_tensor(np.stack([first, (first + 1 + rng.integers(
        0, m.n_experts - 1, size=t)) % m.n_experts], axis=1))
    tp = torch.as_tensor(rng.random((t, m.top_k)), dtype=torch.float32)
    xf = torch.as_tensor(rng.normal(size=(t, cfg.d_model)),
                         dtype=torch.float32)
    shapes = {"w_gate": (m.n_experts, cfg.d_model, m.d_expert),
              "w_up": (m.n_experts, cfg.d_model, m.d_expert),
              "w_down": (m.n_experts, m.d_expert, cfg.d_model)}
    weights = {k: rng.normal(size=s).astype(np.float32) / 8
               for k, s in shapes.items()}
    runs = []
    for d in ("cpu", dev):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[d] * 4)
        p = {k: NamedSharding(mesh, spec_for_param(
            f"ffn/{k}", w.shape, mesh, [])).shard(w)
            for k, w in weights.items()}
        plan = MeshPlan(mesh, ("data",))

        def run(w):
            outs = _moe_a2a(plan, list(torch.chunk(xf.to(d), 2)),
                            list(torch.chunk(te.to(d), 2)),
                            list(torch.chunk(w.to(d), 2)), p, cfg)
            return torch.cat(outs).cpu()

        kept = []
        for j in range(m.top_k):
            one = torch.zeros_like(tp)
            one[:, j] = 1.0
            kept.append(run(one).ne(0).any(dim=1))
        runs.append((run(tp), kept))
    (want, want_kept), (got, got_kept) = runs
    for a, b in zip(got_kept, want_kept):
        assert torch.equal(a, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
