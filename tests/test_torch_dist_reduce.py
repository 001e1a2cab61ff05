"""The port's distributed packed reduction (``n_shards``: fused supersteps,
tournament catch-up, exact commit sweep, Elias–Fano pivot exchange over a
host loop-back) against the reference's on the same numpy inputs.

The cases mirror ``tests/test_dist_reduce.py``'s host-partitioned sweep:
``fractal_like(40)`` at P in {1, 2, 4} x {explicit, implicit}, a tie-heavy
grid at P in {2, 3}, store budgets {None, 4096} at P in {2, 4}, exchange
cadences {1, 3, 8} at P = 4 and a hypothesis sweep over P in 1..5.  Every
diagram is ``np.array_equal`` to the reference's (tolerance 0).  Both
packages run their numpy block path here (``use_kernels`` resolves False
on the CPU in both), so the deterministic counters (supersteps, exchange
rounds and bytes, tournament reductions, sweep probes, rounds, reductions)
are equal too.  The port's kernel path (``use_kernels=True``: the kernels'
plain versions on the CPU) gives the same diagrams at P = 4.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import compute_ph as ref_compute_ph
from repro.data.pointclouds import fractal_like
from repro_torch import compute_ph
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import (h2_columns, make_h1_adapter,
                                       make_h2_adapter)
from repro_torch.core.packed_reduce import (_PackedBatch,
                                            reduce_dimension_packed)

DIMS = (0, 1, 2)
COUNTERS = ("n_supersteps", "n_exchange_rounds", "exchange_bytes",
            "n_tournament_reductions", "n_sweep_probes", "n_rounds",
            "n_reductions")


def tie_heavy_cloud(seed, n=16):
    """Integer grid points: many exactly-equal pairwise distances."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=(n, 3)).astype(np.float64)


def both(**kw):
    """The same call through the reference and the port (on the CPU)."""
    return ref_compute_ph(**kw), compute_ph(device="cpu", **kw)


def assert_same(ref, got, label, counters=True):
    for dim in DIMS:
        assert np.array_equal(ref.diagrams[dim], got.diagrams[dim]), \
            (label, dim)
    if not counters:
        return
    for h in ("h1", "h2"):
        assert got.stats[f"{h}_use_kernels"] == 0.0
        for k in ("n_shards",) + COUNTERS:
            assert got.stats[f"{h}_{k}"] == ref.stats[f"{h}_{k}"], \
                (label, h, k)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dist_packed_matches_reference(mode, n_shards):
    ref, got = both(dists=fractal_like(40, seed=3), maxdim=2,
                    engine="packed", mode=mode, n_shards=n_shards,
                    batch_size=64)
    assert_same(ref, got, f"P={n_shards} {mode}")
    assert got.stats["h1_n_shards"] == n_shards
    if n_shards > 1:   # H2 is the long pass: exchanges must really happen
        rounds = got.stats["h1_n_exchange_rounds"] \
            + got.stats["h2_n_exchange_rounds"]
        wire = got.stats["h1_exchange_bytes"] + got.stats["h2_exchange_bytes"]
        assert rounds >= 1 and wire > 0
        assert got.stats["h2_n_tournament_reductions"] > 0
        assert got.stats["h2_n_sweep_probes"] > 0
    else:
        assert got.stats["h2_n_exchange_rounds"] == 0


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_dist_packed_tie_heavy(mode, n_shards):
    """Exactly-equal filtration values, where a wrong tie-break in the
    distributed schedule would show."""
    ref, got = both(points=tie_heavy_cloud(5, n=18), maxdim=2,
                    engine="packed", mode=mode, n_shards=n_shards,
                    batch_size=32)
    assert_same(ref, got, f"ties P={n_shards} {mode}")
    single = ref_compute_ph(points=tie_heavy_cloud(5, n=18), maxdim=2,
                            engine="single", mode=mode)
    assert_same(single, got, "against the single engine", counters=False)


@pytest.mark.parametrize("budget", [None, 4096])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_packed_store_budget(n_shards, budget):
    """Spill-to-implicit under a store budget: the wire then ships
    δ-expansions (``track_gens``), and the diagrams do not move."""
    ref, got = both(dists=fractal_like(36, seed=9), maxdim=2,
                    engine="packed", n_shards=n_shards, batch_size=48,
                    memory_budget_bytes=budget)
    assert_same(ref, got, f"P={n_shards} budget={budget}")
    if budget is not None:
        assert got.stats["h2_n_spilled"] == ref.stats["h2_n_spilled"]


@pytest.mark.parametrize("exchange_every", [1, 3, 8])
def test_dist_packed_cadence(exchange_every):
    """The cadence moves exchange rounds and wire bytes, not diagrams."""
    dists = fractal_like(36, seed=11)
    ref, got = both(dists=dists, maxdim=2, engine="packed", n_shards=4,
                    mode="implicit", batch_size=48,
                    exchange_every=exchange_every)
    assert_same(ref, got, f"ee={exchange_every}")
    one = compute_ph(dists=dists, maxdim=2, engine="packed", n_shards=1,
                     device="cpu")
    assert_same(one, got, "against P = 1", counters=False)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**16), n_shards=st.integers(1, 5),
       mode=st.sampled_from(["explicit", "implicit"]))
def test_dist_packed_hypothesis(seed, n_shards, mode):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(int(rng.integers(10, 26)), 3))
    ref, got = both(points=pts, maxdim=2, engine="packed", mode=mode,
                    n_shards=n_shards, batch_size=16)
    assert_same(ref, got, f"hyp P={n_shards} {mode}")


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dist_packed_multi_segment_columns(n_shards):
    """torus4 at n = 2,000: the host engine's batches grow past one
    segment, so some committed R columns are segment-major.  The
    reference's wire refuses them (its distributed reduction raises); the
    port's ships them sorted and gives the reference's P = 1 diagrams."""
    from repro.data.pointclouds import clifford_torus

    kw = dict(points=clifford_torus(2000, seed=0), tau_max=0.3, maxdim=1,
              engine="packed")
    with pytest.raises(ValueError, match="sorted"):
        ref_compute_ph(n_shards=n_shards, **kw)
    ref = ref_compute_ph(**kw)
    got = compute_ph(device="cpu", n_shards=n_shards, **kw)
    for dim in (0, 1):
        assert np.array_equal(ref.diagrams[dim], got.diagrams[dim]), dim
    assert got.stats["h1_n_expansions"] > 0
    assert got.stats["h1_n_exchange_rounds"] > 0


def _reduce_h1_h2(filt, **kw):
    """H1* then H2* through the port's packed engine directly."""
    h0 = compute_h0(filt)
    cols1 = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
    r1 = reduce_dimension_packed(make_h1_adapter(filt, sparse=True), cols1,
                                 cleared=h0.death_edges, device="cpu", **kw)
    cols2 = h2_columns(filt, r1.pivot_lows, sparse=True)
    r2 = reduce_dimension_packed(make_h2_adapter(filt, sparse=True), cols2,
                                 device="cpu", **kw)
    return r1, r2


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_dist_kernel_path_matches(mode):
    """``use_kernels=True`` at P = 4: the fused P·B-row block through the
    kernel round (``xor_rows_kernels``: eager consolidation, 128-word
    buckets) and, in one-slice supersteps, the serial pre-pass — here
    through the kernels' plain versions — gives the numpy path's diagrams
    and the reference's."""
    dists = fractal_like(40, seed=3)
    filt = build_filtration(dists=dists)
    kern = _reduce_h1_h2(filt, mode=mode, n_shards=4, batch_size=64,
                         use_kernels=True)
    host = _reduce_h1_h2(filt, mode=mode, n_shards=4, batch_size=64,
                         use_kernels=False)
    for k, h in zip(kern, host):
        assert np.array_equal(k.diagram(), h.diagram())
        np.testing.assert_array_equal(k.pivot_lows, h.pivot_lows)
        assert k.stats["use_kernels"] == 1.0
        assert k.stats["n_supersteps"] == h.stats["n_supersteps"]
    ref = ref_compute_ph(dists=dists, maxdim=2, engine="packed", mode=mode,
                         n_shards=4, batch_size=64)
    assert np.array_equal(ref.diagrams[1], kern[0].diagram())
    assert np.array_equal(ref.diagrams[2], kern[1].diagram())
    assert kern[1].stats["n_exchange_rounds"] > 0


def test_dist_kernel_path_prepass_in_one_slice_superstep(monkeypatch):
    """A superstep that holds a single slice (the queue's tail) runs the
    kernel serial pre-pass on its whole block, V-words and all; here it
    reduces, and the diagrams still equal the numpy path's and the
    reference's at P = 2."""
    pts = np.random.default_rng(2).normal(size=(32, 3))
    filt = build_filtration(points=pts)
    seen = []
    real = _PackedBatch._serial_kernel_prepass

    def counted(self, *args):
        n = real(self, *args)
        seen.append((self.B, n))
        return n

    monkeypatch.setattr(_PackedBatch, "_serial_kernel_prepass", counted)
    kern = _reduce_h1_h2(filt, n_shards=2, batch_size=32, use_kernels=True)
    assert seen and sum(n for _, n in seen) > 0
    assert all(b <= 32 for b, _ in seen)          # one slice, never fused
    host = _reduce_h1_h2(filt, n_shards=2, batch_size=32, use_kernels=False)
    ref = ref_compute_ph(points=pts, maxdim=2, engine="packed", n_shards=2,
                         batch_size=32)
    for d, (k, h) in enumerate(zip(kern, host), start=1):
        assert np.array_equal(k.diagram(), h.diagram()), d
        assert np.array_equal(ref.diagrams[d], k.diagram()), d


def test_restricted_serial_pass_skips_the_kernel_prepass(monkeypatch):
    """The kernel pre-pass assumes the whole block: a slice-restricted
    serial pass (``rows=``) must walk on the host alone."""
    cob = np.array([[5, 9], [5, 7], [3, 9], [3, 8]], dtype=np.int64)
    blk = _PackedBatch(cob, [], use_kernels=True,
                       device=torch.device("cpu"))

    def refuse(*a, **k):
        raise AssertionError("kernel pre-pass on a restricted slice")

    monkeypatch.setattr(_PackedBatch, "_serial_kernel_prepass", refuse)
    gens = [dict() for _ in range(4)]
    n_red, changed = blk.serial_pass(gens, [10, 11, 12, 13],
                                     rows=np.arange(2, 4))
    assert n_red == 1 and changed.tolist() == [3]
    assert blk.lows.tolist() == [5, 5, 3, 8]     # rows 0-1 untouched
    assert gens[3] == {12: 1}
    with pytest.raises(AssertionError, match="restricted"):
        blk.serial_pass(gens, [10, 11, 12, 13])


def test_sim_wall_matches_bookkeeping_at_4_shards():
    """The span-derived critical path and the engine's own bookkeeping are
    two accountings of one timeline and agree at P = 4 (as
    ``tests/test_obs.py`` holds the reference)."""
    pts = np.random.default_rng(5).normal(size=(32, 3))
    res = compute_ph(points=pts, engine="packed", n_shards=4, device="cpu")
    for dim in ("h1", "h2"):
        wall = res.stats[f"{dim}_sim_wall_s"]
        book = res.stats[f"{dim}_sim_wall_bookkeeping_s"]
        assert wall == pytest.approx(book, rel=1e-9, abs=1e-12), dim
        assert wall > 0.0


def test_stats_key_set_matches_reference_at_4_shards():
    pts = np.random.default_rng(6).normal(size=(20, 3))
    ref, got = both(points=pts, maxdim=2, engine="packed", n_shards=4,
                    batch_size=16)
    assert set(ref.stats) == set(got.stats)
