"""Port filtrations on the CPU against the JAX package's, field by field.

Same numpy clouds from seeds through ``repro`` and ``repro_torch``: dense
and tiled builds (several tile sizes, a tie-heavy cloud, ``tau_max`` on a
tie), the f32-candidate harvest (the port's plain version against the
reference's Pallas kernel in interpret mode), ``estimate_tau_max`` and H0.
Every field is held array-equal: the exact f64 lengths are the contract.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.filtration import build_filtration as ref_build
from repro.core.h0 import compute_h0 as ref_h0
from repro.scale.budget import estimate_tau_max as ref_estimate
from repro.scale.tiles import build_filtration_tiled as ref_tiled
from repro.data import pointclouds as ref_clouds
from repro_torch.core.filtration import (build_filtration,
                                         filtration_from_arrays)
from repro_torch.core.h0 import compute_h0
from repro_torch.data import pointclouds
from repro_torch.scale.budget import estimate_tau_max
from repro_torch.scale.tiles import build_filtration_tiled


def assert_filtrations_equal(ref, mine):
    a = dataclasses.asdict(ref)
    b = dataclasses.asdict(mine)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def cloud(seed, n=40, d=3):
    return np.random.default_rng(seed).normal(size=(n, d))


def tie_heavy(seed, n=30):
    """Integer grid points: many exactly-equal pairwise distances."""
    return np.random.default_rng(seed).integers(0, 4, size=(n, 3)).astype(
        np.float64)


@pytest.mark.parametrize("seed,tau", [(0, np.inf), (1, 1.2), (2, 0.7)])
def test_single_row_lookup_order_equal_reference(seed, tau):
    """The one-row search of ``_lookup_order`` gives the reference's
    answers and the port's own batched search's, on every vertex (an
    isolated one included at tau 0.7) and on queries outside 0..n."""
    from repro.core.coboundary import _lookup_order as ref_lookup
    from repro_torch.core.coboundary import _lookup_order

    pts = cloud(seed)
    rf, tf = (ref_build(points=pts, tau_max=tau),
              build_filtration(points=pts, tau_max=tau))
    rng = np.random.default_rng(seed)
    v = rng.integers(-2, tf.n + 3, size=(tf.n, 12)).astype(np.int64)
    v[:, :4] = tf.nbr_vtx[:, :4]                  # hits, and pads at n
    rows = np.arange(tf.n, dtype=np.int64)
    batched = _lookup_order(tf, rows, v)
    for r in range(tf.n):
        got = _lookup_order(tf, rows[r:r + 1], v[r:r + 1])
        assert got.dtype == np.int64 and got.shape == (1, 12)
        np.testing.assert_array_equal(got, batched[r:r + 1])
        np.testing.assert_array_equal(
            got, ref_lookup(rf, rows[r:r + 1], v[r:r + 1]))
    assert (batched >= 0).any() and (batched < 0).any()


@pytest.mark.parametrize("seed,tau", [(0, np.inf), (1, 1.2), (2, 0.7)])
def test_dense_filtration_equal(seed, tau):
    pts = cloud(seed)
    assert_filtrations_equal(ref_build(points=pts, tau_max=tau),
                             build_filtration(points=pts, tau_max=tau))


@pytest.mark.parametrize("tile", [(7, 7), (16, 5), (64, 64), (13, 40)])
def test_tiled_numpy_equal_reference_and_dense(tile):
    pts = cloud(3, n=57, d=4)
    tau = 1.3
    tm, tn = tile
    mine, stats = build_filtration_tiled(points=pts, tau_max=tau, tile_m=tm,
                                         tile_n=tn, backend="numpy",
                                         device="cpu", return_stats=True)
    ref, rstats = ref_tiled(points=pts, tau_max=tau, tile_m=tm, tile_n=tn,
                            backend="numpy", return_stats=True)
    assert_filtrations_equal(ref, mine)
    dense = build_filtration(points=pts, tau_max=tau)
    np.testing.assert_array_equal(dense.edges, mine.edges)
    np.testing.assert_array_equal(dense.edge_len, mine.edge_len)
    for f in ("n", "n_e", "tiles_visited", "peak_tile_bytes",
              "harvest_bytes", "merge_peak_bytes", "base_memory_bytes"):
        assert getattr(stats, f) == getattr(rstats, f), f


@pytest.mark.parametrize("seed", [0, 4])
def test_tie_heavy_tau_on_a_tie(seed):
    """``tau_max`` exactly equal to a (multiply attained) pair length."""
    pts = tie_heavy(seed)
    tau = float(np.sqrt(2.0))
    ref = ref_build(points=pts, tau_max=tau)
    assert (ref.edge_len == tau).sum() > 1
    assert_filtrations_equal(ref, build_filtration(points=pts, tau_max=tau))
    for tm, tn in ((8, 8), (11, 30)):
        for backend in ("numpy", "kernel"):
            mine = build_filtration_tiled(points=pts, tau_max=tau, tile_m=tm,
                                          tile_n=tn, backend=backend,
                                          device="cpu")
            assert_filtrations_equal(
                ref_tiled(points=pts, tau_max=tau, tile_m=tm, tile_n=tn,
                          backend="numpy"), mine)


@pytest.mark.parametrize("d,tile", [(4, 16), (9, 24)])
def test_f32_candidate_harvest_matches_pallas(d, tile):
    """The port's f32-candidate path (plain version on the CPU) against the
    reference's Pallas path in interpret mode: the same filtration, and
    candidate counts that agree up to the pairs whose float32 distance
    lands on the other side of the threshold under another summation
    order (at most 1%)."""
    pts = cloud(5, n=70, d=d)
    tau = 1.1 if d == 4 else 2.4
    mine, stats = build_filtration_tiled(points=pts, tau_max=tau,
                                         tile_m=tile, tile_n=tile,
                                         backend="kernel", device="cpu",
                                         return_stats=True)
    ref, rstats = ref_tiled(points=pts, tau_max=tau, tile_m=tile,
                            tile_n=tile, backend="pallas", interpret=True,
                            return_stats=True)
    assert_filtrations_equal(ref, mine)
    assert stats.backend == "kernel"
    assert stats.candidate_pairs >= mine.n_e
    assert abs(stats.candidate_pairs - rstats.candidate_pairs) <= \
        max(2, rstats.candidate_pairs // 100)
    assert stats.peak_tile_bytes == rstats.peak_tile_bytes


def test_tiled_dists_input_equal():
    pts = cloud(6, n=33)
    dists = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    mine = build_filtration_tiled(dists=dists, tau_max=1.5, tile_m=10,
                                  tile_n=10, device="cpu")
    assert_filtrations_equal(
        ref_tiled(dists=dists, tau_max=1.5, tile_m=10, tile_n=10), mine)


@pytest.mark.parametrize("budget", [20_000, 60_000, 10**9])
def test_estimate_tau_max_equal(budget):
    pts = pointclouds.clifford_torus(300, seed=2)
    assert estimate_tau_max(pts, budget) == ref_estimate(pts, budget)


@pytest.mark.parametrize("seed", [0, 1])
def test_h0_equal(seed):
    pts = tie_heavy(seed)
    ref = ref_build(points=pts, tau_max=1.5)
    mine = build_filtration(points=pts, tau_max=1.5)
    a, b = ref_h0(ref), compute_h0(mine)
    np.testing.assert_array_equal(a.pairs, b.pairs)
    np.testing.assert_array_equal(a.death_edges, b.death_edges)
    assert a.n_essential == b.n_essential
    np.testing.assert_array_equal(a.diagram(), b.diagram())


def test_pointclouds_equal():
    np.testing.assert_array_equal(pointclouds.clifford_torus(50, seed=3),
                                  ref_clouds.clifford_torus(50, seed=3))
    np.testing.assert_array_equal(pointclouds.o3_points(20, seed=1),
                                  ref_clouds.o3_points(20, seed=1))


def test_filtration_from_arrays_carries_every_field():
    ref = ref_build(points=cloud(8, n=25), tau_max=1.4)
    assert_filtrations_equal(ref,
                             filtration_from_arrays(dataclasses.asdict(ref)))
    fields = dataclasses.asdict(ref)
    del fields["edges"]
    with pytest.raises(ValueError):
        filtration_from_arrays(fields)
