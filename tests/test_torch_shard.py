"""The sharded tile harvest (``repro_torch.scale.shard``) and the sharded
budgets and landmarks (``repro_torch.scale.budget``) against the
reference's ``scale/shard.py`` and ``scale/budget.py`` on the CPU.

A ``["cpu"] * P`` mesh runs the device rounds through the pairwise
kernel's plain version.  Bars: ``partition_tiles`` equal to the
reference's; filtrations bit-identical to the reference's serial tiled
build and to its ``n_shards=P`` sharded build, for P = 1..5, points at
d = 3 and d = 9 and a dists matrix; the ``TileStats`` that do not depend on
what crosses to the host equal (``gather_bytes`` and ``candidate_pairs``
differ by design: the port brings back index lists, not the f32 round);
budgets and landmarks exactly equal.
"""
import dataclasses
import inspect

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.scale import budget as ref_budget
from repro.scale import shard as ref_shard
from repro.scale import tiles as ref_tiles
from repro_torch.kernels import pairwise_dist
from repro_torch.launch.mesh import make_data_mesh, make_mesh
from repro_torch.scale import budget, shard, tiles

TILE = 8


def _mesh(p):
    return make_data_mesh(p, devices=["cpu"] * p)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 300), tile_m=st.integers(1, 64),
       tile_n=st.integers(1, 64), p=st.integers(1, 5))
def test_partition_tiles_matches_reference(n, tile_m, tile_n, p):
    assert shard.partition_tiles(n, tile_m, tile_n, p) \
        == ref_shard.partition_tiles(n, tile_m, tile_n, p)


def test_partition_tiles_refuses_no_shards():
    for fn in (shard.partition_tiles, ref_shard.partition_tiles):
        with pytest.raises(ValueError, match="n_shards must be >= 1"):
            fn(10, 4, 4, 0)


def _cloud(d, n=53, seed=0):
    pts = np.random.default_rng(seed + d).normal(size=(n, d))
    lens = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    return pts, lens, float(np.quantile(lens, 0.3))


INPUTS = ["points_d3", "points_d9", "dists"]


def _input(which):
    d = 9 if which == "points_d9" else 3
    pts, lens, tau = _cloud(d)
    return (dict(dists=lens) if which == "dists" else dict(points=pts)), tau


def _assert_same_filtration(a, b, what):
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    for k in fb:
        va, vb = fa[k], fb[k]
        same = (np.array_equal(va, vb) if isinstance(vb, np.ndarray)
                else va == vb)
        assert same, (what, k)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("which", INPUTS)
def test_sharded_harvest_bit_identical(which, p):
    data, tau = _input(which)
    kw = dict(tau_max=tau, tile_m=TILE, tile_n=TILE, **data)
    serial = ref_tiles.build_filtration_tiled(backend="numpy", **kw)
    ref, ref_stats = ref_shard.build_filtration_sharded(
        n_shards=p, backend="numpy", return_stats=True, **kw)
    on_mesh, mesh_stats = shard.build_filtration_sharded(
        mesh=_mesh(p), return_stats=True, **kw)
    on_host, host_stats = shard.build_filtration_sharded(
        n_shards=p, backend="numpy", device="cpu", return_stats=True, **kw)
    for got, name in ((on_mesh, "mesh"), (on_host, "n_shards")):
        _assert_same_filtration(got, serial, f"{name} vs serial")
        _assert_same_filtration(got, ref, f"{name} vs sharded")
    for stats in (mesh_stats, host_stats):
        for k in ("n", "n_e", "n_shards", "tiles_visited",
                  "shard_peak_harvest_bytes", "harvest_bytes",
                  "base_memory_bytes"):
            assert getattr(stats, k) == getattr(ref_stats, k), k
        assert stats.per_device_base_bytes() \
            == ref_stats.per_device_base_bytes()
    assert mesh_stats.backend == "kernel" and mesh_stats.mesh_axis == "data"
    assert mesh_stats.per_device_peak_bytes() == (
        mesh_stats.peak_tile_bytes + mesh_stats.gather_bytes
        + mesh_stats.shard_peak_harvest_bytes)


@pytest.mark.parametrize("p", [2, 4])
def test_device_rounds_launch_once_a_tile(monkeypatch, p):
    """An exhausted shard launches nothing: one pairwise call a tile, where
    the reference recomputes a zero block for every shard every round."""
    calls = []
    real = pairwise_dist.pairwise_sq_dists

    def counting(x, y):
        calls.append((x.shape[0], y.shape[0]))
        return real(x, y)

    monkeypatch.setattr(pairwise_dist, "pairwise_sq_dists", counting)
    pts, _, tau = _cloud(3, n=45)
    n_tiles = len(tiles.tile_grid(45, TILE, TILE))
    assert n_tiles % p                      # the last round is ragged
    shard.build_filtration_sharded(points=pts, tau_max=tau, tile_m=TILE,
                                   tile_n=TILE, mesh=_mesh(p))
    assert len(calls) == n_tiles


def test_mesh_on_a_two_axis_mesh_shards_over_data():
    pts, _, tau = _cloud(3)
    mesh = make_mesh((3, 2), ("data", "model"), devices=["cpu"] * 6)
    filt, stats = shard.build_filtration_sharded(
        points=pts, tau_max=tau, tile_m=TILE, tile_n=TILE, mesh=mesh,
        return_stats=True)
    ref = ref_tiles.build_filtration_tiled(points=pts, tau_max=tau,
                                           tile_m=TILE, tile_n=TILE,
                                           backend="numpy")
    _assert_same_filtration(filt, ref, "2-D mesh")
    assert stats.n_shards == 3


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh=object()), TypeError, "Mesh"),
    (dict(mesh=make_mesh((2,), ("model",), devices=["cpu"] * 2)),
     ValueError, "have no data axis to shard the tile grid over"),
    (dict(mesh=make_data_mesh(2, devices=["cpu"] * 2), n_shards=3),
     ValueError, "n_shards=3 disagrees with the mesh's data-axis size 2"),
    (dict(mesh=make_data_mesh(2, devices=["cpu"] * 2), device="cuda"),
     ValueError, "not of the mesh's device type 'cpu'"),
    (dict(), ValueError, "exactly one of points or dists"),
])
def test_sharded_harvest_refusals(kw, err, match):
    pts, lens, tau = _cloud(3, n=12)
    data = {} if "mesh" not in kw else dict(points=pts)
    with pytest.raises(err, match=match):
        shard.harvest_edges_sharded(tau_max=tau, tile_m=4, tile_n=4,
                                    **data, **kw)


def test_f32_dists_threshold_matches_reference():
    for tau in (0.0, 1e-3, 0.5, 1.0, 7.25, np.inf):
        assert tiles._f32_dists_threshold(tau) \
            == ref_tiles._f32_dists_threshold(tau)


def test_refine_f32_dists_tile_matches_reference():
    _, lens, tau = _cloud(3)
    thr = ref_tiles._f32_dists_threshold(tau)
    for si, sj in ((0, 8), (8, 8), (16, 40)):
        ei, ej = min(si + TILE, 53), min(sj + TILE, 53)
        cand = lens[si:ei, sj:ej].astype(np.float32) <= thr
        a, b = ref_tiles.TileStats(), tiles.TileStats()
        want = ref_tiles._refine_f32_dists_tile(cand, lens, si, ei, sj, ej,
                                                tau, a)
        got = tiles._refine_f32_dists_tile(cand, lens, si, ei, sj, ej, tau,
                                           b)
        for x, y in zip(want, got):
            assert np.array_equal(x, y)
        assert (a.peak_tile_bytes, a.candidate_pairs) \
            == (b.peak_tile_bytes, b.candidate_pairs)


@pytest.mark.parametrize("tm,tn,p,backend,d", [
    (2048, 2048, 1, "numpy", 8), (2048, 2048, 4, "numpy", 4),
    (512, 1024, 3, "kernel", 9), (64, 64, 2, "pallas", 3)])
def test_tile_transient_and_sharded_budget(tm, tn, p, backend, d):
    assert budget.tile_transient_bytes(tm, tn, p, backend, d=d) \
        == ref_budget.tile_transient_bytes(tm, tn, p, backend, d=d)
    transient = ref_budget.tile_transient_bytes(tm, tn, p, backend, d=d)
    for n, mem in ((50_000, transient + 96 * 2**20),
                   (1_000, transient + 2**20)):
        assert budget.sharded_edge_budget(n, mem, p, tm, tn, backend, d=d) \
            == ref_budget.sharded_edge_budget(n, mem, p, tm, tn, backend,
                                              d=d)
    for fn in (budget.sharded_edge_budget, ref_budget.sharded_edge_budget):
        with pytest.raises(ValueError, match="tile transient"):
            fn(100, 1000, p, tm, tn, backend, d=d)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_shards=4, tile_m=2048, tile_n=2048),
    dict(n_shards=4, tile_m=256, tile_n=256, backend="kernel"),
    dict(n_shards=2, tile_m=64, tile_n=128, seed=3, safety=0.8)])
def test_estimate_tau_max_matches_reference(kw):
    pts = np.random.default_rng(11).normal(size=(3_000, 5))
    ref_kw = dict(kw, backend="pallas") if kw.get("backend") else kw
    transient = 0
    if kw.get("n_shards", 1) > 1:
        transient = ref_budget.tile_transient_bytes(
            kw["tile_m"], kw["tile_n"], kw["n_shards"],
            ref_kw.get("backend", "numpy"), d=5)
    for mem in (transient + 2**20, transient + 8 * 2**20):
        assert budget.estimate_tau_max(pts, mem, n_samples=20_000, **kw) \
            == ref_budget.estimate_tau_max(pts, mem, n_samples=20_000,
                                           **ref_kw)


def test_estimate_tau_max_sharded_needs_tiles():
    pts = np.zeros((10, 2))
    for fn in (budget.estimate_tau_max, ref_budget.estimate_tau_max):
        with pytest.raises(ValueError, match="tile_m and tile_n"):
            fn(pts, 2**20, n_shards=2)


@pytest.mark.parametrize("k,seed,first", [(1, 0, None), (12, 0, None),
                                          (40, 5, 7), (400, 1, None)])
def test_landmarks_match_reference(k, seed, first):
    pts = np.random.default_rng(seed).normal(size=(200, 4))
    pts[150:] = pts[:50]                     # duplicates: early stop
    want_idx, want_r = ref_budget.maxmin_landmarks(pts, k, seed=seed,
                                                   first=first)
    got_idx, got_r = budget.maxmin_landmarks(pts, k, seed=seed, first=first)
    assert np.array_equal(got_idx, want_idx) and got_r == want_r
    want = ref_budget.landmark_points(pts, k, seed=seed, first=first)
    got = budget.landmark_points(pts, k, seed=seed, first=first)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and got[2] == want[2]
    assert budget.maxmin_landmarks(pts, 0)[1] == np.inf


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["harvest_edges_sharded",
                                  "build_filtration_sharded"])
def test_sharded_signatures_match_reference(name):
    """The reference's parameters in its order, ``device`` where it has
    ``interpret``."""
    want = [("device", k, d) if n == "interpret" else (n, k, d)
            for n, k, d in _params(getattr(ref_shard, name))]
    assert _params(getattr(shard, name)) == want


@pytest.mark.parametrize("name", ["tile_transient_bytes",
                                  "sharded_edge_budget", "estimate_tau_max",
                                  "maxmin_landmarks", "landmark_points",
                                  "partition_tiles"])
def test_budget_signatures_match_reference(name):
    mod = shard if name == "partition_tiles" else budget
    ref = ref_shard if name == "partition_tiles" else ref_budget
    assert _params(getattr(mod, name)) == _params(getattr(ref, name))


def test_iter_tile_edges_takes_tiles():
    """``tiles=`` in the reference's place replays an explicit tile list
    through the serial dispatch."""
    names = [p[0] for p in _params(tiles.iter_tile_edges)]
    ref_names = [p[0] for p in _params(ref_tiles.iter_tile_edges)]
    assert names[:len(ref_names)] == [
        "device" if n == "interpret" else n for n in ref_names]
    pts, _, tau = _cloud(3)
    part = shard.partition_tiles(53, TILE, TILE, 3)[1]
    got = list(tiles.iter_tile_edges(points=pts, tau_max=tau, tile_m=TILE,
                                     tile_n=TILE, backend="numpy",
                                     device="cpu", tiles=part))
    want = list(ref_tiles.iter_tile_edges(points=pts, tau_max=tau,
                                          tile_m=TILE, tile_n=TILE,
                                          backend="numpy", tiles=part))
    assert len(got) == len(want) == len(part)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
