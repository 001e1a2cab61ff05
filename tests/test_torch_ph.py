"""End-to-end: ``repro_torch.compute_ph(device="cpu")`` against
``repro.core.compute_ph`` on the same numpy clouds, diagrams
``np.array_equal`` per dimension (the reference's own bar among engines).

Covers engine {single, packed} x mode {explicit, implicit} x backend
{dense, tiled} x budget {None, 2000} at maxdim 2, the packed engine's
kernel path (``use_kernels=True``: the plain versions here) against the
reference's kernel path (Pallas in interpret mode), the stats key set, a
reduction on a filtration carried across with ``filtration_from_arrays``,
and the device contract of the entry point.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import build_filtration as ref_build
from repro.core import compute_ph as ref_compute_ph
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import h2_columns as ref_h2_columns
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.core.homology import make_h2_adapter as ref_h2_adapter
from repro.core.packed_reduce import reduce_dimension_packed as ref_packed
from repro_torch import compute_ph
from repro_torch.core.filtration import build_filtration, filtration_from_arrays
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import h2_columns, make_h1_adapter, \
    make_h2_adapter
from repro_torch.core.packed_reduce import reduce_dimension_packed


def cloud(seed, n=16, d=3):
    return np.random.default_rng(seed).normal(size=(n, d))


def assert_same_diagrams(a, b, dims=(0, 1, 2)):
    for d in dims:
        assert a.diagrams[d].dtype == b.diagrams[d].dtype
        assert np.array_equal(a.diagrams[d], b.diagrams[d]), d


@pytest.mark.parametrize("budget", [None, 2000])
@pytest.mark.parametrize("backend", ["dense", "tiled"])
@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("engine", ["single", "packed"])
def test_compute_ph_matches_reference(engine, mode, backend, budget):
    pts = cloud(7, n=18)
    kw = dict(points=pts, tau_max=1.8, maxdim=2, mode=mode, engine=engine,
              backend=backend, memory_budget_bytes=budget, batch_size=16,
              tile_m=7, tile_n=11)
    ref = ref_compute_ph(**kw)
    mine = compute_ph(device="cpu", **kw)
    assert_same_diagrams(ref, mine)
    assert mine.diagrams[1].shape[0] > 0


@pytest.mark.parametrize("seed", [0, 3])
def test_tie_heavy_packed_matches_reference(seed):
    pts = np.random.default_rng(seed).integers(0, 4, size=(16, 3)).astype(
        np.float64)
    for mode in ("explicit", "implicit"):
        kw = dict(points=pts, maxdim=2, mode=mode, engine="packed",
                  batch_size=16)
        assert_same_diagrams(ref_compute_ph(**kw),
                             compute_ph(device="cpu", **kw))


def test_budget_picks_tau_like_reference():
    pts = cloud(2, n=40)
    kw = dict(points=pts, maxdim=1, engine="packed", backend="tiled",
              memory_budget_bytes=6000, tile_m=16, tile_n=16)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    assert_same_diagrams(ref, mine, dims=(0, 1))
    assert mine.stats["tau_max_estimated"] == ref.stats["tau_max_estimated"]


def test_kernel_path_matches_reference_kernel_path():
    """``use_kernels=True`` drives the kernel path's own control flow
    (eager consolidation, 128-word buckets, 32-row padding, the V-word
    serial pre-pass) — here through the plain versions — against the
    reference's kernel path (Pallas interpret) and both host paths, H1* and
    H2*."""
    pts = cloud(13, n=14)
    rf = ref_build(points=pts)
    tf = build_filtration(points=pts)
    rh0, th0 = ref_h0(rf), compute_h0(tf)
    cols = np.arange(tf.n_e - 1, -1, -1, dtype=np.int64)
    r1 = ref_packed(ref_h1_adapter(rf), cols, cleared=rh0.death_edges,
                    use_kernels=True, batch_size=16)
    t1 = reduce_dimension_packed(make_h1_adapter(tf), cols,
                                 cleared=th0.death_edges, use_kernels=True,
                                 batch_size=16, device="cpu")
    t1h = reduce_dimension_packed(make_h1_adapter(tf), cols,
                                  cleared=th0.death_edges, use_kernels=False,
                                  batch_size=16, device="cpu")
    assert np.array_equal(r1.diagram(), t1.diagram())
    assert np.array_equal(t1h.diagram(), t1.diagram())
    np.testing.assert_array_equal(r1.pivot_lows, t1.pivot_lows)
    assert t1.stats["use_kernels"] == 1.0 and t1h.stats["use_kernels"] == 0.0
    for k in ("n_reductions", "n_rounds", "n_consolidations", "n_evictions",
              "n_expansions", "n_pairs", "peak_block_bytes"):
        assert t1.stats[k] == r1.stats[k], k

    cols2 = h2_columns(tf, t1.pivot_lows, sparse=True)
    np.testing.assert_array_equal(
        cols2, ref_h2_columns(rf, r1.pivot_lows, sparse=True))
    r2 = ref_packed(ref_h2_adapter(rf), cols2, use_kernels=True,
                    batch_size=16)
    t2 = reduce_dimension_packed(make_h2_adapter(tf), cols2,
                                 use_kernels=True, batch_size=16,
                                 device="cpu")
    assert np.array_equal(r2.diagram(), t2.diagram())
    assert t2.stats["n_reductions"] == r2.stats["n_reductions"]


@pytest.mark.parametrize("engine", ["single", "packed"])
def test_stats_key_set_matches_reference(engine):
    pts = cloud(4, n=14)
    kw = dict(points=pts, maxdim=2, engine=engine, backend="tiled",
              memory_budget_bytes=4000, tile_m=8, tile_n=8)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    assert set(ref.stats) == set(mine.stats)
    for k in ("n", "n_e", "base_memory_bytes", "predicted_account_bytes",
              "h1_n_pairs", "h2_n_pairs", "h1_n_columns"):
        assert ref.stats[k] == mine.stats[k], k


def test_reduction_on_carried_filtration():
    """The reference's filtration, carried across as plain arrays, reduces
    to the reference's diagrams."""
    rf = ref_build(points=cloud(21, n=17), tau_max=1.9)
    tf = filtration_from_arrays(dataclasses.asdict(rf))
    for engine in ("single", "packed"):
        assert_same_diagrams(
            ref_compute_ph(filtration=rf, maxdim=2, engine=engine),
            compute_ph(filtration=tf, maxdim=2, engine=engine, device="cpu"))


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_ph(points=cloud(0, n=8), maxdim=1)


def test_unported_options_refused():
    """``sanitize=True``, refused until the sanitizer was ported, runs:
    the reference's diagrams and check count."""
    mine = compute_ph(points=cloud(0, n=8), maxdim=1, device="cpu",
                      sanitize=True)
    ref = ref_compute_ph(points=cloud(0, n=8), maxdim=1, sanitize=True)
    for d in (0, 1):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["sanitize_checks"] == ref.stats["sanitize_checks"] > 0


@pytest.mark.parametrize("kw", [dict(backend="tiled"),
                                dict(engine="packed")])
def test_mesh_options(kw):
    """The options that waited for the port's mesh: a foreign mesh object
    raises ``TypeError``, a cpu x 3 data mesh runs and gives the
    reference's diagrams (and, with the tiled backend, its filtration)."""
    from repro_torch.launch.mesh import make_data_mesh

    pts = cloud(0, n=14)
    with pytest.raises(TypeError):
        compute_ph(points=pts, maxdim=2, device="cpu", mesh=object(), **kw)
    mesh = make_data_mesh(3, devices=["cpu"] * 3)
    mine = compute_ph(points=pts, maxdim=2, mesh=mesh, tile_m=5, tile_n=5,
                      batch_size=4, **kw)
    ref_kw = dict(kw, n_shards=3) if kw.get("engine") == "packed" else kw
    ref = ref_compute_ph(points=pts, maxdim=2, tile_m=5, tile_n=5,
                         batch_size=4, **ref_kw)
    assert_same_diagrams(ref, mine)


@pytest.mark.parametrize("backend", ["dense", "tiled"])
def test_batch_engine_runs(backend):
    kw = dict(points=cloud(3, n=16), maxdim=2, backend=backend, tile_m=6,
              tile_n=6, batch_size=5, device="cpu")
    batch = compute_ph(engine="batch", **kw)
    single = compute_ph(engine="single", **kw)
    assert_same_diagrams(single, batch)
    assert batch.stats["h1_batch_size"] == 5


def test_trace_records_spans():
    from repro_torch.obs.trace import Tracer

    tr = Tracer()
    compute_ph(points=cloud(1, n=12), maxdim=1, engine="packed",
               backend="tiled", tile_m=5, tile_n=5, device="cpu", trace=tr)
    names = {s.name for s in tr.spans}
    assert {"ph/compute_ph", "ph/filtration", "ph/h1", "harvest/tile",
            "reduce/fused", "reduce/sweep"} <= names
    tr.assert_balanced()


def test_diagram_helpers_match_reference():
    from repro.core import diagrams as ref_diagrams
    from repro_torch.core import diagrams

    res = compute_ph(points=cloud(9, n=15), maxdim=2, device="cpu")
    ref = ref_compute_ph(points=cloud(9, n=15), maxdim=2)
    for d in (0, 1, 2):
        np.testing.assert_array_equal(
            diagrams.canonicalize(res.diagrams[d]),
            ref_diagrams.canonicalize(ref.diagrams[d]))
        assert diagrams.diagrams_equal(res.diagrams[d], ref.diagrams[d])
    diagrams.assert_diagrams_equal(res.diagrams, ref.diagrams)
    shifted = res.diagrams[1] + np.array([0.0, 1e-3])
    assert not diagrams.diagrams_equal(res.diagrams[1], shifted)
