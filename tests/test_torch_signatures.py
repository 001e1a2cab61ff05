"""The port's entry points take the reference's parameters in the
reference's order, with only a trailing ``device`` added where they run
on the card and nothing added where they run on the host only, raise the
reference's ``ValueError`` where it does, take the port's own mesh and
nothing else for ``mesh=``, and refuse each value they cannot take yet
with ``NotImplementedError`` naming its ROADMAP.md item."""
import inspect

import numpy as np
import pytest

from repro.core import build_filtration as ref_build
from repro.core import compute_ph as ref_compute_ph
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.core.packed_reduce import reduce_dimension_packed as ref_packed
from repro.core.reduction import reduce_dimension as ref_reduce
from repro.core.serial_parallel import reduce_dimension_batched as ref_batched
from repro.scale.sparse_input import build_filtration_coo as ref_coo
from repro_torch import compute_ph
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core.packed_reduce import reduce_dimension_packed
from repro_torch.core.reduction import reduce_dimension
from repro_torch.core.serial_parallel import reduce_dimension_batched
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.scale import build_filtration_coo


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


def _same_default(a, b) -> bool:
    return (a.default is b.default or a.default == b.default
            or (isinstance(a.default, float) and np.isnan(a.default)
                and np.isnan(b.default)))


@pytest.mark.parametrize("ref,port", [(ref_compute_ph, compute_ph),
                                      (ref_packed, reduce_dimension_packed)])
def test_signature_matches_reference(ref, port):
    want, got = _params(ref), _params(port)
    assert [p.name for p in got] == [p.name for p in want] + ["device"]
    for a, b in zip(want, got):
        assert a.kind == b.kind, a.name
        assert _same_default(a, b), a.name
    assert got[-1].default is None


@pytest.mark.parametrize("ref,port", [(ref_reduce, reduce_dimension),
                                      (ref_batched, reduce_dimension_batched),
                                      (ref_coo, build_filtration_coo)])
def test_host_signature_is_the_reference(ref, port):
    """Host-only entry points: exactly the reference's parameters."""
    want, got = _params(ref), _params(port)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(want, got):
        assert a.kind == b.kind, a.name
        assert _same_default(a, b), a.name


def _cloud():
    return np.random.default_rng(5).normal(size=(14, 3))


def _cpu_mesh(p):
    return make_data_mesh(p, devices=["cpu"] * p)


@pytest.mark.parametrize("kw,item", [
    (dict(sanitize=True), r"§1 item 7$"),
    (dict(sanitize=True, engine="packed", mesh=_cpu_mesh(2)), r"§1 item 7$"),
])
def test_compute_ph_refusals_name_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        compute_ph(points=_cloud(), maxdim=1, device="cpu", **kw)


@pytest.mark.parametrize("value", ["1", "yes"])
def test_repro_sanitize_env_is_refused(monkeypatch, value):
    """``sanitize=None`` reads ``REPRO_SANITIZE`` as the reference does; the
    variable arming the sanitizer is refused as ``sanitize=True`` is."""
    monkeypatch.setenv("REPRO_SANITIZE", value)
    with pytest.raises(NotImplementedError, match=r"§1 item 7$"):
        compute_ph(points=_cloud(), maxdim=1, device="cpu")


@pytest.mark.parametrize("value,sanitize", [("1", False), ("0", None),
                                            ("", None)])
def test_repro_sanitize_env_off_runs(monkeypatch, value, sanitize):
    """``sanitize=False`` with the variable set, or the variable at "0" or
    empty, runs normally: the reference's diagrams."""
    monkeypatch.setenv("REPRO_SANITIZE", value)
    kw = dict(points=_cloud(), maxdim=1, engine="packed")
    mine = compute_ph(device="cpu", sanitize=sanitize, **kw)
    ref = ref_compute_ph(sanitize=False, **kw)
    for d in (0, 1):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert "sanitize_checks" not in mine.stats


@pytest.mark.parametrize("case", ["packed", "tiled", "mismatch"])
def test_compute_ph_mesh_cases(case):
    """``mesh=`` in ``compute_ph``: a foreign mesh object (a jax mesh, or
    anything but the port's ``Mesh``) raises ``TypeError``; a real mesh
    runs the sharded harvest with the reference's diagrams; an
    ``n_shards`` that disagrees with the mesh raises the reference's
    ``ValueError``."""
    kw = dict(points=_cloud(), maxdim=1, device="cpu")
    if case == "packed":
        with pytest.raises(TypeError, match="Mesh"):
            compute_ph(mesh=object(), engine="packed", **kw)
    elif case == "tiled":
        mine = compute_ph(mesh=_cpu_mesh(2), backend="tiled", tile_m=4,
                          tile_n=4, **kw)
        ref = ref_compute_ph(points=_cloud(), maxdim=1)
        for d in (0, 1):
            assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
        assert mine.stats["n_shards"] == 2
    else:
        with pytest.raises(ValueError, match="n_shards=2 disagrees with "
                           "the mesh's data-axis size 3"):
            compute_ph(mesh=_cpu_mesh(3), engine="packed", n_shards=2, **kw)


@pytest.mark.parametrize("kw", [dict(n_shards=2),
                                dict(n_shards=3, exchange_every=1),
                                dict(exchange_every=2),
                                dict(n_shards=1, exchange_every=7),
                                dict(n_shards=0)])
def test_compute_ph_takes_n_shards_and_exchange_every(kw):
    """The distributed reduction's options, at P = 1 too: the reference's
    diagrams and shard count."""
    kw = dict(points=_cloud(), maxdim=2, engine="packed", batch_size=8, **kw)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["h1_n_shards"] == ref.stats["h1_n_shards"]


@pytest.mark.parametrize("kw,match", [
    (dict(n_shards=2, engine="batch"), "engine='packed'"),
    (dict(n_shards=2, engine="single"), "engine='packed'"),
    (dict(exchange_every=0, engine="packed"), "exchange_every"),
    (dict(mesh=object()), "mesh sharding requires backend='tiled'"),
    (dict(mesh=object(), engine="batch", backend="tiled",
          filtration=object()), "mesh sharding requires"),
])
def test_compute_ph_value_errors_match_reference(kw, match):
    for fn in (ref_compute_ph, lambda **k: compute_ph(device="cpu", **k)):
        with pytest.raises(ValueError, match=match):
            fn(points=_cloud(), maxdim=1, **kw)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_compute_ph_takes_engine_batch(mode):
    kw = dict(points=_cloud(), maxdim=2, engine="batch", mode=mode,
              batch_size=4)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["h1_batch_size"] == 4


def test_compute_ph_takes_exchange_every():
    kw = dict(points=_cloud(), maxdim=2, engine="packed", exchange_every=4)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d


def _h1(build, h0, adapter):
    f = build(points=_cloud())
    cols = np.arange(f.n_e - 1, -1, -1, dtype=np.int64)
    return adapter(f), cols, h0(f).death_edges


@pytest.mark.parametrize("kw,item", [
    (dict(seed_gens={}), r"§1 item 7$"),
    (dict(commit_sink=[]), r"§1 item 7$"),
    (dict(essential_log=[]), r"§1 item 7$"),
])
def test_reduce_dimension_packed_refusals_name_their_item(kw, item):
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    with pytest.raises(NotImplementedError, match=item):
        reduce_dimension_packed(adapter, cols, cleared=cleared,
                                device="cpu", **kw)


@pytest.mark.parametrize("case", ["foreign", "mismatch", "runs"])
def test_reduce_dimension_packed_mesh_cases(case):
    """``mesh=`` in ``reduce_dimension_packed``: a foreign object raises
    ``TypeError``, an ``n_shards`` that disagrees with the mesh the
    reference's ``ValueError``, and a real mesh runs the loop-back's
    split."""
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    kw = dict(cleared=cleared, batch_size=8)
    if case == "foreign":
        with pytest.raises(TypeError, match="Mesh"):
            reduce_dimension_packed(adapter, cols, mesh=object(), **kw)
    elif case == "mismatch":
        with pytest.raises(ValueError, match="n_shards=4 disagrees"):
            reduce_dimension_packed(adapter, cols, mesh=_cpu_mesh(2),
                                    n_shards=4, **kw)
    else:
        mine = reduce_dimension_packed(adapter, cols, mesh=_cpu_mesh(2),
                                       **kw)
        loop = reduce_dimension_packed(adapter, cols, n_shards=2,
                                       device="cpu", **kw)
        assert np.array_equal(loop.diagram(), mine.diagram())
        for k in ("n_shards", "n_supersteps", "n_exchange_rounds",
                  "exchange_bytes", "n_tournament_reductions"):
            assert mine.stats[k] == loop.stats[k], k


@pytest.mark.parametrize("kw", [dict(n_shards=2), dict(n_shards=4,
                                                       exchange_every=1),
                                dict(exchange_every=1)])
def test_reduce_dimension_packed_takes_shards_and_cadence(kw):
    adapter, cols, cleared = _h1(ref_build, ref_h0, ref_h1_adapter)
    ref = ref_packed(adapter, cols, cleared=cleared, batch_size=8, **kw)
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    mine = reduce_dimension_packed(adapter, cols, cleared=cleared,
                                   batch_size=8, device="cpu", **kw)
    assert np.array_equal(ref.diagram(), mine.diagram())
    for k in ("n_shards", "n_supersteps", "n_exchange_rounds",
              "exchange_bytes", "n_tournament_reductions",
              "n_sweep_probes"):
        assert mine.stats[k] == ref.stats[k], k


def test_reduce_dimension_packed_refuses_cadence_below_one():
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    with pytest.raises(ValueError, match="exchange_every"):
        reduce_dimension_packed(adapter, cols, cleared=cleared,
                                exchange_every=0, device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_reduce_dimension_packed_positional_reference_call(use_kernels):
    """The reference's positional order, every parameter given: adapter,
    column_ids, mode, cleared, batch_size, store_budget_bytes, use_kernels,
    n_shards, mesh, cache, exchange_every, seed_gens, commit_sink,
    essential_log."""
    args = ("explicit", None, 8, None, use_kernels, 1, None, None, 4, None,
            None, None)
    adapter, cols, cleared = _h1(ref_build, ref_h0, ref_h1_adapter)
    ref = ref_packed(adapter, cols, args[0], cleared, *args[2:])
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    mine = reduce_dimension_packed(adapter, cols, args[0], cleared,
                                   *args[2:], device="cpu")
    assert np.array_equal(ref.diagram(), mine.diagram())
    np.testing.assert_array_equal(ref.pivot_lows, mine.pivot_lows)
    assert mine.stats["n_shards"] == 1


@pytest.mark.parametrize("kw", [dict(seed_gens={}), dict(commit_log=[]),
                                dict(essential_log=[])])
@pytest.mark.parametrize("fn", [reduce_dimension, reduce_dimension_batched])
def test_host_engine_refusals_name_their_item(fn, kw):
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    with pytest.raises(NotImplementedError, match=r"§1 item 7$"):
        fn(adapter, cols, cleared=cleared, **kw)
