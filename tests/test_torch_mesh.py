"""The port's device mesh (``repro_torch.launch.mesh``), the data-axis
choice (``repro_torch.dist.sharding``), the exchange's payload stacking
(``repro_torch.kernels.gf2``) and ``compute_ph(mesh=)``'s distributed
reduction, against the reference on the CPU.

The reduction over a ``["cpu"] * P`` mesh is held to the reference's own
bar (``test_dist_packed_mesh_vs_host_same_split``,
``tests/test_dist_reduce.py``): diagrams equal to the reference's
``compute_ph(n_shards=P)`` and to the port's loop-back, and every counter
of the work split equal.  One test runs the reference on a real 4-device
jax mesh in a subprocess (its ``XLA_FLAGS`` must be set before jax starts)
and holds the port's cpu x 4 mesh to its diagrams, filtration and
counters.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import build_filtration as ref_build
from repro.core import compute_ph as ref_compute_ph
from repro.data.pointclouds import fractal_like
from repro.dist import sharding as ref_sharding
from repro.kernels import gf2 as ref_gf2
from repro.launch import mesh as ref_mesh
from repro_torch import compute_ph
from repro_torch.core.filtration import filtration_from_arrays
from repro_torch.core.packed_reduce import _make_exchange
from repro_torch.dist import sharding
from repro_torch.kernels import gf2
from repro_torch.launch.mesh import (Mesh, make_data_mesh, make_mesh,
                                     make_production_mesh, mesh_device)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(p):
    return make_data_mesh(p, devices=["cpu"] * p)


# ---------------------------------------------------------------------------
# the mesh type
# ---------------------------------------------------------------------------

def test_data_mesh_reads_as_a_jax_mesh():
    m = _mesh(4)
    assert m.axis_names == ("data",)
    assert m.shape["data"] == 4 and dict(m.shape) == {"data": 4}
    assert m.devices.shape == (4,)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert make_data_mesh(devices=["cpu"] * 3).shape == {"data": 3}


def test_make_mesh_two_axes():
    m = make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 7)
    assert m.shape == {"data": 2, "model": 3} and m.devices.shape == (2, 3)
    assert m.axis_devices("data") == [torch.device("cpu")] * 2
    assert m.axis_devices("model") == [torch.device("cpu")] * 3


def test_mesh_refusals():
    with pytest.raises(ValueError, match="may not mix CPU and CUDA"):
        Mesh(np.array(["cpu", "cuda:0"], dtype=object), ("data",))
    with pytest.raises(RuntimeError, match="need 4 devices"):
        make_data_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(RuntimeError, match="need 6 devices"):
        make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 5)
    with pytest.raises(ValueError, match="axis_names"):
        Mesh(np.array(["cpu"] * 2, dtype=object), ("data", "model"))
    with pytest.raises(NotImplementedError, match="pod"):
        make_production_mesh()
    with pytest.raises(NotImplementedError):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="not of the mesh's device type"):
        mesh_device(_mesh(2), "cuda:0")
    assert mesh_device(_mesh(2)) == torch.device("cpu")
    assert mesh_device(_mesh(2), "cpu") == torch.device("cpu")


def test_data_mesh_without_a_card_raises():
    """No devices given: the CUDA devices, never the CPU in their stead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices for a"):
        make_data_mesh()
    with pytest.raises(RuntimeError, match="devices for a"):
        make_data_mesh(2)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        make_mesh((4,), ("data",))


def test_mesh_signatures_extend_the_reference():
    """The reference's parameters in its order, ``devices`` added last."""
    for name in ("make_mesh", "make_data_mesh", "make_production_mesh"):
        want = list(inspect.signature(getattr(ref_mesh, name)).parameters)
        got = list(inspect.signature(
            getattr(sys.modules[Mesh.__module__], name)).parameters)
        assert got[:len(want)] == want, name
        assert got[len(want):] in ([], ["devices"]), name


# ---------------------------------------------------------------------------
# the data-axis choice
# ---------------------------------------------------------------------------

def _duck(axes):
    return types.SimpleNamespace(axis_names=axes,
                                 shape={a: 2 for a in axes})


@pytest.mark.parametrize("axes", [("data",), ("data", "model"),
                                  ("pod", "data", "model"), ("pod",),
                                  ("pod", "model")])
def test_axis_choice_matches_reference(axes):
    mesh = make_mesh((2,) * len(axes), axes, devices=["cpu"] * 2 ** len(axes))
    assert sharding.data_axis(mesh, "tile") \
        == ref_sharding.tile_specs(_duck(axes))[2]
    assert sharding.data_axis(mesh, "reduce") \
        == ref_sharding.reduce_specs(_duck(axes))[2]


@pytest.mark.parametrize("fn", ["tile", "reduce"])
def test_mesh_without_data_axis_raises_reference_message(fn):
    mesh = make_mesh((2,), ("model",), devices=["cpu"] * 2)
    with pytest.raises(ValueError) as want:
        getattr(ref_sharding, f"{fn}_specs")(_duck(("model",)))
    with pytest.raises(ValueError) as got:
        sharding.data_axis(mesh, fn)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("foreign", ["jax", "duck", "object", "int"])
def test_foreign_mesh_is_never_a_shard_count(foreign):
    """A jax mesh, a duck-typed one, or anything else: ``TypeError``."""
    if foreign == "jax":
        import jax
        obj = jax.make_mesh((1,), ("data",))
    else:
        obj = {"duck": _duck(("data",)), "object": object(), "int": 4}[foreign]
    for purpose in ("tile", "reduce"):
        with pytest.raises(TypeError, match="Mesh"):
            sharding.data_axis(obj, purpose)
    with pytest.raises(TypeError):
        compute_ph(points=np.zeros((6, 2)), maxdim=1, engine="packed",
                   mesh=obj, device="cpu")


# ---------------------------------------------------------------------------
# the exchange: payload stacking and the gather
# ---------------------------------------------------------------------------

def _payloads(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 3000, size=int(rng.integers(1, 6)))
    sizes[rng.integers(0, sizes.size)] = 0            # an empty payload
    return [rng.integers(0, 2**32, size=s, dtype=np.uint64).astype(np.uint32)
            for s in sizes]


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), min_words=st.sampled_from([1, 1024]))
def test_stack_wire_payloads_matches_reference(seed, min_words):
    payloads = _payloads(seed)
    buf, lens = gf2.stack_wire_payloads(payloads, min_words=min_words)
    rbuf, rlens = ref_gf2.stack_wire_payloads(payloads, min_words=min_words)
    assert buf.dtype == rbuf.dtype == np.uint32
    assert np.array_equal(buf, rbuf) and lens == rlens
    got = gf2.unstack_wire_payloads(buf, lens)
    want = ref_gf2.unstack_wire_payloads(rbuf, rlens)
    for a, b, p in zip(got, want, payloads):
        assert np.array_equal(a, b) and np.array_equal(a, p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mesh_exchange_delivers_every_payload(seed):
    payloads = _payloads(seed)
    p = len(payloads)
    out = _make_exchange(_mesh(p))(payloads)
    assert len(out) == p
    for a, b in zip(out, payloads):
        assert a.dtype == np.uint32 and np.array_equal(a, b)
    assert _make_exchange(None)(payloads) is payloads


# ---------------------------------------------------------------------------
# compute_ph over a mesh: the reference's split, counter for counter
# ---------------------------------------------------------------------------

SPLIT = ("n_supersteps", "n_tournament_reductions", "n_reductions",
         "n_exchange_rounds", "exchange_bytes")


def _case(which):
    """(reference kw, port kw): fractal_like(36, seed=7), the reference's
    own cloud for this bar; a prebuilt filtration of it carried across;
    tiled points on a Gaussian cloud."""
    if which == "dists":
        kw = dict(dists=fractal_like(36, seed=7), batch_size=48)
        return kw, kw
    if which == "filtration":
        rf = ref_build(dists=fractal_like(36, seed=7))
        tf = filtration_from_arrays(dataclasses.asdict(rf))
        return (dict(filtration=rf, batch_size=48),
                dict(filtration=tf, batch_size=48))
    pts = np.random.default_rng(7).normal(size=(40, 3))
    kw = dict(points=pts, tau_max=1.2, backend="tiled", tile_m=16,
              tile_n=16, batch_size=8, exchange_every=1)
    return kw, kw


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("which", ["dists", "filtration", "points"])
def test_mesh_reduction_matches_reference_split(which, p, mode):
    ref_kw, kw = _case(which)
    ref = ref_compute_ph(maxdim=2, engine="packed", mode=mode, n_shards=p,
                         **ref_kw)
    on_mesh = compute_ph(maxdim=2, engine="packed", mode=mode, mesh=_mesh(p),
                         **kw)
    loop = compute_ph(maxdim=2, engine="packed", mode=mode, n_shards=p,
                      device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(on_mesh.diagrams[d], ref.diagrams[d]), d
        assert np.array_equal(on_mesh.diagrams[d], loop.diagrams[d]), d
    for h in ("h1", "h2"):
        assert on_mesh.stats[f"{h}_n_shards"] == p
        for k in SPLIT:
            key = f"{h}_{k}"
            assert on_mesh.stats[key] == ref.stats[key] == loop.stats[key], \
                key
    assert on_mesh.stats["h1_n_exchange_rounds"] \
        + on_mesh.stats["h2_n_exchange_rounds"] > 0
    if which == "points":
        assert on_mesh.stats["n_shards"] == p
        assert on_mesh.stats["n_e"] == ref.stats["n_e"]


def test_mesh_memory_budget_is_read_per_device():
    """``memory_budget_bytes`` with a mesh: tau from the reference's
    per-device ``estimate_tau_max`` (the numpy transient, as the
    reference's ``compute_ph`` passes no backend), the sharded build and
    its per-device gauges, the diagrams of the reference at that tau."""
    from repro.scale import estimate_tau_max

    pts = np.random.default_rng(3).normal(size=(60, 3))
    kw = dict(points=pts, maxdim=1, backend="tiled", engine="packed",
              tile_m=16, tile_n=16, memory_budget_bytes=40_000)
    tau = estimate_tau_max(pts, 40_000, n_shards=2, tile_m=16, tile_n=16)
    mine = compute_ph(mesh=_mesh(2), **kw)
    serial = compute_ph(device="cpu", **kw)
    assert mine.stats["tau_max_estimated"] == tau
    assert tau != serial.stats["tau_max_estimated"]
    ref = ref_compute_ph(tau_max=tau, n_shards=2, **kw)
    assert mine.stats["n_e"] == ref.stats["n_e"]
    n_e = int(mine.stats["n_e"])
    assert mine.stats["per_device_base_bytes"] \
        == (3 * 60 + 12 * -(-n_e // 2)) * 4
    assert mine.stats["per_device_peak_bytes"] > 0
    assert mine.stats["n_shards"] == 2
    for d in (0, 1):
        assert np.array_equal(mine.diagrams[d], ref.diagrams[d]), d


_REFERENCE_MESH_RUN = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
from repro.core import compute_ph
from repro.launch.mesh import make_data_mesh
from repro.scale import build_filtration_sharded

pts = np.random.default_rng(7).normal(size=(60, 3))
kw = dict(tau_max=1.2, tile_m=16, tile_n=16)
mesh = make_data_mesh(4)
res = compute_ph(points=pts, maxdim=2, backend="tiled", engine="packed",
                 mesh=mesh, batch_size=8, exchange_every=1, **kw)
filt = build_filtration_sharded(points=pts, mesh=mesh, **kw)
out = {f"pd{d}": res.diagrams[d] for d in (0, 1, 2)}
out.update(edges=filt.edges, edge_len=filt.edge_len)
out.update({k: np.float64(v) for k, v in res.stats.items()
            if k.startswith(("h1_n_", "h2_n_", "h1_exchange", "h2_exchange"))
            or k in ("n_shards", "n_e")})
np.savez(sys.argv[1], **out)
"""


def test_mesh_matches_reference_on_a_real_jax_mesh(tmp_path):
    """The reference's ``compute_ph(points, backend="tiled",
    engine="packed", mesh=make_data_mesh(4))`` on 4 virtual jax devices
    (a subprocess, so that its ``XLA_FLAGS`` are set before jax starts):
    the port's cpu x 4 mesh gives the same diagrams, filtration and split
    counters."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", _REFERENCE_MESH_RUN,
                          str(out)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ref = np.load(out)
    assert ref["n_shards"] == 4

    from repro_torch.scale import build_filtration_sharded

    pts = np.random.default_rng(7).normal(size=(60, 3))
    kw = dict(tau_max=1.2, tile_m=16, tile_n=16)
    mesh = _mesh(4)
    res = compute_ph(points=pts, maxdim=2, backend="tiled", engine="packed",
                     mesh=mesh, batch_size=8, exchange_every=1, **kw)
    filt = build_filtration_sharded(points=pts, mesh=mesh, **kw)
    for d in (0, 1, 2):
        assert np.array_equal(res.diagrams[d], ref[f"pd{d}"]), d
    assert np.array_equal(filt.edges, ref["edges"])
    assert np.array_equal(filt.edge_len, ref["edge_len"])
    counters = [k for k in ref.files if k.startswith(("h1_", "h2_"))]
    assert {f"h1_{k}" for k in SPLIT} <= set(counters)
    for k in counters:
        if k.endswith(("_s", "_count", "_sum", "_min", "_max")) \
                or "resilience" in k:
            continue
        assert res.stats[k] == ref[k], k
    assert res.stats["h2_n_exchange_rounds"] > 0
