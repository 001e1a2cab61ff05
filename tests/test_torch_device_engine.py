"""The port's device engine (``repro_torch.core.device_engine``) on the CPU
against the JAX package's ``repro.core.jax_engine``: ``tests/
test_jax_engine.py``'s four tests with every result bit-exact against the
reference's, the column algebra and the tournament on seeded inputs, and
``make_distributed_round`` over a cpu x 4 mesh (``("data",)`` and
``("pod", "data")``) against the reference on a real 4-device jax mesh in
a subprocess (its ``XLA_FLAGS`` must be set before jax starts).
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.core import build_filtration as ref_build
from repro.core import jax_engine as ref
from repro.core.coboundary import edge_cobdy_ns, min_edge_cobdy_all
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import make_h1_adapter
from repro.core.pairing import EMPTY_KEY
from repro.core.reduction import merge_cancel, reduce_dimension
from repro_torch.core import device_engine as de
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.launch.mesh import make_data_mesh, make_mesh

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def pad_to(arr, width):
    out = np.full(width, EMPTY_KEY, dtype=np.int64)
    out[:len(arr)] = arr
    return out


def random_cols(rng, b, w, hi=300, fill=0.6):
    out = np.full((b, w), de.EMPTY, dtype=np.int64)
    for i in range(b):
        v = np.unique(rng.integers(0, hi, size=rng.integers(0, int(w * fill)
                                                             + 1)))
        out[i, :len(v)] = v
    return out


def pivot_table(rng, n_keys, w, hi=300):
    """Sorted pivot keys and a table whose row k has low ``keys[k]``."""
    keys = np.unique(rng.integers(0, hi, size=n_keys))
    table = random_cols(rng, len(keys), w, hi=hi)
    for k, low in enumerate(keys):
        row = table[k][table[k] > low]
        table[k] = pad_to(np.concatenate([[low], row[row != de.EMPTY]]), w)
    return keys, table


def test_signatures_extend_the_reference():
    for name in ("merge_cancel_padded", "truncate_width", "parallel_reduce",
                 "tournament_merge_local", "make_distributed_round",
                 "h0_msf_mask", "connected_labels"):
        want = list(inspect.signature(getattr(ref, name)).parameters)
        got = list(inspect.signature(getattr(de, name)).parameters)
        extra = [] if name == "make_distributed_round" else ["device"]
        assert got == want + extra, name
    assert de.EMPTY == ref.EMPTY == EMPTY_KEY


# ---------------------------------------------------------------------------
# tests/test_jax_engine.py, bit-exact against the reference
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(st.data())
def test_merge_cancel_padded_matches_numpy(data):
    a = np.unique(np.array(
        data.draw(st.lists(st.integers(0, 200), max_size=24)), dtype=np.int64))
    b = np.unique(np.array(
        data.draw(st.lists(st.integers(0, 200), max_size=24)), dtype=np.int64))
    W = 32
    out = de.merge_cancel_padded(pad_to(a, W)[None], pad_to(b, W)[None],
                                 device=CPU).numpy()
    want = np.asarray(ref.merge_cancel_jax(pad_to(a, W)[None],
                                           pad_to(b, W)[None]))
    np.testing.assert_array_equal(out, want)
    got = out[0][out[0] != EMPTY_KEY]
    assert np.array_equal(got, merge_cancel(a, b))


def test_truncate_width_flags_overflow():
    cols = pad_to(np.arange(10, dtype=np.int64), 16)[None]
    for width in (8, 12, 20):
        t, ov = de.truncate_width(cols, width, device=CPU)
        rt, rov = ref.truncate_width(jnp.asarray(cols), width)
        np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
        np.testing.assert_array_equal(ov.numpy(), np.asarray(rov))
    t, ov = de.truncate_width(cols, 8, device=CPU)
    assert t.shape == (1, 8) and bool(ov[0])
    t, ov = de.truncate_width(cols, 12, device=CPU)
    assert t.shape == (1, 12) and not bool(ov[0])


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_h0_boruvka_matches_union_find(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 80))
    pts = rng.normal(size=(n, 3))
    tau = float(rng.uniform(0.5, 2.5))
    filt = build_filtration(points=pts, tau_max=tau)
    if filt.n_e == 0:
        pytest.skip("empty filtration")
    uf = compute_h0(filt)
    mask = de.h0_msf_mask(filt.edges, n, device=CPU).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(ref.h0_msf_mask(jnp.asarray(filt.edges), n)))
    assert set(np.where(mask)[0].tolist()) == set(uf.death_edges.tolist())
    labels = de.connected_labels(filt.edges, n, device=CPU).numpy()
    np.testing.assert_array_equal(
        labels, np.asarray(ref.connected_labels(jnp.asarray(filt.edges), n)))
    assert len(np.unique(labels)) == uf.n_essential


def test_device_parallel_phase_reproduces_host_pivots():
    """The reference test's probe: each probe column, handed exactly the
    pivots committed before it, reduces to the host engine's pivot low (or
    to zero), and every output equals the reference's bit for bit."""
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(14, 3))
    filt = ref_build(points=pts)
    h0 = ref_h0(filt)
    cleared = set(int(e) for e in h0.death_edges)
    adapter = make_h1_adapter(filt, sparse=False)
    cols = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
    _, store = reduce_dimension(adapter, cols, mode="explicit",
                                cleared=cleared, return_store=True)
    min_cob = min_edge_cobdy_all(filt, sparse=False)

    committed_low_of = {store.col_ids[i]: low
                        for low, i in store.low_to_idx.items()}
    host_low = dict(committed_low_of)
    for e in range(filt.n_e):
        mc = int(min_cob[e])
        if e not in host_low and e not in cleared and \
                mc != EMPTY_KEY and (mc >> 32) == e:
            host_low[e] = mc

    W = 512
    probe_ids = [int(e) for e in cols if int(e) not in cleared][::3][:12]
    for e in probe_ids:
        entries = {}
        for low, idx in store.low_to_idx.items():
            if store.col_ids[idx] > e:
                entries[low] = store.columns[idx]
        for e2 in range(e + 1, filt.n_e):
            mc = int(min_cob[e2])
            if mc != EMPTY_KEY and (mc >> 32) == e2 and mc not in entries \
                    and e2 not in cleared:
                cob = edge_cobdy_ns(filt, np.array([e2]))[0]
                entries[mc] = cob[cob != EMPTY_KEY]
        keys = np.array(sorted(entries), dtype=np.int64) if entries else \
            np.array([EMPTY_KEY], dtype=np.int64)
        table = np.stack([pad_to(entries[k], W) for k in sorted(entries)]) \
            if entries else np.full((1, W), EMPTY_KEY, dtype=np.int64)
        raw = edge_cobdy_ns(filt, np.array([e]))[0]
        raw_p = pad_to(raw[raw != EMPTY_KEY], W)[None]
        out, hit = de.parallel_reduce(raw_p, keys, table, n_iters=256,
                                      device=CPU)
        want, want_hit = ref.parallel_reduce_jit(
            jnp.asarray(raw_p), jnp.asarray(keys), jnp.asarray(table),
            n_iters=256)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
        assert int(out[0, 0]) == host_low.get(e, int(EMPTY_KEY)), e


# ---------------------------------------------------------------------------
# the parallel phase and the tournament on seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_iters", [0, 1, 3, 8])
def test_parallel_reduce_matches_reference(n_iters):
    rng = np.random.default_rng(n_iters)
    keys, table = pivot_table(rng, 60, 32)
    cols = random_cols(rng, 64, 32)
    out, hit = de.parallel_reduce(cols, keys, table, n_iters=n_iters,
                                  device=CPU)
    want, want_hit = ref.parallel_reduce(jnp.asarray(cols),
                                         jnp.asarray(keys),
                                         jnp.asarray(table), n_iters=n_iters)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tournament_merge_local_matches_reference(seed):
    """Partner rows with equal lows included: the first in row order wins
    in both."""
    rng = np.random.default_rng(seed)
    cols = random_cols(rng, 48, 24, hi=80)
    other = random_cols(rng, 48, 24, hi=80)
    other[7, :3] = [5, 9, de.EMPTY]
    other[30, :3] = [5, 11, de.EMPTY]
    cols[2, :3] = [5, 6, de.EMPTY]
    got = de.tournament_merge_local(cols, other, device=CPU).numpy()
    want = np.asarray(ref.tournament_merge_local(jnp.asarray(cols),
                                                 jnp.asarray(other)))
    np.testing.assert_array_equal(got, want)
    first = int(np.flatnonzero(other[:, 0] == 5)[0])
    absorbed = merge_cancel(cols[2][cols[2] != de.EMPTY],
                            other[first][other[first] != de.EMPTY])
    np.testing.assert_array_equal(got[2], pad_to(absorbed, 48)[:24])


def test_tensor_inputs_stay_on_their_device():
    a = torch.tensor([[1, 4, int(de.EMPTY)]], dtype=torch.int64)
    out = de.merge_cancel_padded(a, a)
    assert out.device.type == "cpu"
    assert (out == int(de.EMPTY)).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            de.merge_cancel_padded(a.numpy(), a.numpy())


# ---------------------------------------------------------------------------
# make_distributed_round over the port's mesh
# ---------------------------------------------------------------------------

ROUND_SHAPES = {"data4": ((4,), ("data",)), "pod2x2": ((2, 2),
                                                        ("pod", "data"))}
# (mesh, n_parallel_iters, n_serial_rounds) of the subprocess comparison
ROUND_CASES = (("data4", 8, None), ("pod2x2", 2, 1))


def round_inputs(seed=0, rows=24, width=16):
    """Columns whose lows collide within and across entries, and a pivot
    table over part of the key range."""
    rng = np.random.default_rng(seed)
    cols = random_cols(rng, 4 * rows, width, hi=120, fill=0.5)
    keys, table = pivot_table(rng, 30, width, hi=120)
    return cols, keys, table


_REFERENCE_ROUND = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core.jax_engine import make_distributed_round
sys.path.insert(0, sys.argv[2])
from test_torch_device_engine import ROUND_CASES, ROUND_SHAPES, round_inputs
out = {}
devices = np.array(jax.devices()[:4])
for name, iters, rounds in ROUND_CASES:
    shape, axes = ROUND_SHAPES[name]
    # jitted as launch/dryrun.py lowers it (op by op it takes about 20 s
    # on a CPU)
    fn = jax.jit(make_distributed_round(Mesh(devices.reshape(shape), axes),
                                        n_parallel_iters=iters,
                                        n_serial_rounds=rounds))
    cols, lows = fn(*round_inputs())
    out[f"{name}_cols"] = np.asarray(cols)
    out[f"{name}_lows"] = np.asarray(lows)
np.savez(sys.argv[1], **out)
"""


def _port_mesh(name):
    shape, axes = ROUND_SHAPES[name]
    if len(shape) == 1:
        return make_data_mesh(4, devices=[CPU] * 4)
    return make_mesh(shape, axes, devices=[CPU] * 4)


def test_distributed_round_matches_reference_on_a_real_jax_mesh(tmp_path):
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", _REFERENCE_ROUND, str(out),
                          os.path.dirname(os.path.abspath(__file__))],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = np.load(out)
    for name, iters, rounds in ROUND_CASES:
        fn = de.make_distributed_round(_port_mesh(name),
                                       n_parallel_iters=iters,
                                       n_serial_rounds=rounds)
        cols, lows = fn(*round_inputs())
        np.testing.assert_array_equal(cols.numpy(), want[f"{name}_cols"])
        np.testing.assert_array_equal(lows.numpy(), want[f"{name}_lows"])


def test_distributed_round_reduces_like_the_local_program():
    """One entry's result is the local program: the parallel phase, then
    per serial round the absorb (later-ranked entry only) and two more
    parallel iterations."""
    cols, keys, table = round_inputs(seed=3)
    got, lows = de.make_distributed_round(_port_mesh("data4"))(
        cols, keys, table)
    rows = cols.shape[0] // 4
    local = [de.parallel_reduce(cols[k * rows:(k + 1) * rows], keys, table,
                                device=CPU)[0] for k in range(4)]
    for step in (1, 2):
        other = [local[k ^ step] for k in range(4)]
        local = [de.parallel_reduce(
            de.tournament_merge_local(c, other[k]) if k & step else c,
            keys, table, n_iters=2)[0] for k, c in enumerate(local)]
    np.testing.assert_array_equal(got.numpy(), torch.cat(local).numpy())
    np.testing.assert_array_equal(lows.numpy(), got[:, 0].numpy())


@pytest.mark.parametrize("size,rounds", [(3, None), (1, None), (4, 3)])
def test_distributed_round_rejects_a_malformed_partner_map(size, rounds):
    """Partners ``i ^ step`` outside the data axis: the reference's
    ``ppermute`` refuses them when called; the port when building."""
    mesh = make_data_mesh(size, devices=[CPU] * size)
    with pytest.raises(ValueError, match="power of two"):
        de.make_distributed_round(mesh, n_serial_rounds=rounds)
    de.make_distributed_round(mesh, n_serial_rounds=0)


def test_distributed_round_needs_a_data_axis_and_even_split():
    with pytest.raises(ValueError, match="'data'"):
        de.make_distributed_round(make_mesh((2,), ("pod",),
                                            devices=[CPU] * 2))
    fn = de.make_distributed_round(_port_mesh("data4"))
    cols, keys, table = round_inputs()
    with pytest.raises(ValueError, match="split evenly"):
        fn(cols[:-1], keys, table)
