"""The batch engine (``repro_torch.core.serial_parallel``) and the
repaired single engine against the JAX package, on the CPU.

Every comparison is exact: diagrams, pivot lows and column ids
``np.array_equal``, stats equal key for key and value for value.
``reduce_dimension_batched`` runs on H1 and H2 adapters, explicit and
implicit, at batch sizes 1, 7 and 128, with and without a store budget;
``compute_ph(engine="batch")`` against the reference's batch engine and
the port's single and packed engines on the dense and tiled backends;
``reduce_dimension`` called with the reference's positional order
(``return_store`` right after ``cleared``).
"""
import numpy as np
import pytest

from repro.core import build_filtration as ref_build
from repro.core import compute_ph as ref_compute_ph
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import h2_columns as ref_h2_columns
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.core.homology import make_h2_adapter as ref_h2_adapter
from repro.core.reduction import reduce_dimension as ref_reduce
from repro.core.serial_parallel import reduce_dimension_batched as ref_batched
from repro_torch import compute_ph
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import h2_columns, make_h1_adapter, \
    make_h2_adapter
from repro_torch.core.reduction import reduce_dimension
from repro_torch.core.serial_parallel import reduce_dimension_batched


def cloud(seed, n=16, d=3):
    return np.random.default_rng(seed).normal(size=(n, d))


def adapter_and_columns(pkg, dim, pts, tau=1.9):
    """(adapter, columns, cleared) of dimension ``dim`` through one
    package's own filtration, H0 and (for H2) H1 reduction."""
    if pkg == "ref":
        build, h0, h1a, h2a, h2c, red = (ref_build, ref_h0, ref_h1_adapter,
                                         ref_h2_adapter, ref_h2_columns,
                                         ref_reduce)
    else:
        build, h0, h1a, h2a, h2c, red = (build_filtration, compute_h0,
                                         make_h1_adapter, make_h2_adapter,
                                         h2_columns, reduce_dimension)
    f = build(points=pts, tau_max=tau)
    cleared = h0(f).death_edges
    a1 = h1a(f, sparse=True)
    cols1 = np.arange(f.n_e - 1, -1, -1, dtype=np.int64)
    if dim == 1:
        return a1, cols1, cleared
    res1 = red(a1, cols1, cleared=cleared)
    return h2a(f, sparse=True), h2c(f, res1.pivot_lows, sparse=True), None


def assert_same_result(ref, mine):
    for k in ("pairs", "essentials", "pivot_lows", "pair_cols",
              "pivot_cols", "essential_ids"):
        a, b = getattr(ref, k), getattr(mine, k)
        assert a.dtype == b.dtype, k
        assert np.array_equal(a, b), k
    assert np.array_equal(ref.diagram(), mine.diagram())
    assert ref.stats == mine.stats


@pytest.mark.parametrize("budget", [None, 100])
@pytest.mark.parametrize("batch_size", [1, 7, 128])
@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("dim", [1, 2])
def test_batched_matches_reference(dim, mode, batch_size, budget):
    pts = cloud(1)
    ra, rcols, rclr = adapter_and_columns("ref", dim, pts)
    ta, tcols, tclr = adapter_and_columns("port", dim, pts)
    np.testing.assert_array_equal(rcols, tcols)
    ref = ref_batched(ra, rcols, mode, rclr, batch_size, budget)
    mine = reduce_dimension_batched(ta, tcols, mode, tclr, batch_size,
                                    budget)
    assert_same_result(ref, mine)
    assert mine.pivot_lows.size > 0
    assert set(mine.stats) == {
        "n_columns", "n_reductions", "n_pairs", "n_essential",
        "stored_bytes", "n_stored_columns", "n_spilled", "batch_size"}
    if budget is not None and mode == "explicit":
        assert mine.stats["n_spilled"] > 0


def test_batched_emits_the_reference_spans():
    from repro.obs.trace import Tracer as RefTracer
    from repro.obs.trace import tracing as ref_tracing
    from repro_torch.obs.trace import Tracer, tracing

    pts = cloud(4)
    ra, rcols, rclr = adapter_and_columns("ref", 1, pts)
    ta, tcols, tclr = adapter_and_columns("port", 1, pts)
    rt, tt = RefTracer(), Tracer()
    with ref_tracing(rt):
        ref_batched(ra, rcols, cleared=rclr, batch_size=8)
    with tracing(tt):
        reduce_dimension_batched(ta, tcols, cleared=tclr, batch_size=8)
    want = [(s.name, s.attrs) for s in rt.spans]
    got = [(s.name, s.attrs) for s in tt.spans]
    assert got == want
    assert {n for n, _ in got} == {"reduce/parallel", "reduce/serial",
                                   "reduce/commit"}
    tt.assert_balanced()


@pytest.mark.parametrize("budget", [None, 2000])
@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("backend", ["dense", "tiled"])
def test_compute_ph_batch_matches_reference_and_single(backend, mode,
                                                       budget):
    kw = dict(points=cloud(7, n=18), tau_max=1.8, maxdim=2, mode=mode,
              backend=backend, memory_budget_bytes=budget, batch_size=16,
              tile_m=7, tile_n=11)
    ref = ref_compute_ph(engine="batch", **kw)
    mine = compute_ph(engine="batch", device="cpu", **kw)
    single = compute_ph(engine="single", device="cpu", **kw)
    packed = compute_ph(engine="packed", device="cpu", **kw)
    assert set(ref.stats) == set(mine.stats)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
        assert np.array_equal(single.diagrams[d], mine.diagrams[d]), d
        assert np.array_equal(packed.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["h1_batch_size"] == 16
    assert mine.diagrams[1].shape[0] > 0


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_reduce_dimension_positional_reference_call(mode):
    """The reference's positional order, every parameter given: adapter,
    column_ids, mode, cleared, return_store, store_budget_bytes, seed_gens,
    commit_log, essential_log."""
    pts = cloud(5)
    ra, rcols, rclr = adapter_and_columns("ref", 1, pts)
    ta, tcols, tclr = adapter_and_columns("port", 1, pts)
    ref, ref_store = ref_reduce(ra, rcols, mode, rclr, True, 500, None,
                                None, None)
    mine, store = reduce_dimension(ta, tcols, mode, tclr, True, 500, None,
                                   None, None)
    assert_same_result(ref, mine)
    assert store.store_budget_bytes == 500
    assert store.bytes_stored == ref_store.bytes_stored
    assert store.n_spilled == ref_store.n_spilled
    assert store.col_ids == ref_store.col_ids
    assert store.col_modes == ref_store.col_modes
    assert store.low_to_idx == ref_store.low_to_idx
    plain = reduce_dimension(ta, tcols, mode, tclr, False, 500)
    assert_same_result(ref, plain)
