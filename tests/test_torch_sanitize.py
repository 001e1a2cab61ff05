"""The port's GF(2) sanitizer (``repro_torch.analyze.invariants``) on the
CPU against the JAX package's ``repro.analyze.invariants``: the sanitizer
tests of ``tests/test_analyze.py`` in both packages, each planted fault
raising the reference's ``check``; the hooks at the reference's sites
(store, pivot cache, wire, packed consolidation, clearance) ticking the
reference's checks; and ``compute_ph(sanitize=True)`` on every engine
with the reference's diagrams and check counts.
"""
import os

import numpy as np
import pytest
import torch

import repro.analyze as ref_analyze
import repro.core.packed_reduce as ref_packed
from repro.core import build_filtration as ref_build
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import compute_ph as ref_compute_ph
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.core.pivot_cache import PackedPivotCache as RefCache
from repro.core.pivot_cache import decode_commit_delta as ref_decode
from repro.core.pivot_cache import encode_commit_delta as ref_encode
from repro.core.reduction import PivotStore as RefStore
from repro.core.reduction import reduce_dimension as ref_reduce
from repro.data.pointclouds import clifford_torus
from repro.analyze import invariants as ref_inv
import repro_torch.analyze as analyze
import repro_torch.core.packed_reduce as packed
from repro_torch import compute_ph
from repro_torch.analyze import invariants as inv
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core.pivot_cache import (PackedPivotCache,
                                          decode_commit_delta,
                                          encode_commit_delta)
from repro_torch.core.reduction import PivotStore, reduce_dimension
from repro_torch.launch.mesh import make_data_mesh

PKGS = {"reference": ref_inv, "port": inv}


def test_exports_match_reference():
    assert analyze.__all__ == ref_analyze.__all__
    for name in analyze.__all__:
        if name == "lint":
            assert analyze.lint.__name__ == "repro_torch.analyze.lint"
        else:
            assert getattr(analyze, name).__module__ == inv.__name__, name


# ---------------------------------------------------------------------------
# tests/test_analyze.py's sanitizer tests, in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_duplicate_pivot_low_caught(pkg):
    san = PKGS[pkg].Sanitizer()
    san.check_fresh_pivot({}, 5)
    with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
        san.check_fresh_pivot({5: 0}, 5)
    assert exc.value.check == "pivot-low-unique"
    assert "REPRO_SANITIZE[pivot-low-unique]" in str(exc.value)


@pytest.mark.parametrize("pkg", PKGS)
def test_noncanonical_column_caught(pkg):
    san = PKGS[pkg].Sanitizer()
    san.check_canonical_column(np.array([1, 4, 9], dtype=np.int64))
    for bad in ([1, 9, 4], [1, 4, 4]):
        with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
            san.check_canonical_column(np.array(bad, dtype=np.int64))
        assert exc.value.check == "canonical-column"


@pytest.mark.parametrize("pkg", PKGS)
def test_pair_order_and_rematerialization_caught(pkg):
    san = PKGS[pkg].Sanitizer()
    san.check_pair_orders(np.array([0.0, 1.0]), np.array([0.5, 2.0]))
    with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
        san.check_pair_orders(np.array([1.0]), np.array([0.5]))
    assert exc.value.check == "pair-order"
    a = np.array([2, 5], dtype=np.int64)
    san.check_rematerialization(a, a.copy(), col_id=3)
    with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
        san.check_rematerialization(a, np.array([2, 7], dtype=np.int64), 3)
    assert exc.value.check == "spill-rematerialization"
    assert san.counts == {"pair-order": 2, "spill-rematerialization": 2}


def _two_segment_batch(which):
    cob = np.full((2, 3), np.iinfo(np.int64).max, dtype=np.int64)
    cob[0] = [2, 5, 9]
    cob[1, :2] = [5, 11]
    if which == "reference":
        batch = ref_packed._PackedBatch(cob, [], use_kernels=False)
    else:
        batch = packed._PackedBatch(cob, [], use_kernels=False,
                                    device=torch.device("cpu"))
    batch.add_segment(np.array([20, 30], dtype=np.int64))
    return batch


@pytest.mark.parametrize("pkg", PKGS)
def test_corrupted_packed_segment_caught(pkg):
    """A stray bit planted past a segment's key universe is caught by
    consolidation instead of silently dropped by its keep filter."""
    with PKGS[pkg].sanitizing(True):
        _two_segment_batch(pkg).consolidate()
        batch = _two_segment_batch(pkg)
        batch.block[0, batch.seg_off[1]] |= np.uint32(1 << 5)
        with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
            batch.consolidate()
    assert exc.value.check == "packed-segment"


@pytest.mark.parametrize("pkg", PKGS)
def test_lossy_consolidation_caught(pkg, monkeypatch):
    """A consolidation that loses a coordinate (its scatter drops the last
    bit) raises ``packed-consolidation``."""
    mod = ref_packed if pkg == "reference" else packed
    real = mod.scatter_bits

    def lossy(block, ridx, pos):
        real(block, ridx[:-1], pos[:-1])

    with PKGS[pkg].sanitizing(True) as san:
        batch = _two_segment_batch(pkg)
        monkeypatch.setattr(mod, "scatter_bits", lossy)
        with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
            batch.consolidate()
    assert exc.value.check == "packed-consolidation"
    assert san.counts["packed-segment"] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_broken_wire_roundtrip_caught(pkg):
    encode = ref_encode if pkg == "reference" else encode_commit_delta
    decode = ref_decode if pkg == "reference" else decode_commit_delta
    records = [{"low": 3, "col_id": 7, "mode": "explicit",
                "column": np.array([3, 5, 9], dtype=np.int64),
                "gens": np.array([1], dtype=np.int64)}]
    with PKGS[pkg].sanitizing(True) as live:
        payload = encode(records)
    assert live.counts == {"wire-roundtrip": 1}
    san = PKGS[pkg].Sanitizer()

    def lossy_decode(p):
        out = decode(p)
        out[0]["low"] += 1
        return out

    with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
        san.check_wire_roundtrip(records, payload, lossy_decode)
    assert exc.value.check == "wire-roundtrip"
    corrupt = payload.copy()
    corrupt[0] = 0                              # smash the magic word
    with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
        san.check_wire_roundtrip(records, corrupt, decode)
    assert exc.value.check == "wire-roundtrip"


@pytest.mark.parametrize("pkg", PKGS)
def test_violation_carries_context_and_location(pkg):
    san = PKGS[pkg].Sanitizer()
    san.set_context(dim=2, superstep=7)
    with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
        san.check_fresh_pivot({1: 0}, 1)
    v = exc.value
    assert v.context == {"dim": 2, "superstep": 7}
    assert __file__.split(os.sep)[-1] in v.location
    san.set_context(dim=None, superstep=None)
    assert san.context == {}


def test_sanitizing_scopes_nest_and_restore():
    with analyze.sanitizing(False):
        assert analyze.active_sanitizer() is None
        with analyze.sanitizing(True) as inner:
            assert analyze.active_sanitizer() is inner and inner is not None
            with analyze.sanitizing(None) as ambient:
                assert ambient is inner
        assert analyze.active_sanitizer() is None


# ---------------------------------------------------------------------------
# planted faults at the hook sites
# ---------------------------------------------------------------------------

def _store(pkg):
    pts = np.random.default_rng(3).normal(size=(12, 3))
    if pkg == "reference":
        filt = ref_build(points=pts)
        return RefStore(ref_h1_adapter(filt, sparse=True), "explicit",
                        cache=RefCache())
    filt = build_filtration(points=pts)
    return PivotStore(make_h1_adapter(filt, sparse=True), "explicit",
                      cache=PackedPivotCache())


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("site", ["commit-twice", "commit-unsorted",
                                  "install-twice", "cache-unsorted"])
def test_planted_fault_at_hook_raises_reference_check(pkg, site):
    store = _store(pkg)
    col = np.array([4, 9, 17], dtype=np.int64)
    gens = np.zeros(0, dtype=np.int64)
    want = {"commit-twice": "pivot-low-unique",
            "commit-unsorted": "canonical-column",
            "install-twice": "pivot-low-unique",
            "cache-unsorted": "canonical-column"}[site]
    with PKGS[pkg].sanitizing(True) as san:
        with pytest.raises(PKGS[pkg].SanitizeViolation) as exc:
            if site == "commit-twice":
                store.commit(4, 1, col, gens, trivial=False)
                store.commit(4, 2, col, gens, trivial=False)
            elif site == "commit-unsorted":
                store.commit(4, 1, col[::-1].copy(), gens, trivial=False)
            elif site == "install-twice":
                store.install(4, 1, "explicit", col, gens)
                store.install(4, 2, "explicit", col, gens)
            else:
                store.cache.put_column(4, col[::-1].copy())
    assert exc.value.check == want
    assert sum(san.counts.values()) >= 1


def _h1_inputs(pkg, n=40, seed=5):
    pts = np.random.default_rng(seed).normal(size=(n, 3))
    build, h0, adapter = ((ref_build, ref_h0, ref_h1_adapter)
                          if pkg == "reference"
                          else (build_filtration, compute_h0,
                                make_h1_adapter))
    filt = build(points=pts)
    cols = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
    return adapter(filt, sparse=True), cols, h0(filt).death_edges


def test_budget_spills_tick_the_reference_checks():
    """A budgeted explicit reduction spills: every demotion is checked
    (``spill-rematerialization``) and the per-check counts equal the
    reference's."""
    counts = {}
    for pkg, reduce in (("reference", ref_reduce), ("port", reduce_dimension)):
        adapter, cols, cleared = _h1_inputs(pkg)
        with PKGS[pkg].sanitizing(True) as san:
            res = reduce(adapter, cols, mode="explicit", cleared=cleared,
                         store_budget_bytes=2048)
        counts[pkg] = dict(san.counts)
        assert res.stats["n_spilled"] > 0
    assert counts["port"] == counts["reference"]
    assert counts["port"]["spill-rematerialization"] > 0


# ---------------------------------------------------------------------------
# compute_ph(sanitize=True) on every engine
# ---------------------------------------------------------------------------

ENGINES = [("single", {}), ("batch", dict(batch_size=8)),
           ("packed", dict(batch_size=8)),
           ("packed", dict(batch_size=8, n_shards=3, exchange_every=1))]


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("engine,kw", ENGINES,
                         ids=["single", "batch", "packed", "packed-p3"])
def test_compute_ph_sanitize_matches_reference(engine, kw, mode):
    pts = np.random.default_rng(1).normal(size=(16, 3))
    args = dict(points=pts, maxdim=2, engine=engine, mode=mode, **kw)
    ref = ref_compute_ph(sanitize=True, **args)
    got = compute_ph(sanitize=True, device="cpu", **args)
    plain = compute_ph(device="cpu", **args)
    for d in (0, 1, 2):
        assert np.array_equal(got.diagrams[d], ref.diagrams[d]), d
        assert np.array_equal(got.diagrams[d], plain.diagrams[d]), d
    assert got.stats["sanitize_checks"] == ref.stats["sanitize_checks"] > 0
    assert "sanitize_checks" not in plain.stats


@pytest.mark.parametrize("use_kernels", [False, True])
def test_sanitize_over_a_mesh_and_the_kernel_path(use_kernels):
    """Over a cpu x 3 mesh (the numpy path) and on the kernel path (the
    kernels' plain versions, eager consolidation): the checks run and the
    diagrams are the reference's."""
    if use_kernels:
        pts = np.random.default_rng(5).normal(size=(40, 3))
        ref = ref_compute_ph(points=pts, maxdim=1, engine="packed",
                             batch_size=16, n_shards=3, sanitize=True)
        adapter, cols, cleared = _h1_inputs("port", n=40, seed=5)
        with analyze.sanitizing(True) as san:
            res = packed.reduce_dimension_packed(
                adapter, cols, cleared=cleared, batch_size=16, n_shards=3,
                exchange_every=1, use_kernels=True, device="cpu")
        assert np.array_equal(res.diagram(), ref.diagrams[1])
        assert san.counts["pivot-low-unique"] > 0
        assert san.counts["wire-roundtrip"] > 0
        return
    pts = np.random.default_rng(2).normal(size=(16, 3))
    ref = ref_compute_ph(points=pts, maxdim=2, engine="packed",
                         batch_size=8, n_shards=3, sanitize=True)
    got = compute_ph(points=pts, maxdim=2, engine="packed", batch_size=8,
                     mesh=make_data_mesh(3, devices=["cpu"] * 3),
                     sanitize=True)
    for d in (0, 1, 2):
        assert np.array_equal(got.diagrams[d], ref.diagrams[d]), d
    assert got.stats["sanitize_checks"] == ref.stats["sanitize_checks"]


@pytest.mark.parametrize("n_shards", [None, 2])
def test_segment_major_columns_raise_the_same_check(n_shards):
    """The packed host engine commits segment-major R columns once a batch
    holds more than one segment (explicit mode): both packages' commit
    check flags the first such column as ``canonical-column``.  At P = 2
    the first one falls in another superstep in each package (the port
    evicts at ``_EVICT_MAX`` rows per slice), the check is the same."""
    pts = clifford_torus(1500, seed=0)
    kw = dict(points=pts, tau_max=0.3, maxdim=1, engine="packed",
              mode="explicit", n_shards=n_shards, sanitize=True)
    with pytest.raises(ref_inv.SanitizeViolation) as ref_exc:
        ref_compute_ph(**kw)
    with pytest.raises(inv.SanitizeViolation) as exc:
        compute_ph(device="cpu", **kw)
    assert exc.value.check == ref_exc.value.check == "canonical-column"
    assert exc.value.context["dim"] == ref_exc.value.context["dim"] == 1
    if n_shards is None:
        assert exc.value.context == ref_exc.value.context


def test_sanitize_none_defers_to_an_enclosing_scope():
    """``compute_ph(sanitize=None)`` inside a ``sanitizing(True)`` scope
    runs the checks on the scope's sanitizer, and outside any scope (with
    ``REPRO_SANITIZE`` unset at import) none, in both packages.  The
    variable itself is held in a fresh process by
    ``tests/test_torch_signatures.py::test_repro_sanitize_env_is_refused``."""
    pts = np.random.default_rng(5).normal(size=(14, 3))
    kw = dict(points=pts, maxdim=1, engine="packed")
    counts = {}
    for pkg, run in (("reference", lambda: ref_compute_ph(**kw)),
                     ("port", lambda: compute_ph(device="cpu", **kw))):
        assert PKGS[pkg].active_sanitizer() is None
        assert "sanitize_checks" not in run().stats
        with PKGS[pkg].sanitizing(True) as san:
            res = run()
        assert res.stats["sanitize_checks"] == sum(san.counts.values()) > 0
        counts[pkg] = dict(san.counts)
    assert counts["port"] == counts["reference"]
