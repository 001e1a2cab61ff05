"""The port's pivot-exchange wire against the reference's: the Elias–Fano
codec (``repro_torch.dist.compression``), the commit-delta codec
(``repro_torch.core.pivot_cache``) and the replica path
(``PivotStore.commit_log`` / ``install``).

Payloads must be word for word the reference's for the same records, so
either package decodes the other's wire; a flipped bit raises
``WireCorruption`` (a ``ValueError``) in both.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import build_filtration as ref_build
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.core.pivot_cache import decode_commit_delta as ref_decode
from repro.core.pivot_cache import encode_commit_delta as ref_encode
from repro.core.pivot_cache import verify_commit_delta as ref_verify
from repro.core.reduction import PivotStore as RefPivotStore
from repro.core.reduction import reduce_dimension as ref_reduce
from repro.dist import compression as ref_comp
from repro.resilience.faults import WireCorruption as RefWireCorruption
from repro_torch.core.filtration import build_filtration
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core.pivot_cache import (decode_commit_delta,
                                          encode_commit_delta,
                                          verify_commit_delta)
from repro_torch.core.reduction import PivotStore
from repro_torch.dist import compression
from repro_torch.resilience.faults import WireCorruption

KEY = st.integers(0, 2**40)


def sorted_keys(max_key=2**40, max_size=40):
    return st.sets(st.integers(0, max_key), max_size=max_size).map(
        lambda s: np.array(sorted(s), dtype=np.int64))


@st.composite
def records(draw):
    out = []
    lows = draw(st.lists(KEY, unique=True, max_size=8))
    for low in lows:
        mode = draw(st.sampled_from(["explicit", "implicit"]))
        gens = draw(st.one_of(
            st.none(), st.lists(KEY, unique=True, max_size=12).map(
                lambda g: np.array(g, dtype=np.int64))))
        if mode == "implicit" and gens is None:
            gens = np.zeros(0, dtype=np.int64)
        out.append({"low": low, "col_id": draw(KEY), "mode": mode,
                    "column": (draw(sorted_keys()) if mode == "explicit"
                               else None),
                    "gens": gens})
    return out


def assert_same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x["low"], x["col_id"], x["mode"]) == \
            (y["low"], y["col_id"], y["mode"])
        if x["mode"] == "explicit":
            np.testing.assert_array_equal(x["column"], y["column"])
        else:
            assert x["column"] is None and y["column"] is None
        np.testing.assert_array_equal(x["gens"], y["gens"])


@settings(max_examples=60, deadline=None)
@given(values=sorted_keys(max_key=2**62, max_size=200),
       pad=st.integers(0, 2**20))
def test_ef_encode_sorted_is_the_reference_wire(values, pad):
    for universe in (None, int(values[-1]) + 1 + pad if values.size else None):
        mine = compression.ef_encode_sorted(values, universe=universe)
        ref = ref_comp.ef_encode_sorted(values, universe=universe)
        assert mine.dtype == np.uint32
        np.testing.assert_array_equal(mine, ref)
        np.testing.assert_array_equal(compression.ef_decode_sorted(ref),
                                      values)


def test_ef_encode_sorted_refuses_what_the_reference_refuses():
    for bad in (np.array([-1, 2]), np.array([3, 2])):
        with pytest.raises(ValueError):
            compression.ef_encode_sorted(bad)
    with pytest.raises(ValueError, match="universe"):
        compression.ef_encode_sorted(np.array([1, 9]), universe=5)
    with pytest.raises(ValueError, match="Elias"):
        compression.ef_decode_sorted(np.zeros(6, dtype=np.uint32))


@settings(max_examples=60, deadline=None)
@given(cols=st.lists(st.one_of(sorted_keys(), sorted_keys(max_key=2**62),
                               st.just(np.zeros(0, dtype=np.int64))),
                     max_size=10))
def test_pack_column_payload_is_the_reference_wire(cols):
    """EF batches, the raw fallback (keys near 2**62), all-empty and empty
    batches alike."""
    mine = compression.pack_column_payload(cols)
    np.testing.assert_array_equal(mine, ref_comp.pack_column_payload(cols))
    back = compression.unpack_column_payload(mine)
    assert len(back) == len(cols)
    for a, b in zip(back, cols):
        np.testing.assert_array_equal(a, b)


@settings(max_examples=80, deadline=None)
@given(recs=records())
def test_commit_delta_is_the_reference_wire(recs):
    mine = encode_commit_delta(recs)
    ref = ref_encode(recs)
    assert mine.dtype == np.uint32
    np.testing.assert_array_equal(mine, ref)
    assert verify_commit_delta(mine) and ref_verify(mine)
    # each package decodes the other's payload to the same records
    assert_same_records(decode_commit_delta(ref), ref_decode(mine))
    back = decode_commit_delta(mine)
    assert len(back) == len(recs)
    for r, b in zip(recs, back):
        assert b["low"] == r["low"] and b["col_id"] == r["col_id"]
        want = np.zeros(0, np.int64) if r["gens"] is None \
            else np.sort(r["gens"])
        np.testing.assert_array_equal(b["gens"], want)


def test_unsorted_column_ships_sorted():
    """The packed host engine commits R columns segment-major when a batch
    holds more than one segment.  The reference's encoder refuses such a
    column; the port's ships it sorted, as the reference ships gens, and
    its payload is the reference's for the sorted record."""
    rec = {"low": 4, "col_id": 90, "mode": "explicit",
           "column": np.array([4, 17, 30, 9, 12], dtype=np.int64),
           "gens": np.array([7, 3], dtype=np.int64)}
    with pytest.raises(ValueError, match="sorted"):
        ref_encode([rec])
    mine = encode_commit_delta([rec])
    srt = dict(rec, column=np.sort(rec["column"]))
    np.testing.assert_array_equal(mine, ref_encode([srt]))
    back = decode_commit_delta(mine)[0]
    np.testing.assert_array_equal(back["column"], [4, 9, 12, 17, 30])
    np.testing.assert_array_equal(back["gens"], [3, 7])


def test_empty_delta_is_the_reference_wire():
    mine = encode_commit_delta([])
    np.testing.assert_array_equal(mine, ref_encode([]))
    assert decode_commit_delta(mine) == [] and ref_decode(mine) == []


@settings(max_examples=30, deadline=None)
@given(recs=records(), where=st.integers(0, 10**6), bit=st.integers(0, 31))
def test_flipped_bit_is_rejected(recs, where, bit):
    payload = encode_commit_delta(recs).copy()
    i = where % payload.size
    payload[i] ^= np.uint32(1 << bit)
    assert not verify_commit_delta(payload)
    assert not ref_verify(payload)
    with pytest.raises(WireCorruption):
        decode_commit_delta(payload)
    with pytest.raises(ValueError):
        decode_commit_delta(payload)
    with pytest.raises(RefWireCorruption):
        ref_decode(payload)


def _logged_records(mode, budget):
    """Commit records of a real H1* reduction, logged by the reference."""
    pts = np.random.default_rng(8).normal(size=(22, 3))
    f = ref_build(points=pts)
    log = []
    cols = np.arange(f.n_e - 1, -1, -1, dtype=np.int64)
    ref_reduce(ref_h1_adapter(f), cols, mode=mode,
               cleared=ref_h0(f).death_edges, store_budget_bytes=budget,
               commit_log=log)
    return pts, log


@pytest.mark.parametrize("mode,budget", [("explicit", None),
                                         ("implicit", None),
                                         ("explicit", 1500)])
def test_commit_log_matches_the_reference(mode, budget):
    """``PivotStore(commit_log=...)`` appends the reference's record for
    each non-trivial commit, spills to implicit included."""
    pts, log = _logged_records(mode, budget)
    assert log
    if budget is not None:     # the budget spills some commits to implicit
        assert any(r["mode"] == "implicit" for r in log)
    ref_store = RefPivotStore(ref_h1_adapter(ref_build(points=pts)), mode,
                              store_budget_bytes=budget, commit_log=[])
    store = PivotStore(make_h1_adapter(build_filtration(points=pts)), mode,
                       store_budget_bytes=budget, commit_log=[])
    for r in log:
        col = r["column"] if r["column"] is not None \
            else np.zeros(0, np.int64)
        for s in (ref_store, store):
            s.commit(r["low"], r["col_id"], col, r["gens"], False)
            s.commit(-2, r["col_id"], col, r["gens"], True)   # trivial
    assert_same_records(ref_store.commit_log, store.commit_log)
    assert store.bytes_stored == ref_store.bytes_stored
    assert store.n_spilled == ref_store.n_spilled


@pytest.mark.parametrize("mode,budget", [("explicit", None),
                                         ("implicit", None),
                                         ("explicit", 1500)])
def test_install_then_lookup_matches_the_reference_replica(mode, budget):
    """Records that crossed the wire, installed into a replica of each
    package: every probe answers alike (addend keys, owner, owner gens)."""
    pts, log = _logged_records(mode, budget)
    wire = ref_encode(log)
    ref_rep = RefPivotStore(ref_h1_adapter(ref_build(points=pts)), mode,
                            store_budget_bytes=budget)
    rep = PivotStore(make_h1_adapter(build_filtration(points=pts)), mode,
                     store_budget_bytes=budget)
    for rec in ref_decode(wire):
        ref_rep.install(rec["low"], rec["col_id"], rec["mode"],
                        rec["column"], rec["gens"])
    for rec in decode_commit_delta(wire):
        rep.install(rec["low"], rec["col_id"], rec["mode"], rec["column"],
                    rec["gens"])
    assert rep.low_to_idx == ref_rep.low_to_idx
    assert rep.col_modes == ref_rep.col_modes
    assert rep.bytes_stored == ref_rep.bytes_stored
    lows = np.array([r["low"] for r in log] + [-1, 0, 5], dtype=np.int64)
    ids = np.full(lows.size, 10**6, dtype=np.int64)
    got = rep.lookup_addends_batched(lows, ids)
    want = ref_rep.lookup_addends_batched(lows, ids)
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[0], want[0]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
