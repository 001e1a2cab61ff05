"""The port's seeded fault injector (``repro_torch.resilience.faults``) on
the CPU against the JAX package's ``repro.resilience.faults``.

Exact throughout: plans from a seed, injector histories, backoff
schedules and corrupted bytes equal the reference's.  ``inject`` arms a
plan at every one of the reference's five sites; the recovery each site
drives is held to the reference's in ``tests/test_torch_resilience.py``.
"""
import inspect

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.resilience as ref_pkg
from repro.resilience import faults as ref
import repro_torch.resilience as pkg
from repro_torch.resilience import faults


def test_exports_match_reference():
    assert pkg.__all__ == ref_pkg.__all__
    for name in ref_pkg.__all__:
        if name != "SITES":
            assert getattr(pkg, name).__module__ == faults.__name__, name
    assert faults.SITES == ref.SITES
    assert faults._KINDS == ref._KINDS


@pytest.mark.parametrize("name", ["FaultSpec", "FaultPlan.random",
                                  "FaultInjector.fire", "inject",
                                  "backoff_delays", "retry_with_backoff",
                                  "flip_bit", "corrupt_payload"])
def test_signature_is_the_reference(name):
    def get(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return obj

    want = inspect.signature(get(ref)).parameters
    got = inspect.signature(get(faults)).parameters
    assert list(got) == list(want)
    for k in want:
        assert got[k].kind == want[k].kind, k
        if k not in ("sleep", "retry_on"):
            assert got[k].default == want[k].default, k


@pytest.mark.parametrize("cls", ["InjectedFault", "TransientFault",
                                 "WireCorruption", "CheckpointCorruption"])
def test_fault_types_have_the_reference_bases(cls):
    mine, want = getattr(faults, cls), getattr(ref, cls)
    assert [b.__name__ for b in mine.__mro__] == \
        [b.__name__ for b in want.__mro__]


def _plan_tuple(plan):
    return (plan.seed, tuple(dataclass_tuple(s) for s in plan.specs))


def dataclass_tuple(spec):
    return (spec.site, spec.kind, spec.at, spec.shard, spec.times,
            spec.params)


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1),
       n_faults=st.integers(min_value=1, max_value=8))
def test_random_plan_equals_reference(seed, n_faults):
    mine = faults.FaultPlan.random(seed, n_faults=n_faults)
    want = ref.FaultPlan.random(seed, n_faults=n_faults)
    assert _plan_tuple(mine) == _plan_tuple(want)
    assert mine == faults.FaultPlan.random(seed, n_faults=n_faults)
    assert hash(mine) == hash(faults.FaultPlan.random(seed,
                                                      n_faults=n_faults))


@settings(max_examples=15, deadline=None, database=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_injector_history_equals_reference(seed):
    """The same plan fired at the same site occurrences logs the same
    history and spends the same budgets in both packages."""
    rng = np.random.default_rng(seed ^ 0xA5)
    specs = faults.FaultPlan.random(seed, n_faults=6).specs
    calls = [(specs[int(i)].site, int(rng.integers(0, 9)),
              int(rng.integers(0, 4)))
             for i in rng.integers(0, len(specs), size=40)]
    logs = []
    for mod in (faults, ref):
        inj = mod.FaultInjector(mod.FaultPlan.random(seed, n_faults=6))
        hits = [[dataclass_tuple(s) for s in inj.fire(site, index=i,
                                                      shard=sh)]
                for site, i, sh in calls]
        logs.append((hits, inj.fired, inj.exhausted(),
                     [inj.n_fired(s) for s in ref.SITES]))
    assert logs[0] == logs[1]


@pytest.mark.parametrize("kw,match", [
    (dict(site="no.such.site", kind="drop"), "unknown injection site"),
    (dict(site="exchange.wire", kind="kill_shard"), "not legal"),
    (dict(site="exchange.wire", kind="drop", times=0), "times"),
])
def test_spec_validation_matches_reference(kw, match):
    for mod in (faults, ref):
        with pytest.raises(ValueError, match=match):
            mod.FaultSpec(**kw)


def test_fire_kinds_filter_matches_reference():
    """Two call sites sharing one injection point each consume only their
    own kinds (the serve step's ``overload`` and ``fail_reduce``)."""
    out = []
    for mod in (faults, ref):
        inj = mod.FaultInjector(mod.FaultPlan.of(
            mod.FaultSpec("serve.step", "overload", at=1),
            mod.FaultSpec("serve.step", "fail_reduce", at=1, times=2)))
        out.append([
            [s.kind for s in inj.fire("serve.step", index=1,
                                      kinds=("fail_reduce",), attempt=a)]
            for a in range(3)]
            + [[s.kind for s in inj.fire("serve.step", index=1,
                                         kinds=("overload",))]]
            + [inj.fired, inj.exhausted()])
    assert out[0] == out[1]
    assert out[0][3] == ["overload"] and out[0][5] is True


def test_backoff_and_retry_match_reference():
    for seed in (0, 9, 123):
        np.testing.assert_array_equal(
            faults.backoff_delays(6, base_s=1e-3, seed=seed),
            ref.backoff_delays(6, base_s=1e-3, seed=seed))
    assert faults.backoff_delays(0).shape == (0,)
    seen = {}
    for mod in (faults, ref):
        calls, notes = [], []

        def flaky(a, mod=mod, calls=calls):
            calls.append(a)
            if a < 2:
                raise mod.TransientFault("again")
            return "ok"

        got = mod.retry_with_backoff(
            flaky, attempts=3, sleep=None, seed=4,
            on_retry=lambda a, e, d, notes=notes: notes.append((a, d)))
        seen[mod.__name__] = (got, calls, notes)
        with pytest.raises(mod.TransientFault):
            mod.retry_with_backoff(lambda a, mod=mod: (_ for _ in ()).throw(
                mod.TransientFault("always")), attempts=2, sleep=None)
        with pytest.raises(KeyError):      # not retried: propagates at once
            mod.retry_with_backoff(lambda a: {}[a], attempts=3, sleep=None)
        with pytest.raises(ValueError, match="attempts"):
            mod.retry_with_backoff(lambda a: a, attempts=0)
    assert seen[faults.__name__] == seen[ref.__name__]
    assert seen[faults.__name__][1] == [0, 1, 2]


def test_corruption_helpers_match_reference():
    buf = b"resilience"
    for bit in (0, 13, 79, 80, 12345):
        assert faults.flip_bit(buf, bit) == ref.flip_bit(buf, bit)
    assert faults.flip_bit(faults.flip_bit(buf, 13), 13) == buf
    assert faults.flip_bit(b"", 3) == b""
    payload = np.random.default_rng(2).integers(0, 2**32, size=17,
                                                dtype=np.uint32)
    for bit in (0, 31, 500):
        mine = faults.corrupt_payload(payload, bit)
        assert mine.dtype == np.uint32
        np.testing.assert_array_equal(mine, ref.corrupt_payload(payload,
                                                                bit))


@pytest.mark.parametrize("site,kind", [("harvest.tile", "fail_tile"),
                                       ("reduce.superstep", "kill_shard"),
                                       ("exchange.wire", "drop")])
def test_inject_refuses_uninstrumented_site(site, kind):
    """The three sites ``inject`` refused until their recovery paths were
    ported arm and fire: a distributed ``compute_ph`` (P = 2, the tiled
    harvest at 16 x 16 tiles) under a one-spec plan fires the reference's
    history and gives the reference's diagrams."""
    from repro.core import compute_ph as ref_compute_ph
    from repro_torch import compute_ph

    pts = np.random.default_rng(9).normal(size=(40, 3))
    kw = dict(points=pts, tau_max=1.2, maxdim=1, engine="packed",
              backend="tiled", tile_m=16, tile_n=16, n_shards=2,
              batch_size=8, exchange_every=1)
    with ref.inject(ref.FaultPlan.of(ref.FaultSpec(site, kind, at=1),
                                     seed=2)) as ref_inj:
        want = ref_compute_ph(**kw)
    with faults.inject(faults.FaultPlan.of(faults.FaultSpec(site, kind,
                                                            at=1),
                                           seed=2)) as inj:
        assert faults.active_injector() is inj
        got = compute_ph(device="cpu", **kw)
    assert faults.active_injector() is None
    assert inj.fired and inj.fired == ref_inj.fired
    for d in (0, 1):
        assert np.array_equal(got.diagrams[d], want.diagrams[d]), d


def test_inject_arms_and_restores():
    assert faults.active_injector() is None
    with faults.inject(None) as none:
        assert none is None and faults.active_injector() is None
    outer_plan = faults.FaultPlan.of(faults.FaultSpec("serve.step",
                                                      "overload"))
    with faults.inject(outer_plan) as outer:
        assert faults.active_injector() is outer
        with faults.inject(faults.FaultPlan.of(
                faults.FaultSpec("resume.load", "truncate"))) as inner:
            assert faults.active_injector() is inner
        assert faults.active_injector() is outer
    assert faults.active_injector() is None
