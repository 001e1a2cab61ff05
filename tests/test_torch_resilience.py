"""The port's recovery paths on the CPU against the JAX package's: the
distributed packed reduction under shard kills, stragglers and wire
faults (``tests/test_resilience.py``'s fault sweep), the tile retries of
the harvest, and the shard supervisor of ``launch/elastic.py``.

Under every plan the port's diagrams equal the reference's under the same
plan and the fault-free run's, the injectors fire the same history, and on
the numpy path every ``resilience_*`` counter (and the count of each
``resilience_*`` histogram) equals the reference's.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.homology import compute_ph as ref_compute_ph
from repro.launch import elastic as ref_elastic
from repro.resilience import faults as ref_faults
from repro.scale import build_filtration_tiled as ref_build_tiled
from repro.scale.shard import build_filtration_sharded as ref_build_sharded
from repro_torch import compute_ph
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core.packed_reduce import reduce_dimension_packed
from repro_torch.launch import elastic
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.obs.trace import Tracer, critical_path, tracing
from repro_torch.resilience import faults
from repro_torch.scale import build_filtration_tiled
from repro_torch.scale.shard import build_filtration_sharded


def _cloud(n=48, seed=7):
    return np.random.default_rng(seed).normal(size=(n, 3))


DIST = dict(engine="packed", n_shards=4, batch_size=16, exchange_every=1,
            tau_max=1.2, maxdim=2)

# tests/test_resilience.py's FAULT_CASES, plus a drop that outlasts the
# retry budget (the payload is deferred to the next round)
FAULT_CASES = [
    ("kill_start", dict(site="reduce.superstep", kind="kill_shard", at=2,
                        shard=1, params=(("when", "start"),))),
    ("kill_mid", dict(site="reduce.superstep", kind="kill_shard", at=2,
                      shard=2, params=(("when", "mid"),))),
    ("slow_shard", dict(site="reduce.superstep", kind="slow_shard", at=1,
                        shard=3, times=2, params=(("lag", 2.0),
                                                  ("duration", 2)))),
    ("drop", dict(site="exchange.wire", kind="drop", at=1, shard=0,
                  times=2)),
    ("corrupt", dict(site="exchange.wire", kind="corrupt", at=1, shard=1,
                     params=(("bit", 37),))),
    ("delay", dict(site="exchange.wire", kind="delay", at=1, shard=2,
                   params=(("delay_s", 1e-3),))),
    ("defer", dict(site="exchange.wire", kind="drop", at=1, shard=0,
                   times=3)),
]

COMBINED = [
    dict(site="reduce.superstep", kind="kill_shard", at=2, shard=1,
         params=(("when", "start"),)),
    dict(site="exchange.wire", kind="drop", at=2, shard=0),
    dict(site="exchange.wire", kind="corrupt", at=3, shard=0,
         params=(("bit", 5),)),
]


def _plans(specs, seed):
    """The same plan in both packages."""
    return (ref_faults.FaultPlan.of(*[ref_faults.FaultSpec(**s)
                                      for s in specs], seed=seed),
            faults.FaultPlan.of(*[faults.FaultSpec(**s) for s in specs],
                                seed=seed))


def _resilience(stats):
    """Every ``resilience_*`` counter, and each histogram's count."""
    return {k: v for k, v in stats.items() if "resilience_" in k
            and (k.endswith("_count") or not k.endswith(
                ("_sum", "_min", "_max", "_s")))}


def _both(specs, seed, **kw):
    """Reference and port, each under its own copy of the plan: results
    and fired histories."""
    ref_plan, plan = _plans(specs, seed)
    with ref_faults.inject(ref_plan) as ref_inj:
        ref = ref_compute_ph(_cloud(), **kw)
    with faults.inject(plan) as inj:
        got = compute_ph(_cloud(), device="cpu", **kw)
    return ref, got, ref_inj.fired, inj.fired


def _assert_same(a, b):
    assert set(a.diagrams) == set(b.diagrams)
    for d in a.diagrams:
        np.testing.assert_array_equal(a.diagrams[d], b.diagrams[d])


@pytest.fixture(scope="module")
def clean():
    return {"single": ref_compute_ph(_cloud(), tau_max=1.2, maxdim=2,
                                     engine="single"),
            "dist": compute_ph(_cloud(), device="cpu", **DIST)}


def test_fault_free_distributed_matches_single(clean):
    _assert_same(clean["dist"], clean["single"])
    counters = _resilience(clean["dist"].stats)
    assert counters and not any(counters.values())


@pytest.mark.parametrize("name,spec", FAULT_CASES,
                         ids=[n for n, _ in FAULT_CASES])
def test_faulted_run_matches_reference(clean, name, spec):
    ref, got, ref_fired, fired = _both([spec], 11, **DIST)
    assert fired, f"{name} never fired - dead test"
    assert fired == ref_fired
    _assert_same(got, ref)
    _assert_same(got, clean["dist"])
    _assert_same(got, clean["single"])
    assert _resilience(got.stats) == _resilience(ref.stats)
    for k in ("n_supersteps", "n_rounds", "n_reductions",
              "n_exchange_rounds", "exchange_bytes"):
        for dim in ("h1", "h2"):
            assert got.stats[f"{dim}_{k}"] == ref.stats[f"{dim}_{k}"], k


@pytest.mark.parametrize("n_shards", [2, 4])
def test_combined_plan_across_shard_counts(clean, n_shards):
    ref, got, ref_fired, fired = _both(COMBINED, 3,
                                       **dict(DIST, n_shards=n_shards))
    assert fired and fired == ref_fired
    _assert_same(got, ref)
    _assert_same(got, clean["single"])
    assert _resilience(got.stats) == _resilience(ref.stats)


def test_recovery_counters_surface_in_stats():
    ref, got, _, _ = _both([FAULT_CASES[0][1]], 0, **DIST)
    deaths = sum(v for k, v in got.stats.items()
                 if k.endswith("resilience_n_shard_deaths"))
    redeals = sum(v for k, v in got.stats.items()
                  if k.endswith("resilience_n_redeals"))
    assert deaths == 1 and redeals >= 1
    assert _resilience(got.stats) == _resilience(ref.stats)


def test_all_shards_dead_raises():
    specs = [dict(site="reduce.superstep", kind="kill_shard", at=1, shard=s,
                  params=(("when", "start"),)) for s in range(4)]
    ref_plan, plan = _plans(specs, 0)
    with ref_faults.inject(ref_plan):
        with pytest.raises(RuntimeError, match="every reduction shard"):
            ref_compute_ph(_cloud(), **DIST)
    with faults.inject(plan):
        with pytest.raises(RuntimeError, match="every reduction shard"):
            compute_ph(_cloud(), device="cpu", **DIST)


def _h1_packed(plan, **kw):
    filt = build_filtration(points=_cloud(40, seed=2))
    h0 = compute_h0(filt)
    cols = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
    with faults.inject(plan):
        return reduce_dimension_packed(make_h1_adapter(filt, sparse=True),
                                       cols, cleared=h0.death_edges,
                                       batch_size=16, exchange_every=1,
                                       device="cpu", **kw)


@pytest.mark.parametrize("name", ["kill_start", "kill_mid", "defer"])
def test_kernel_path_recovers_exactly(name):
    """``use_kernels=True`` (the kernels' plain versions on the CPU):
    after a kill the fused block holds fewer slices, so its eviction threshold
    (``_EVICT_MAX`` per slice) changes; a mid-superstep kill discards the
    block and restarts the superstep.  Diagrams stay the fault-free
    run's."""
    spec = dict(FAULT_CASES)[name]
    clean = _h1_packed(None, n_shards=4, use_kernels=True)
    got = _h1_packed(faults.FaultPlan.of(faults.FaultSpec(**spec), seed=1),
                     n_shards=4, use_kernels=True)
    np.testing.assert_array_equal(got.diagram(), clean.diagram())
    np.testing.assert_array_equal(got.pivot_lows, clean.pivot_lows)
    assert got.stats["use_kernels"] == 1.0
    assert sum(v for k, v in got.stats.items()
               if k.startswith("resilience_n_")) > 0


def test_sim_wall_is_the_critical_path_of_a_faulted_run():
    """``sim_wall_s`` is derived from the span timeline, which under a
    mid-superstep kill also holds the ``resilience/recover`` span."""
    tracer = Tracer()
    spec = dict(FAULT_CASES)["kill_mid"]
    with tracing(tracer):
        res = _h1_packed(faults.FaultPlan.of(faults.FaultSpec(**spec)),
                         n_shards=4)
    names = [s.name for s in tracer.spans]
    assert "resilience/recover" in names
    recover = [s for s in tracer.spans if s.name == "resilience/recover"]
    assert recover[0].attrs["kind"] == "kill_mid"
    assert res.stats["sim_wall_s"] == pytest.approx(
        critical_path(tracer.spans)["sim_wall_s"], rel=1e-12)
    assert res.stats["resilience_recover_s_count"] == 1


@pytest.mark.parametrize("kind", ["kill_shard", "slow_shard"])
def test_shrink_over_a_mesh_raises_reference_error(kind):
    """The reference refuses a mesh together with an elastic shrink; the
    port's mesh does too, at the superstep the fault fires."""
    spec = dict(site="reduce.superstep", kind=kind, at=1, shard=1)
    _, plan = _plans([spec], 0)
    mesh = make_data_mesh(4, devices=["cpu"] * 4)
    with faults.inject(plan):
        with pytest.raises(ValueError, match="host-partitioned driver"):
            compute_ph(_cloud(), tau_max=1.2, maxdim=1, engine="packed",
                       mesh=mesh, batch_size=16)


@pytest.mark.parametrize("name", ["drop", "corrupt", "delay", "defer"])
def test_wire_faults_over_a_mesh(clean, name):
    """Wire faults over a cpu x 4 mesh: a deferred slot ships an empty
    payload through the stacked gather (its padding decodes as no
    records); diagrams and counters equal the loop-back's under the same
    plan."""
    spec = dict(FAULT_CASES)[name]
    mesh = make_data_mesh(4, devices=["cpu"] * 4)
    kw = dict(DIST)
    kw.pop("n_shards")
    runs = []
    for where in (dict(mesh=mesh), dict(n_shards=4, device="cpu")):
        _, plan = _plans([spec], 11)
        with faults.inject(plan) as inj:
            runs.append(compute_ph(_cloud(), **kw, **where))
            assert inj.fired
    _assert_same(runs[0], runs[1])
    _assert_same(runs[0], clean["single"])
    assert _resilience(runs[0].stats) == _resilience(runs[1].stats)


# ---------------------------------------------------------------------------
# the tile retries (harvest.tile)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("times", [1, 2, 3])
def test_tile_retries_match_reference(times):
    """A tile that fails ``times`` times is harvested again (up to 3
    attempts): the filtration is the fault-free one and ``tile_retries``
    the reference's; a tile that fails every attempt raises the
    ``TransientFault`` in both packages."""
    spec = dict(site="harvest.tile", kind="fail_tile", at=3, times=times)
    ref_plan, plan = _plans([spec], 0)
    pts = _cloud(60, seed=3)
    kw = dict(points=pts, tau_max=1.1, tile_m=16, tile_n=16,
              return_stats=True)
    if times == 3:
        with ref_faults.inject(ref_plan):
            with pytest.raises(ref_faults.TransientFault):
                ref_build_tiled(**kw)
        with faults.inject(plan):
            with pytest.raises(faults.TransientFault):
                build_filtration_tiled(device="cpu", **kw)
        return
    with ref_faults.inject(ref_plan) as ref_inj:
        ref, ref_stats = ref_build_tiled(**kw)
    with faults.inject(plan) as inj:
        got, stats = build_filtration_tiled(device="cpu", **kw)
    clean = build_filtration_tiled(device="cpu", **kw)[0]
    assert inj.fired == ref_inj.fired and len(inj.fired) == times
    assert stats.tile_retries == ref_stats.tile_retries == times
    for f in (ref, clean):
        np.testing.assert_array_equal(got.edges, f.edges)
        np.testing.assert_array_equal(got.edge_len, f.edge_len)


def test_tile_retries_in_the_host_sharded_harvest():
    """The host-partitioned sharded harvest replays each shard's tiles
    through the same loop, so the site fires there too, at each shard's
    tile ordinal, as in the reference."""
    spec = dict(site="harvest.tile", kind="fail_tile", at=1, times=2)
    ref_plan, plan = _plans([spec], 0)
    kw = dict(points=_cloud(60, seed=4), tau_max=1.1, tile_m=16,
              tile_n=16, n_shards=2, return_stats=True)
    with ref_faults.inject(ref_plan) as ref_inj:
        ref, ref_stats = ref_build_sharded(**kw)
    with faults.inject(plan) as inj:
        got, stats = build_filtration_sharded(device="cpu", **kw)
    assert inj.fired == ref_inj.fired
    assert stats.tile_retries == ref_stats.tile_retries > 0
    np.testing.assert_array_equal(got.edges, ref.edges)
    np.testing.assert_array_equal(got.edge_len, ref.edge_len)


# ---------------------------------------------------------------------------
# launch/elastic.py
# ---------------------------------------------------------------------------

def _plan_tuple(plan):
    return (plan.dead, plan.stragglers, plan.active)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_supervisor_observe_sequences_match_reference(seed):
    """Seeded beat sequences (missed beats, lags, early kills) give the
    reference's plans, live sets and heartbeat tables step by step."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 7))
    kw = dict(timeout=float(rng.choice([0.75, 1.5, 3.0])),
              factor=float(rng.choice([2.0, 3.0])),
              sideline=int(rng.integers(1, 3)))
    ref = ref_elastic.ShardSupervisor(n, **kw)
    got = elastic.ShardSupervisor(n, **kw)
    for step in range(1, 13):
        now = float(step)
        beats = {}
        for s in range(n):
            u = rng.random()
            if u < 0.15:
                continue                          # missed beat
            beats[s] = now - (float(rng.uniform(0.0, 2.0))
                              if u < 0.35 else 0.0)
        if rng.random() < 0.1:
            victim = int(rng.integers(0, n))
            ref.kill(victim)
            got.kill(victim)
        a, b = ref.observe(now, beats), got.observe(now, beats)
        assert _plan_tuple(a) == _plan_tuple(b), step
        assert ref.live == got.live
        assert ref.hb.beats == got.hb.beats


def test_supervisor_refuses_no_shards():
    for mod in (ref_elastic, elastic):
        with pytest.raises(ValueError, match="n_shards"):
            mod.ShardSupervisor(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heartbeat_and_speculative_reassign_match_reference(seed):
    rng = np.random.default_rng(seed)
    ref_hb, hb = ref_elastic.Heartbeat(timeout_s=2.0), \
        elastic.Heartbeat(timeout_s=2.0)
    for h in range(6):
        t = float(rng.uniform(0, 10))
        ref_hb.beat(h, t=t)
        hb.beat(h, t=t)
    assert ref_hb.dead(now=10.0) == hb.dead(now=10.0)
    assert ref_hb.stragglers(now=10.0) == hb.stragglers(now=10.0)
    lagging = sorted(int(x) for x in rng.choice(6, size=2, replace=False))
    base = {h: [i for i in range(24) if i % 6 == h] for h in range(6)}
    a = {h: list(v) for h, v in base.items()}
    b = {h: list(v) for h, v in base.items()}
    assert ref_elastic.speculative_reassign(a, lagging) == \
        elastic.speculative_reassign(b, lagging)
    assert a == b
