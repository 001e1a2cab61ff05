"""The port's PH service (``repro_torch.serve.ph``) on the CPU against the
JAX package's ``repro.serve.ph``: the same requests, made from a seed with
numpy, through both ``PHServeEngine``\\ s (the port's with ``device="cpu"``).

Every response must equal the reference's field by field, latencies aside:
``path``, ``granted_tau``, the ``AdmissionDecision``, ``cached``, the
landmark fields, the degradation fields and the diagrams (exact,
``np.array_equal``); and the ``serve_ph_*`` counters must be equal, the
latency histogram's sums and extremes aside.  The scenarios mirror
``tests/test_serve_ph.py`` and the serving half of
``tests/test_resilience.py``; the reference launcher's ``run_ph`` traffic
runs at its defaults.  Deadline degradation compares a request with the
engine's own observed cold wall time, so it is held within the port.
"""
import argparse
import dataclasses
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import repro.launch.serve as ref_launch
import repro.serve.ph as ref_ph
from repro.resilience import faults as ref_faults
import repro_torch.launch.serve as launch
import repro_torch.serve.ph as ph
from repro_torch import compute_ph
from repro_torch.core.resume import canonical_diagram
from repro_torch.resilience import faults
from repro_torch.scale.budget import maxmin_landmarks

PORT = SimpleNamespace(ph=ph, faults=faults, kw=dict(device="cpu"))
REF = SimpleNamespace(ph=ref_ph, faults=ref_faults, kw={})


def cloud(seed, n, d=3):
    return np.random.default_rng(seed).normal(size=(n, d))


def cold(points, tau, maxdim=2):
    res = compute_ph(points=points, tau_max=tau, maxdim=maxdim,
                     mode="implicit", device="cpu")
    return {d: canonical_diagram(res.diagrams[d]) for d in res.diagrams}


def assert_responses_equal(mine, want):
    assert sorted(mine) == sorted(want)
    for uid, w in want.items():
        m = mine[uid]
        for f in dataclasses.fields(w):
            if f.name in ("latency_s", "diagrams", "admission"):
                continue
            assert getattr(m, f.name) == getattr(w, f.name), (uid, f.name)
        assert dataclasses.asdict(m.admission) == \
            dataclasses.asdict(w.admission), uid
        if w.diagrams is None:
            assert m.diagrams is None, uid
            continue
        assert sorted(m.diagrams) == sorted(w.diagrams), uid
        for d, pd in w.diagrams.items():
            assert np.array_equal(m.diagrams[d], pd), (uid, d)


def assert_stats_equal(mine, want):
    """Equal ``serve_ph_*`` stats; of the latency histogram only the
    count (the walls are each package's own)."""
    assert sorted(mine) == sorted(want)
    for k, v in want.items():
        if k.startswith("serve_ph_latency_s_") \
                and k != "serve_ph_latency_s_count":
            continue
        assert mine[k] == v, k


# ---------------------------------------------------------------------------
# scenarios: each runs one engine of a package and returns it
# ---------------------------------------------------------------------------

def sc_cold_hit_warm(pkg):
    pts = cloud(40, 19)
    eng = pkg.ph.PHServeEngine(engine="single", **pkg.kw)
    for uid, (p, tau) in enumerate([
            (pts, 1.6), (pts, 1.6), (pts, 2.4),
            (np.concatenate([pts, cloud(42, 6)], axis=0), 2.4)]):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=p, tau_max=tau,
                                    dataset="a"))
        eng.run()
    return eng


def _warm_packed(pkg, **opts):
    pts = cloud(41, 18)
    grown = np.concatenate([pts, cloud(42, 6)], axis=0)
    eng = pkg.ph.PHServeEngine(engine="packed", batch_size=16, **opts,
                               **pkg.kw)
    for uid, (p, tau) in enumerate([(pts, 1.4), (pts, 2.1), (grown, 2.1)]):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=p, tau_max=tau,
                                    dataset="a"))
        eng.run()
    return eng


def sc_warm_packed(pkg):
    return _warm_packed(pkg)


def sc_warm_packed_p2(pkg):
    return _warm_packed(pkg, n_shards=2)


def sc_batched(pkg):
    eng = pkg.ph.PHServeEngine(engine="single", max_batch_clouds=3,
                               **pkg.kw)
    for uid, n in enumerate((11, 16, 8, 13, 9)):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=cloud(50 + uid, n),
                                    tau_max=1.8, dataset=f"d{uid}"))
    eng.run()
    return eng


def sc_reject(pkg):
    eng = pkg.ph.PHServeEngine(memory_budget_bytes=16, engine="single",
                               **pkg.kw)
    eng.submit(pkg.ph.PHRequest(uid=0, points=cloud(60, 30), tau_max=2.0))
    eng.run()
    return eng


def sc_clamp(pkg):
    eng = pkg.ph.PHServeEngine(memory_budget_bytes=30_000, engine="single",
                               **pkg.kw)
    eng.submit(pkg.ph.PHRequest(uid=0, points=cloud(61, 40),
                                tau_max=np.inf))
    eng.run()
    return eng


def sc_tenants(pkg):
    eng = pkg.ph.PHServeEngine(store_budget_bytes=50_000, engine="single",
                               **pkg.kw)
    for uid in range(6):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=cloud(70 + uid, 14),
                                    tau_max=2.0, dataset=f"d{uid}",
                                    tenant="a" if uid % 2 else "b"))
    eng.run()
    return eng


def sc_evict_oversized(pkg):
    eng = pkg.ph.PHServeEngine(store_budget_bytes=1, engine="single",
                               **pkg.kw)
    eng.submit(pkg.ph.PHRequest(uid=0, points=cloud(80, 12), tau_max=1.8,
                                dataset="d0"))
    eng.run()
    return eng


def sc_lru(pkg):
    """Three datasets of one tenant under a budget that holds two: the
    least recently used one goes, and a request for it turns cold again."""
    eng = pkg.ph.PHServeEngine(store_budget_bytes=8_000, engine="single",
                               **pkg.kw)
    pts = [cloud(85 + k, 13) for k in range(3)]
    for uid, k in enumerate((0, 1, 0, 2, 1, 0)):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=pts[k], tau_max=1.9,
                                    dataset=f"d{k}"))
        eng.run()
    return eng


def sc_landmarks(pkg):
    big = cloud(81, 60)
    eng = pkg.ph.PHServeEngine(landmark_cap=20, engine="single", **pkg.kw)
    for uid, tau in enumerate((2.5, 3.2)):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=big, tau_max=tau,
                                    dataset="big"))
        eng.run()
    return eng


def sc_maxdim_mismatch(pkg):
    pts = cloud(82, 15)
    eng = pkg.ph.PHServeEngine(engine="single", **pkg.kw)
    for uid, (tau, md) in enumerate([(1.7, 2), (2.2, 1)]):
        eng.submit(pkg.ph.PHRequest(uid=uid, points=pts, tau_max=tau,
                                    dataset="a", maxdim=md))
        eng.run()
    return eng


def sc_pinned(pkg):
    """At the tenant byte cap, the entry warmed in a step survives the
    cold arrival of the same step (the reference's regression test)."""
    p_warm, p_cold = cloud(90, 24), cloud(91, 24)
    pilot = pkg.ph.PHServeEngine(engine="single", **pkg.kw)
    pilot.submit(pkg.ph.PHRequest(uid=0, points=p_warm, tau_max=1.3,
                                  dataset="w"))
    pilot.submit(pkg.ph.PHRequest(uid=1, points=p_cold, tau_max=1.3,
                                  dataset="c"))
    pilot.run()
    s_warm = pilot._cache[("default", "w")].nbytes()
    s_cold = pilot._cache[("default", "c")].nbytes()
    eng = pkg.ph.PHServeEngine(
        engine="single",
        store_budget_bytes=max(s_warm, s_cold) + min(s_warm, s_cold) // 2,
        **pkg.kw)
    eng.submit(pkg.ph.PHRequest(uid=0, points=p_warm, tau_max=1.0,
                                dataset="w"))
    eng.step()
    eng.submit(pkg.ph.PHRequest(uid=1, points=p_warm, tau_max=1.3,
                                dataset="w"))
    eng.submit(pkg.ph.PHRequest(uid=2, points=p_cold, tau_max=1.3,
                                dataset="c"))
    eng.step()
    eng.submit(pkg.ph.PHRequest(uid=3, points=p_warm, tau_max=1.3,
                                dataset="w"))
    eng.step()
    return eng


def _pts(seed=0, n=24):
    return np.random.default_rng(seed).normal(size=(n, 3))


def sc_breaker(pkg):
    eng = pkg.ph.PHServeEngine(max_cold_retries=1, breaker_threshold=1,
                               breaker_cooldown_steps=2, **pkg.kw)
    plan = pkg.faults.FaultPlan.of(
        pkg.faults.FaultSpec("serve.step", "fail_reduce", at=1, times=2))
    with pkg.faults.inject(plan) as inj:
        eng.submit(pkg.ph.PHRequest(uid=0, points=_pts(), tau_max=1.4))
        eng.step()
        eng.submit(pkg.ph.PHRequest(uid=1, points=_pts(), tau_max=1.4))
        eng.step()
        for _ in range(2):
            eng.step()
        eng.submit(pkg.ph.PHRequest(uid=2, points=_pts(), tau_max=1.4))
        eng.step()
    eng.fired = inj.fired
    return eng


def sc_overload(pkg):
    eng = pkg.ph.PHServeEngine(degrade_tau_factor=0.5, degrade_maxdim=1,
                               **pkg.kw)
    plan = pkg.faults.FaultPlan.of(
        pkg.faults.FaultSpec("serve.step", "overload", at=1))
    with pkg.faults.inject(plan) as inj:
        eng.submit(pkg.ph.PHRequest(uid=0, points=_pts(1), tau_max=2.0,
                                    maxdim=2))
        eng.step()
    eng.fired = inj.fired
    return eng


def sc_queue_depth(pkg):
    eng = pkg.ph.PHServeEngine(shed_queue_depth=1, **pkg.kw)
    eng.submit(pkg.ph.PHRequest(uid=0, points=_pts(2), tau_max=1.2))
    eng.submit(pkg.ph.PHRequest(uid=1, points=_pts(3), tau_max=1.2))
    eng.step()
    return eng


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_cold_hit_warm, sc_warm_packed, sc_warm_packed_p2, sc_batched,
    sc_reject, sc_clamp, sc_tenants, sc_evict_oversized, sc_lru,
    sc_landmarks, sc_maxdim_mismatch, sc_pinned, sc_breaker, sc_overload,
    sc_queue_depth)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    mine, want = SCENARIOS[name](PORT), SCENARIOS[name](REF)
    assert_responses_equal(mine.done, want.done)
    assert_stats_equal(mine.stats(), want.stats())
    assert [dataclasses.asdict(d) for d in mine.admission_log] == \
        [dataclasses.asdict(d) for d in want.admission_log]
    assert mine.tenant_bytes() == want.tenant_bytes()
    assert sorted(mine._cache) == sorted(want._cache)
    assert getattr(mine, "fired", None) == getattr(want, "fired", None)


# ---------------------------------------------------------------------------
# what each scenario must show, held within the port
# ---------------------------------------------------------------------------

def test_warm_paths_equal_cold_compute_ph():
    eng = sc_cold_hit_warm(PORT)
    assert [eng.done[u].path for u in range(4)] == \
        ["cold", "hit", "warm_tau", "warm_points"]
    pts = cloud(40, 19)
    grown = np.concatenate([pts, cloud(42, 6)], axis=0)
    for uid, (p, tau) in ((0, (pts, 1.6)), (2, (pts, 2.4)),
                          (3, (grown, 2.4))):
        want = cold(p, tau)
        for d in (0, 1, 2):
            assert np.array_equal(eng.done[uid].diagrams[d], want[d]), uid
    for d in (0, 1, 2):
        assert np.array_equal(eng.done[1].diagrams[d],
                              eng.done[0].diagrams[d])
    packed = sc_warm_packed_p2(PORT)
    assert [packed.done[u].path for u in range(3)] == \
        ["cold", "warm_tau", "warm_points"]


def test_admission_clamps_and_rejects():
    r = sc_reject(PORT).done[0]
    assert not r.admitted and r.path == "rejected" and r.diagrams is None
    eng = sc_clamp(PORT)
    r = eng.done[0]
    assert r.admitted and np.isfinite(r.granted_tau)
    assert "clamped" in r.admission.reason
    want = cold(cloud(61, 40), r.granted_tau)
    for d in (0, 1, 2):
        assert np.array_equal(r.diagrams[d], want[d]), d
    replay = eng.admission_account(cloud(61, 40), np.inf)
    assert dataclasses.asdict(replay) == dataclasses.asdict(
        dataclasses.replace(eng.admission_log[0], uid=-1))


def test_tenant_isolation_and_lru():
    eng = sc_tenants(PORT)
    assert all(v <= 50_000 for v in eng.tenant_bytes().values())
    assert all(eng.done[u].admitted for u in range(6))
    eng = sc_lru(PORT)
    assert [eng.done[u].path for u in range(6)] == \
        ["cold", "cold", "hit", "cold", "cold", "cold"]
    assert eng.stats()["serve_ph_n_evictions"] == 3
    eng = sc_evict_oversized(PORT)
    assert not eng.done[0].cached and eng.tenant_bytes() == {}
    eng = sc_pinned(PORT)
    assert eng.done[1].path == "warm_tau" and eng.done[1].cached
    assert not eng.done[2].cached and eng.done[3].path == "hit"


def test_landmark_cap_serves_the_landmark_cloud():
    eng = sc_landmarks(PORT)
    big = cloud(81, 60)
    idx, _ = maxmin_landmarks(big, 20, seed=0)
    assert eng.done[0].n_landmarks == 20 and eng.done[1].path == "warm_tau"
    for uid, tau in ((0, 2.5), (1, 3.2)):
        want = cold(big[idx], tau)
        for d in (0, 1, 2):
            assert np.array_equal(eng.done[uid].diagrams[d], want[d])


def test_degradation_is_explicit():
    eng = sc_breaker(PORT)
    assert [eng.done[u].degraded_reason for u in range(3)] == \
        ["cold_failed", "circuit_open", ""]
    assert eng.done[2].diagrams is not None
    s = eng.stats()
    assert (s["serve_ph_n_degraded"], s["serve_ph_n_cold_retries"],
            s["serve_ph_n_circuit_open"]) == (2, 1, 1)
    r = sc_overload(PORT).done[0]
    assert r.degraded and r.degraded_reason == "overload"
    assert r.granted_tau == pytest.approx(1.0) and set(r.diagrams) == {0, 1}
    assert not r.cached
    direct = _served(_pts(1), tau=1.0, maxdim=1)
    for d in (0, 1):
        assert np.array_equal(r.diagrams[d], direct.diagrams[d])
    q = sc_queue_depth(PORT).done
    assert not q[0].degraded and q[1].degraded_reason == "queue_depth"


def _served(points, tau, maxdim):
    """One request through a fresh engine of the port."""
    eng = ph.PHServeEngine(device="cpu")
    eng.submit(ph.PHRequest(uid=0, points=points, tau_max=tau,
                            maxdim=maxdim))
    eng.step()
    return eng.done[0]


def test_deadline_degrade_uses_observed_cold_latency():
    eng = ph.PHServeEngine(default_deadline_s=1e-12, degrade_maxdim=1,
                           device="cpu")
    eng.submit(ph.PHRequest(uid=0, points=_pts(4), tau_max=1.2, maxdim=2))
    eng.step()                  # establishes the cold-latency EWMA
    assert not eng.done[0].degraded
    eng.submit(ph.PHRequest(uid=1, points=_pts(5), tau_max=1.2, maxdim=2))
    eng.step()
    r = eng.done[1]
    assert r.degraded and r.degraded_reason == "deadline"
    assert set(r.diagrams) == {0, 1}
    assert eng.stats()["serve_ph_n_deadline_degraded"] == 1
    eng2 = ph.PHServeEngine(default_deadline_s=None, degrade_maxdim=1,
                            device="cpu")
    eng2.submit(ph.PHRequest(uid=0, points=_pts(4), tau_max=1.2))
    eng2.step()
    eng2.submit(ph.PHRequest(uid=1, points=_pts(5), tau_max=1.2, maxdim=2,
                             deadline_s=1e-12))
    eng2.step()
    assert eng2.done[1].degraded_reason == "deadline"


def test_fingerprint_matches_reference():
    a = cloud(83, 10)
    assert ph.fingerprint_points(a) == ref_ph.fingerprint_points(a)
    assert ph.fingerprint_points(a) != ph.fingerprint_points(a + 1e-12)
    assert ph.fingerprint_points(a) != ph.fingerprint_points(a[:9])


def test_engine_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ph.PHServeEngine(engine="packed")
    assert ph.PHServeEngine(engine="packed", device="cpu").device.type \
        == "cpu"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _parsed(monkeypatch, main, argv):
    """The args ``main`` hands ``run_ph`` for ``argv`` (not run)."""
    got = []
    mod = sys.modules[main.__module__]
    monkeypatch.setattr(mod, "run_ph", got.append)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main() if mod is ref_launch else main(argv)
    monkeypatch.undo()
    return got[0]


def test_ph_flags_match_reference(monkeypatch):
    mine = vars(_parsed(monkeypatch, launch.main, ["--workload", "ph"]))
    want = vars(_parsed(monkeypatch, ref_launch.main, ["--workload", "ph"]))
    assert {k: v for k, v in mine.items() if k not in ("device", "full")} \
        == want
    assert mine["device"] is None


def test_launcher_traffic_matches_reference(monkeypatch, capsys):
    """``run_ph`` at the reference launcher's defaults (16 requests, clouds
    of 48 points) in both packages: equal responses and counters."""
    args = _parsed(monkeypatch, ref_launch.main, ["--workload", "ph"])
    engines = []

    class Recorded(ref_ph.PHServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(ref_ph, "PHServeEngine", Recorded)
    ref_launch.run_ph(args)
    want = capsys.readouterr().out
    mine = launch.run_ph(argparse.Namespace(**vars(args), device="cpu"))
    out = capsys.readouterr().out
    assert_responses_equal(mine.done, engines[0].done)
    assert_stats_equal(mine.stats(), engines[0].stats())
    assert len(mine.done) == 16
    # the summary's lines after the first (which holds the walls)
    assert out.splitlines()[1:] == want.splitlines()[1:]
    assert out.startswith("served 16/16 PH requests in ")
