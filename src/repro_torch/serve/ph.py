"""PH-as-a-service: batched, cache-warm topology serving.

Port of ``src/repro/serve/ph.py``.  ``PHServeEngine`` takes ``device``
last (before the reducer options): ``None`` is the card and raises
``RuntimeError`` without one, ``"cpu"`` runs the kernels' plain versions.
Admission, the cache, filtrations (``build_filtration``'s dense host path)
and batching are the reference's host numpy; the reductions run on
``device`` (the packed engine's GF(2) kernels).  Responses are the
reference's field by field, latencies aside.

``PHServeEngine`` turns the reduction stack into a request/response service
for many small-to-medium point clouds, reusing every piece of the paper's
memory story instead of re-deriving it per request:

* **Admission control** — each request passes through the
  ``(3n + 12 n_e) * 4``-byte account (:func:`repro_torch.scale.budget
  .estimate_tau_max`): the requested ``tau_max`` is *clamped* to what the
  service's ``memory_budget_bytes`` affords, and requests whose ``O(n)``
  part alone overflows are rejected with a reproducible
  :class:`AdmissionDecision` (the decision is a pure function of
  ``(points, budget, seed)``, so a rejection can be re-derived offline from
  the logged account).
* **Dataset cache** — landmarks, filtrations and reduction checkpoints
  (:class:`repro_torch.core.resume.ReductionCheckpoint`) are cached per
  ``(tenant, dataset)`` keyed by a content fingerprint, with per-tenant
  ``store_budget_bytes`` isolation enforced by LRU whole-dataset eviction.
* **Warm starts** — a request that *extends* a cached dataset is served
  incrementally: tau growth skips every previously committed pair
  (:func:`~repro_torch.core.resume.warm_tau_growth`), point arrival
  replays from the recorded V-expansions
  (:func:`~repro_torch.core.resume.warm_point_arrival`).  Both are
  bit-identical to a cold reduction (``tests/test_torch_serve_ph.py`` holds
  them against the reference and a cold run).
* **Union batching** — cold requests drained in one :meth:`step` are packed
  into a single block-diagonal reduction
  (:func:`~repro_torch.core.resume.batched_cold_reduce`), amortizing engine
  dispatch across clouds with *exact* per-cloud results.
* **Graceful degradation** — per-request deadlines, bounded cold-retry
  with deterministic backoff
  (:func:`repro_torch.resilience.faults.retry_with_backoff`), a circuit
  breaker per ``(tenant, dataset)``, and load shedding under queue/overload
  pressure.  A degraded request is served with clamped ``tau`` / lowered
  ``maxdim`` and the response says so explicitly
  (``PHResponse.degraded`` + ``degraded_reason``) — degradation is never
  silent and never an exception.

Everything is deterministic given ``(seed, arrival order)`` and instrumented
through the ``serve_ph_*`` names in the :mod:`repro_torch.obs.metrics`
schema.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.filtration import Filtration, build_filtration
from ..core.resume import (ReductionCheckpoint, batched_cold_reduce,
                           canonical_diagram, make_reducer,
                           warm_point_arrival, warm_tau_growth)
from ..device import DeviceLike, resolve_device
from ..obs.metrics import MetricsRegistry
from ..obs.trace import span, stopwatch
from ..resilience.faults import (TransientFault, active_injector,
                                 retry_with_backoff)
from ..scale.budget import (account_bytes, estimate_tau_max,
                            maxmin_landmarks, sample_pair_lengths)


def fingerprint_points(points: np.ndarray) -> str:
    """Content fingerprint of a point cloud (shape + dtype + raw bytes)."""
    p = np.ascontiguousarray(points)
    h = hashlib.sha256()
    h.update(str(p.shape).encode())
    h.update(str(p.dtype).encode())
    h.update(p.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class PHRequest:
    uid: int
    points: np.ndarray
    tau_max: float = np.inf
    tenant: str = "default"
    dataset: Optional[str] = None   # default: content-addressed by fingerprint
    maxdim: int = 2
    deadline_s: Optional[float] = None   # None: engine default_deadline_s


@dataclasses.dataclass
class AdmissionDecision:
    """The reproducible memory account behind an admit/reject/clamp.

    ``predicted_bytes = account_bytes(n, n_e_est)`` at the granted tau; the
    estimate is a pure function of ``(points, budget, n_samples, seed)``,
    so replaying :meth:`PHServeEngine.admission_account` on the logged
    inputs reproduces the decision bit-for-bit.
    """
    uid: int
    tenant: str
    n: int
    requested_tau: float
    granted_tau: float
    n_e_est: int
    predicted_bytes: int
    budget_bytes: Optional[int]
    admitted: bool
    reason: str


@dataclasses.dataclass
class PHResponse:
    uid: int
    tenant: str
    dataset: str
    admitted: bool
    path: str        # rejected|hit|cold|batched|warm_tau|warm_points|degraded
    granted_tau: float
    diagrams: Optional[Dict[int, np.ndarray]]
    admission: AdmissionDecision
    cached: bool = False            # checkpoint retained for future warm starts
    n_landmarks: Optional[int] = None
    cover_radius: Optional[float] = None
    latency_s: float = 0.0
    degraded: bool = False          # served under a brown-out contract
    degraded_reason: str = ""       # deadline|overload|queue_depth|circuit_open|cold_failed


@dataclasses.dataclass
class _CacheEntry:
    fingerprint: str
    n: int
    tau: float
    maxdim: int
    filtration: Filtration
    checkpoint: ReductionCheckpoint
    diagrams: Dict[int, np.ndarray]
    seq: int                        # LRU clock
    landmarks: Optional[np.ndarray] = None
    cover_radius: Optional[float] = None

    def nbytes(self) -> int:
        f = self.filtration
        filt_bytes = int(f.edges.nbytes + f.edge_len.nbytes
                         + f.nbr_vtx.nbytes + f.nbr_vtx_ord.nbytes
                         + f.nbr_edge_ord.nbytes + f.nbr_edge_vtx.nbytes
                         + f.degree.nbytes)
        diag_bytes = int(sum(d.nbytes for d in self.diagrams.values()))
        lm_bytes = int(self.landmarks.nbytes) if self.landmarks is not None \
            else 0
        return self.checkpoint.nbytes() + filt_bytes + diag_bytes + lm_bytes


class PHServeEngine:
    """Admission-controlled, cache-warm PH serving (module docstring).

    ``memory_budget_bytes`` is the *per-reduction* account that admission
    inverts into a tau cap; ``store_budget_bytes`` is the *per-tenant*
    cache residency cap (checkpoints + filtrations + landmarks), enforced
    by LRU whole-dataset eviction.  ``reducer_opts`` go to
    :func:`repro_torch.core.resume.make_reducer` — ``engine`` may be
    ``single``, ``batch`` or ``packed`` (optionally sharded with
    ``n_shards``) — with ``device``, resolved once here (``self.device``).

    Degradation knobs: ``default_deadline_s``
    compares a cold request against the EWMA of observed cold latency and
    serves a clamped result when it cannot meet the deadline;
    ``max_cold_retries`` bounds re-attempts of a failed cold reduction
    (deterministic backoff, ``retry_base_s``); ``breaker_threshold``
    consecutive failures open a per-``(tenant, dataset)`` circuit for
    ``breaker_cooldown_steps`` engine steps; ``shed_queue_depth`` sheds
    drained requests beyond that depth onto the degraded contract
    (``tau * degrade_tau_factor`` when finite, ``maxdim`` clamped to
    ``degrade_maxdim``).  Degraded responses are never cached.
    """

    def __init__(self,
                 memory_budget_bytes: Optional[int] = None,
                 store_budget_bytes: Optional[int] = None,
                 max_batch_clouds: int = 8,
                 landmark_cap: Optional[int] = None,
                 n_admission_samples: int = 4096,
                 seed: int = 0,
                 default_deadline_s: Optional[float] = None,
                 max_cold_retries: int = 2,
                 retry_base_s: float = 1e-3,
                 breaker_threshold: int = 3,
                 breaker_cooldown_steps: int = 2,
                 shed_queue_depth: Optional[int] = None,
                 degrade_tau_factor: float = 0.5,
                 degrade_maxdim: int = 1,
                 device: DeviceLike = None,
                 **reducer_opts):
        reducer_opts.setdefault("engine", "single")
        reducer_opts.setdefault("mode", "implicit")
        self.device = resolve_device(device)
        self.memory_budget_bytes = memory_budget_bytes
        self.store_budget_bytes = store_budget_bytes
        self.max_batch_clouds = int(max_batch_clouds)
        self.landmark_cap = landmark_cap
        self.n_admission_samples = int(n_admission_samples)
        self.seed = int(seed)
        self.reducer_opts = dict(reducer_opts)
        self._reducer = make_reducer(**reducer_opts, device=self.device)
        self.queue: List[PHRequest] = []
        self.done: Dict[int, PHResponse] = {}
        self.admission_log: List[AdmissionDecision] = []
        self._cache: Dict[Tuple[str, str], _CacheEntry] = {}
        self._seq = 0
        self.metrics = MetricsRegistry()
        # -- resilience / degradation state --------------------------------
        self.default_deadline_s = default_deadline_s
        self.max_cold_retries = int(max_cold_retries)
        self.retry_base_s = float(retry_base_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_steps = int(breaker_cooldown_steps)
        self.shed_queue_depth = shed_queue_depth
        self.degrade_tau_factor = float(degrade_tau_factor)
        self.degrade_maxdim = int(degrade_maxdim)
        self._step_idx = 0
        # (tenant, dataset) -> {"failures": consecutive, "open_until": step}
        self._breakers: Dict[Tuple[str, str], Dict[str, int]] = {}
        self._cold_ewma: Optional[float] = None   # observed cold latency/req
        self._pinned: set = set()     # keys served this step: LRU-immune
        self._degraded: Dict[int, str] = {}   # uid -> degrade reason

    # -- admission ------------------------------------------------------
    def admission_account(self, points: np.ndarray, requested_tau: float,
                          uid: int = -1, tenant: str = "default"
                          ) -> AdmissionDecision:
        """The memory account for one request; pure given engine config."""
        n = int(points.shape[0])
        total_pairs = n * (n - 1) // 2
        budget = self.memory_budget_bytes
        if budget is None:
            granted = float(requested_tau)
            n_e_est = self._estimate_edges(points, granted, total_pairs)
            return AdmissionDecision(
                uid=uid, tenant=tenant, n=n, requested_tau=requested_tau,
                granted_tau=granted, n_e_est=n_e_est,
                predicted_bytes=account_bytes(n, n_e_est), budget_bytes=None,
                admitted=True, reason="no budget configured")
        try:
            tau_cap = estimate_tau_max(
                points, budget, n_samples=self.n_admission_samples,
                seed=self.seed)
        except ValueError as e:
            return AdmissionDecision(
                uid=uid, tenant=tenant, n=n, requested_tau=requested_tau,
                granted_tau=0.0, n_e_est=0,
                predicted_bytes=account_bytes(n, 0), budget_bytes=budget,
                admitted=False, reason=str(e))
        granted = float(min(requested_tau, tau_cap))
        n_e_est = self._estimate_edges(points, granted, total_pairs)
        clamped = granted < requested_tau
        return AdmissionDecision(
            uid=uid, tenant=tenant, n=n, requested_tau=requested_tau,
            granted_tau=granted, n_e_est=n_e_est,
            predicted_bytes=account_bytes(n, n_e_est), budget_bytes=budget,
            admitted=True,
            reason=f"tau clamped to budget cap {tau_cap:.6g}" if clamped
            else "within budget")

    def _estimate_edges(self, points: np.ndarray, tau: float,
                        total_pairs: int) -> int:
        if total_pairs == 0:
            return 0
        if not np.isfinite(tau):
            return total_pairs
        lens = sample_pair_lengths(points, n_samples=self.n_admission_samples,
                                   seed=self.seed)
        if lens.size == 0:
            return 0
        return int(round(float(np.mean(lens <= tau)) * total_pairs))

    # -- cache / tenancy ------------------------------------------------
    def tenant_bytes(self) -> Dict[str, int]:
        """Resident cache bytes per tenant (the isolation invariant)."""
        out: Dict[str, int] = {}
        for (tenant, _), e in self._cache.items():
            out[tenant] = out.get(tenant, 0) + e.nbytes()
        return out

    def _touch(self, entry: _CacheEntry) -> None:
        self._seq += 1
        entry.seq = self._seq

    def _store(self, tenant: str, dataset: str, entry: _CacheEntry) -> bool:
        """Insert under the tenant budget; LRU-evict whole datasets.

        Entries already served this step are *pinned* (``self._pinned``) —
        eviction must never reclaim a dataset that was warmed moments ago
        in the same drain (the warm result would be produced and then
        immediately thrown away, and a same-step repeat would go cold).
        When the only candidates are pinned, the *incoming* entry is
        dropped instead, preserving the tenant-byte invariant."""
        self._touch(entry)
        key = (tenant, dataset)
        budget = self.store_budget_bytes
        if budget is not None and entry.nbytes() > budget:
            self._cache.pop(key, None)   # stale state must not linger
            self._set_store_gauge()
            return False
        self._cache[key] = entry
        if budget is not None:
            while True:
                total = sum(e.nbytes() for (t, _), e in self._cache.items()
                            if t == tenant)
                if total <= budget:
                    break
                victims = [(e.seq, k) for k, e in self._cache.items()
                           if k[0] == tenant and k != key
                           and k not in self._pinned]
                if not victims:
                    # over budget with only pinned survivors: sacrifice the
                    # incoming entry rather than a just-served one
                    self._cache.pop(key, None)
                    break
                _, victim = min(victims)
                del self._cache[victim]
                self.metrics.counter("serve_ph_n_evictions").inc()
        self._set_store_gauge()
        return key in self._cache

    def _set_store_gauge(self) -> None:
        self.metrics.gauge("serve_ph_store_bytes").set(
            sum(e.nbytes() for e in self._cache.values()))

    # -- request lifecycle ----------------------------------------------
    def submit(self, req: PHRequest) -> None:
        self.queue.append(req)
        self.metrics.counter("serve_ph_n_requests").inc()

    def _classify(self, req: PHRequest, dataset: str, fp: str,
                  points: np.ndarray, granted_tau: float
                  ) -> Tuple[str, Optional[_CacheEntry]]:
        """hit | warm_tau | warm_points | cold, against the tenant cache."""
        entry = self._cache.get((req.tenant, dataset))
        if entry is None or entry.maxdim != req.maxdim:
            return "cold", None
        if entry.fingerprint == fp:
            if granted_tau == entry.tau:
                return "hit", entry
            if granted_tau > entry.tau:
                return "warm_tau", entry
            return "cold", None      # tau shrink: not an extension
        # prefix growth: cached cloud is a prefix of the new one
        n_old = entry.n
        if points.shape[0] > n_old and granted_tau >= entry.tau \
                and entry.landmarks is None \
                and fingerprint_points(points[:n_old]) == entry.fingerprint:
            return "warm_points", entry
        return "cold", None

    def step(self) -> int:
        """Drain the queue once: admit, serve warm paths, batch the colds.

        Returns the number of requests completed this step.
        """
        self._step_idx += 1
        self._pinned = set()
        if not self.queue:
            self.metrics.gauge("serve_ph_queue_depth").set(0)
            return 0
        overload = False
        inj = active_injector()
        if inj is not None and inj.fire("serve.step", index=self._step_idx,
                                        kinds=("overload",)):
            overload = True
        pending, self.queue = self.queue, []
        self.metrics.gauge("serve_ph_queue_depth").set(len(pending))
        colds: List[Tuple[PHRequest, str, str, np.ndarray, AdmissionDecision,
                          Optional[np.ndarray], Optional[float]]] = []
        n_done = 0
        for i, req in enumerate(pending):
            shed = overload or (self.shed_queue_depth is not None
                                and i >= self.shed_queue_depth)
            if shed:
                self.metrics.counter("serve_ph_n_shed").inc()
                req = self._degrade(req, "overload" if overload
                                    else "queue_depth")
            with stopwatch("serve_ph/request") as sw:
                out = self._serve_or_defer(req, colds)
            if out is not None:
                out.latency_s = sw.elapsed
                self._finish(out)
                n_done += 1
        n_done += self._run_cold_batches(colds)
        self._set_store_gauge()
        return n_done

    def run(self, max_steps: int = 10_000) -> Dict[int, PHResponse]:
        steps = 0
        while self.queue and steps < max_steps:
            self.step()
            steps += 1
        return self.done

    def _finish(self, resp: PHResponse) -> None:
        if resp.degraded:
            self.metrics.counter("serve_ph_n_degraded").inc()
        self.done[resp.uid] = resp
        self.metrics.histogram("serve_ph_latency_s").observe(resp.latency_s)

    # -- degradation -----------------------------------------------------
    def _degrade(self, req: PHRequest, reason: str) -> PHRequest:
        """Clamp a request onto the brown-out contract and record why.

        The recorded reason is surfaced on the eventual response
        (``degraded=True``) no matter which path serves it — degradation
        is explicit, never silent."""
        self._degraded[req.uid] = reason
        tau = float(req.tau_max)
        if np.isfinite(tau):
            tau *= self.degrade_tau_factor
        return dataclasses.replace(
            req, tau_max=tau, maxdim=min(req.maxdim, self.degrade_maxdim))

    def _breaker_failure(self, key: Tuple[str, str]) -> None:
        rec = self._breakers.setdefault(key, {"failures": 0, "open_until": 0})
        rec["failures"] += 1
        if rec["failures"] >= self.breaker_threshold:
            rec["open_until"] = self._step_idx + self.breaker_cooldown_steps
            rec["failures"] = 0

    def _breaker_success(self, key: Tuple[str, str]) -> None:
        rec = self._breakers.get(key)
        if rec is not None:
            rec["failures"] = 0

    def _breaker_open(self, key: Tuple[str, str]) -> bool:
        rec = self._breakers.get(key)
        return rec is not None and self._step_idx <= rec["open_until"]

    def _serve_or_defer(self, req: PHRequest, colds: list
                        ) -> Optional[PHResponse]:
        """Serve a request on the hit/warm path, or defer it to the cold
        batch.  Returns ``None`` exactly when deferred."""
        points = np.asarray(req.points, dtype=np.float64)
        lm_idx: Optional[np.ndarray] = None
        lm_radius: Optional[float] = None
        full_fp = fingerprint_points(points)
        if self.landmark_cap is not None \
                and points.shape[0] > self.landmark_cap:
            cached = self._cache.get(
                (req.tenant, req.dataset or full_fp))
            if cached is not None and cached.fingerprint == full_fp \
                    and cached.landmarks is not None:
                lm_idx, lm_radius = cached.landmarks, cached.cover_radius
            else:
                with span("serve_ph/landmarks", n=int(points.shape[0]),
                          k=int(self.landmark_cap)):
                    lm_idx, lm_radius = maxmin_landmarks(
                        points, self.landmark_cap, seed=self.seed)
            served = points[lm_idx]
        else:
            served = points
        decision = self.admission_account(served, float(req.tau_max),
                                          uid=req.uid, tenant=req.tenant)
        self.admission_log.append(decision)
        if not decision.admitted:
            self.metrics.counter("serve_ph_n_rejected").inc()
            self._degraded.pop(req.uid, None)
            dataset = req.dataset or full_fp
            return PHResponse(
                uid=req.uid, tenant=req.tenant, dataset=dataset,
                admitted=False, path="rejected",
                granted_tau=decision.granted_tau, diagrams=None,
                admission=decision)
        self.metrics.counter("serve_ph_n_admitted").inc()
        dataset = req.dataset or full_fp
        granted = decision.granted_tau
        if self._breaker_open((req.tenant, dataset)):
            # repeated cold failures opened the circuit: fail fast with an
            # explicit degraded response instead of burning another attempt
            self.metrics.counter("serve_ph_n_circuit_open").inc()
            self._degraded.pop(req.uid, None)
            return PHResponse(
                uid=req.uid, tenant=req.tenant, dataset=dataset,
                admitted=True, path="degraded", granted_tau=granted,
                diagrams=None, admission=decision, degraded=True,
                degraded_reason="circuit_open")
        # identity of the *served* cloud: landmarked requests cache under
        # the full cloud's fingerprint so repeats reuse the landmark set
        fp = full_fp
        kind, entry = self._classify(req, dataset, fp, points, granted)
        deadline = req.deadline_s if req.deadline_s is not None \
            else self.default_deadline_s
        if kind == "cold" and deadline is not None \
                and self._cold_ewma is not None \
                and self._cold_ewma > deadline:
            # a cold reduction is predicted to blow the deadline: serve the
            # clamped contract instead (may even turn the request warm)
            self.metrics.counter("serve_ph_n_deadline_degraded").inc()
            req = self._degrade(req, "deadline")
            granted = min(granted, float(req.tau_max))
            decision = dataclasses.replace(decision, granted_tau=granted)
            kind, entry = self._classify(req, dataset, fp, points, granted)
        if kind == "hit":
            self.metrics.counter("serve_ph_n_cache_hits").inc()
            self._touch(entry)
            self._pinned.add((req.tenant, dataset))
            self._breaker_success((req.tenant, dataset))
            reason = self._degraded.pop(req.uid, "")
            return PHResponse(
                uid=req.uid, tenant=req.tenant, dataset=dataset,
                admitted=True, path="hit", granted_tau=granted,
                diagrams=dict(entry.diagrams), admission=decision,
                cached=True, n_landmarks=_lm_n(entry.landmarks),
                cover_radius=entry.cover_radius,
                degraded=bool(reason), degraded_reason=reason)
        if kind == "warm_tau":
            self.metrics.counter("serve_ph_n_cache_hits").inc()
            self.metrics.counter("serve_ph_n_warm_tau").inc()
            with span("serve_ph/warm_tau", uid=req.uid):
                filt = build_filtration(points=served, tau_max=granted)
                diagrams, ckpt = warm_tau_growth(
                    filt, entry.checkpoint, reducer=self._reducer)
            return self._respond(req, dataset, fp, served, granted, filt,
                                 diagrams, ckpt, decision, "warm_tau",
                                 lm_idx, lm_radius)
        if kind == "warm_points":
            self.metrics.counter("serve_ph_n_cache_hits").inc()
            self.metrics.counter("serve_ph_n_warm_points").inc()
            with span("serve_ph/warm_points", uid=req.uid):
                filt = build_filtration(points=served, tau_max=granted)
                diagrams, ckpt = warm_point_arrival(
                    filt, entry.checkpoint, reducer=self._reducer)
            return self._respond(req, dataset, fp, served, granted, filt,
                                 diagrams, ckpt, decision, "warm_points",
                                 lm_idx, lm_radius)
        self.metrics.counter("serve_ph_n_cache_misses").inc()
        colds.append((req, dataset, fp, served, decision, lm_idx, lm_radius))
        return None

    def _respond(self, req, dataset, fp, served, granted, filt, diagrams,
                 ckpt, decision, path, lm_idx, lm_radius) -> PHResponse:
        diagrams = {d: canonical_diagram(v) for d, v in diagrams.items()}
        self._breaker_success((req.tenant, dataset))
        reason = self._degraded.pop(req.uid, "")
        if reason:
            # degraded (clamped) results are served but never cached — a
            # brown-out must not evict full-fidelity datasets or masquerade
            # as one on a later classify
            cached = False
        else:
            # n is the identity-bearing cloud size: the *full* cloud
            # (prefix checks and fingerprints run against it), not the
            # landmark subset
            entry = _CacheEntry(
                fingerprint=fp, n=int(np.asarray(req.points).shape[0]),
                tau=granted, maxdim=req.maxdim, filtration=filt,
                checkpoint=ckpt, diagrams=diagrams, seq=0,
                landmarks=np.asarray(lm_idx) if lm_idx is not None else None,
                cover_radius=lm_radius)
            cached = self._store(req.tenant, dataset, entry)
            if cached:
                self._pinned.add((req.tenant, dataset))
        return PHResponse(
            uid=req.uid, tenant=req.tenant, dataset=dataset, admitted=True,
            path=path, granted_tau=granted, diagrams=dict(diagrams),
            admission=decision, cached=cached, n_landmarks=_lm_n(lm_idx),
            cover_radius=lm_radius, degraded=bool(reason),
            degraded_reason=reason)

    def _run_cold_batches(self, colds: list) -> int:
        """Pack drained cold requests into union reductions, chunked to
        ``max_batch_clouds``; per-cloud results are exact (resume module)."""
        n_done = 0
        by_dim: Dict[int, list] = {}
        for item in colds:
            by_dim.setdefault(item[0].maxdim, []).append(item)
        for maxdim, group in sorted(by_dim.items()):
            for s in range(0, len(group), self.max_batch_clouds):
                chunk = group[s:s + self.max_batch_clouds]
                n_done += self._serve_cold_chunk(chunk, maxdim)
        return n_done

    def _serve_cold_chunk(self, chunk: list, maxdim: int) -> int:
        inj = active_injector()
        batched = len(chunk) > 1

        def attempt(a: int):
            if inj is not None and inj.fire(
                    "serve.step", index=self._step_idx,
                    kinds=("fail_reduce",), attempt=a):
                raise TransientFault("injected cold-reduction failure")
            filts = [build_filtration(points=served,
                                      tau_max=dec.granted_tau)
                     for (_, _, _, served, dec, _, _) in chunk]
            with span("serve_ph/reduce", n_clouds=len(chunk),
                      batched=batched):
                return filts, batched_cold_reduce(filts, maxdim=maxdim,
                                                  reducer=self._reducer)

        def note_retry(a, err, delay_s):
            self.metrics.counter("serve_ph_n_cold_retries").inc()

        with stopwatch("serve_ph/cold_chunk") as sw:
            try:
                filts, results = retry_with_backoff(
                    attempt, attempts=1 + self.max_cold_retries,
                    base_s=self.retry_base_s,
                    seed=self.seed ^ (self._step_idx << 4),
                    sleep=None, on_retry=note_retry)
            except TransientFault:
                results = None
        if results is None:
            # retry budget spent: every request in the chunk gets an
            # explicit degraded response and counts against its circuit
            for (req, dataset, fp, served, dec, lm_idx, lm_radius) in chunk:
                self._breaker_failure((req.tenant, dataset))
                self._degraded.pop(req.uid, None)
                self._finish(PHResponse(
                    uid=req.uid, tenant=req.tenant, dataset=dataset,
                    admitted=True, path="degraded",
                    granted_tau=dec.granted_tau, diagrams=None,
                    admission=dec, degraded=True,
                    degraded_reason="cold_failed",
                    latency_s=sw.elapsed / len(chunk)))
            return len(chunk)
        if batched:
            self.metrics.counter("serve_ph_n_batches").inc()
            self.metrics.counter("serve_ph_n_batched").inc(len(chunk))
            self.metrics.histogram("serve_ph_batch_clouds").observe(
                len(chunk))
        per_req = sw.elapsed / len(chunk)
        # EWMA of cold latency feeds the deadline-degrade predictor
        self._cold_ewma = per_req if self._cold_ewma is None \
            else 0.3 * per_req + 0.7 * self._cold_ewma
        for (req, dataset, fp, served, dec, lm_idx, lm_radius), filt, \
                (diagrams, ckpt) in zip(chunk, filts, results):
            self.metrics.counter("serve_ph_n_cold").inc()
            resp = self._respond(req, dataset, fp, served, dec.granted_tau,
                                 filt, diagrams, ckpt, dec,
                                 "batched" if batched else "cold",
                                 lm_idx, lm_radius)
            resp.latency_s = per_req
            self._finish(resp)
        return len(chunk)

    def stats(self) -> Dict[str, float]:
        """Serving counters through the typed registry (``serve_ph_*``)."""
        return self.metrics.as_stats()


def _lm_n(lm_idx) -> Optional[int]:
    return None if lm_idx is None else int(len(lm_idx))
