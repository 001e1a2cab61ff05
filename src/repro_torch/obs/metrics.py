"""Typed metrics registry + the canonical stats schema.

Port of ``src/repro/obs/metrics.py`` (same schema, same semantics): the
port's ``stats`` producers (``core/reduction.py``, ``core/packed_reduce.py``,
``core/pivot_cache.py``, ``core/homology.py``) build their numbers through
a :class:`MetricsRegistry`, so ``compute_ph(...).stats`` carries exactly
the reference's keys.  The schema is the reference's whole (serving,
resilience and the sanitizer's ``sanitize_checks`` included), so both
packages share one key space.

``registry.as_stats()`` flattens to the same ``Dict[str, float]`` shape the
pipeline has always returned (histograms expand to ``name_count`` /
``name_sum`` / ``name_min`` / ``name_max``), so ``compute_ph(...).stats``
stays backward-compatible: every legacy key survives with the same value.

Three kinds:

* **counter** — monotone event count (``inc``); e.g. ``n_reductions``.
* **gauge** — a level; ``set`` overwrites, ``record_max`` keeps a
  high-water mark (the byte-account gauges use it).
* **histogram** — a distribution summarized as count/sum/min/max
  (``observe``); e.g. per-superstep concurrent-phase wall.

A metric only appears in ``as_stats()`` once touched, which is how
conditional keys (``tau_max_estimated``, the ``sim_*`` walls) stay
conditional.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

__all__ = [
    "MetricSpec", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SCHEMA", "schema_markdown",
]


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str           # "counter" | "gauge" | "histogram"
    unit: str           # "", "bytes", "s", "columns", ...
    help: str


def _spec(name: str, kind: str, unit: str, help: str) -> MetricSpec:
    return MetricSpec(name=name, kind=kind, unit=unit, help=help)


# The one documented schema.  Names are the *legacy* stats keys — the
# migration keeps every existing key, it just types and documents them.
# (Concept names map as: spills -> n_spilled, wire_bytes -> exchange_bytes,
# pack_hits -> cache_n_pack_hits.)
SCHEMA: Dict[str, MetricSpec] = {s.name: s for s in [
    # -- reduction engines (per dimension; compute_ph prefixes h1_/h2_) --
    _spec("n_columns", "counter", "columns", "columns fed to the reduction"),
    _spec("n_reductions", "counter", "ops", "GF(2) column additions"),
    _spec("n_pairs", "counter", "pairs", "finite persistence pairs emitted"),
    _spec("n_essential", "counter", "classes", "essential (infinite) classes"),
    _spec("stored_bytes", "gauge", "bytes", "pivot-store resident bytes"),
    _spec("n_stored_columns", "gauge", "columns", "pivot columns resident"),
    _spec("n_spilled", "counter", "columns",
          "explicit columns spilled to implicit storage (budget pressure)"),
    _spec("batch_size", "gauge", "columns", "effective reduction batch size"),
    # -- packed block engine --
    _spec("n_rounds", "counter", "rounds", "batched probe/XOR rounds"),
    _spec("n_expansions", "counter", "ops", "bit-block capacity expansions"),
    _spec("n_evictions", "counter", "ops", "bit-block segment evictions"),
    _spec("n_consolidations", "counter", "ops", "bit-block consolidations"),
    _spec("peak_block_bytes", "gauge", "bytes",
          "high-water bytes of the packed bit block"),
    _spec("use_kernels", "gauge", "flag", "1 when the GF(2) kernels were used"),
    # -- distributed packed driver --
    _spec("n_shards", "gauge", "devices", "reduction shard count P"),
    _spec("n_supersteps", "counter", "steps", "fused supersteps executed"),
    _spec("n_exchange_rounds", "counter", "rounds", "pivot-exchange rounds"),
    _spec("n_tournament_reductions", "counter", "ops",
          "reductions during tournament catch-up"),
    _spec("n_sweep_probes", "counter", "probes",
          "authoritative-store re-probes during commit sweeps"),
    _spec("exchange_bytes", "counter", "bytes",
          "wire bytes shipped by pivot-exchange payloads (wire_bytes)"),
    _spec("sim_wall_s", "gauge", "s",
          "simulated P-device critical-path reduction wall (span-derived)"),
    _spec("sim_conc_s", "gauge", "s", "concurrent-phase share of sim wall"),
    _spec("sim_sweep_s", "gauge", "s", "commit-sweep DAG share of sim wall"),
    _spec("sim_sync_s", "gauge", "s",
          "tournament + exchange share of sim wall"),
    _spec("sim_wall_bookkeeping_s", "gauge", "s",
          "hand-rolled sim wall kept for cross-checking the span-derived one"),
    _spec("superstep_conc_s", "histogram", "s",
          "per-superstep concurrent-phase wall distribution"),
    # -- shared pivot cache --
    _spec("cache_n_packs", "counter", "ops", "pivot columns bit-packed"),
    _spec("cache_n_pack_hits", "counter", "ops",
          "pack requests served from cache (pack_hits)"),
    _spec("cache_n_materializations", "counter", "ops",
          "implicit columns re-materialized"),
    _spec("cache_n_mat_hits", "counter", "ops",
          "materialization requests served from cache"),
    _spec("cache_n_col_evictions", "counter", "ops",
          "cached columns evicted (cache budget)"),
    _spec("cache_column_bytes", "gauge", "bytes",
          "bytes of packed columns resident in the cache"),
    # -- compute_ph pipeline (per-phase wall + memory account) --
    _spec("t_filtration", "gauge", "s", "filtration build wall"),
    _spec("t_h0", "gauge", "s", "H0 union-find wall"),
    _spec("t_h1", "gauge", "s", "H1* reduction wall"),
    _spec("t_h2", "gauge", "s", "H2* reduction wall"),
    _spec("n", "gauge", "points", "vertex count"),
    _spec("n_e", "gauge", "edges", "edge count at tau_max"),
    _spec("base_memory_bytes", "gauge", "bytes",
          "filtration result arrays: the (3n + 12 n_e) * 4 account realized"),
    _spec("tau_max_estimated", "gauge", "", "budget-derived tau_max"),
    _spec("sanitize_checks", "counter", "checks", "GF(2) sanitizer checks run"),
    _spec("per_device_peak_bytes", "gauge", "bytes",
          "sharded harvest: predicted per-device high-water"),
    _spec("per_device_base_bytes", "gauge", "bytes",
          "sharded harvest: per-device share of the base account"),
    _spec("predicted_account_bytes", "gauge", "bytes",
          "the paper's predicted (3n + 12 n_e) * 4 account (scale/budget)"),
    _spec("observed_peak_harvest_bytes", "gauge", "bytes",
          "observed harvest transient high-water (TileStats)"),
    _spec("observed_peak_reduce_bytes", "gauge", "bytes",
          "observed reduction high-water: store + packed block, max over dims"),
    _spec("budget_drift_ratio", "gauge", "ratio",
          "(base + worst observed transient) / predicted account"),
    # -- serving engine --
    _spec("serve_n_prefills", "counter", "batches", "prefill launches"),
    _spec("serve_n_decode_steps", "counter", "steps", "decode steps run"),
    _spec("serve_n_tokens", "counter", "tokens", "tokens decoded"),
    _spec("serve_n_completed", "counter", "requests", "requests completed"),
    _spec("serve_tokens_per_request", "histogram", "tokens",
          "decoded tokens per completed request"),
    # -- PH serving engine (repro.serve.ph) --
    _spec("serve_ph_n_requests", "counter", "requests",
          "PH requests submitted"),
    _spec("serve_ph_n_admitted", "counter", "requests",
          "requests admitted by the tau_max memory account"),
    _spec("serve_ph_n_rejected", "counter", "requests",
          "requests rejected at admission (budget cannot hold O(n) part)"),
    _spec("serve_ph_n_cache_hits", "counter", "requests",
          "requests served against a cached dataset checkpoint"),
    _spec("serve_ph_n_cache_misses", "counter", "requests",
          "requests with no usable cached state (cold path)"),
    _spec("serve_ph_n_warm_tau", "counter", "requests",
          "warm tau-growth restarts served"),
    _spec("serve_ph_n_warm_points", "counter", "requests",
          "warm point-arrival restarts served"),
    _spec("serve_ph_n_cold", "counter", "requests",
          "cold reductions run (no reusable pivots)"),
    _spec("serve_ph_n_batched", "counter", "requests",
          "cold requests packed into union-batch reductions"),
    _spec("serve_ph_n_batches", "counter", "batches",
          "union-batch reductions launched"),
    _spec("serve_ph_batch_clouds", "histogram", "requests",
          "clouds packed per union-batch reduction"),
    _spec("serve_ph_n_evictions", "counter", "datasets",
          "cached dataset states evicted under a tenant store budget"),
    _spec("serve_ph_store_bytes", "gauge", "bytes",
          "resident bytes of cached checkpoints (all tenants)"),
    _spec("serve_ph_queue_depth", "gauge", "requests",
          "pending requests at the last step boundary"),
    _spec("serve_ph_latency_s", "histogram", "s",
          "per-request service wall (span-derived)"),
    # -- resilience (repro.resilience): fault recovery + degradation --
    _spec("resilience_n_faults", "counter", "faults",
          "injected faults observed by recovery paths"),
    _spec("resilience_n_shard_deaths", "counter", "shards",
          "reduction shards declared dead by heartbeat supervision"),
    _spec("resilience_n_redeals", "counter", "supersteps",
          "supersteps re-dealt to survivors after a shard death"),
    _spec("resilience_n_straggler_sidelines", "counter", "shards",
          "straggling shards sidelined from batch dealing"),
    _spec("resilience_n_exchange_retries", "counter", "attempts",
          "pivot-exchange payload delivery retries"),
    _spec("resilience_n_exchange_deferrals", "counter", "payloads",
          "exchange payloads deferred to a later round after retry budget"),
    _spec("resilience_n_wire_corruptions", "counter", "payloads",
          "exchange payloads rejected by checksum"),
    _spec("resilience_n_tile_retries", "counter", "tiles",
          "harvest tiles recomputed after a transient fault"),
    _spec("resilience_n_ckpt_corruptions", "counter", "checkpoints",
          "checkpoints rejected by integrity checks"),
    _spec("resilience_n_ckpt_fallbacks", "counter", "requests",
          "cold fallbacks taken after checkpoint corruption"),
    _spec("resilience_recover_s", "histogram", "s",
          "time to recover per fault (discarded + re-dealt work)"),
    _spec("resilience_backoff_s", "histogram", "s",
          "scheduled backoff delay per retry"),
    # -- serving degradation (repro.serve.ph) --
    _spec("serve_ph_n_degraded", "counter", "requests",
          "responses served degraded (clamped tau / lower maxdim)"),
    _spec("serve_ph_n_shed", "counter", "requests",
          "requests load-shed under queue/store pressure"),
    _spec("serve_ph_n_deadline_degraded", "counter", "requests",
          "requests degraded to meet a deadline"),
    _spec("serve_ph_n_circuit_open", "counter", "requests",
          "requests short-circuited by an open breaker"),
    _spec("serve_ph_n_cold_retries", "counter", "attempts",
          "cold reduction retries after transient faults"),
]}


class Counter:
    __slots__ = ("spec", "value")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self.value = 0.0

    def inc(self, v: Union[int, float] = 1) -> None:
        self.value += float(v)


class Gauge:
    __slots__ = ("spec", "value")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self.value = 0.0

    def set(self, v: Union[int, float]) -> None:
        self.value = float(v)

    def record_max(self, v: Union[int, float]) -> None:
        """High-water semantics: keep the max ever observed."""
        self.value = max(self.value, float(v))


class Histogram:
    __slots__ = ("spec", "count", "sum", "min", "max")

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: Union[int, float]) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)


_Metric = Union[Counter, Gauge, Histogram]
_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Schema-checked metric store; flattens back to the legacy stats dict.

    Accessors are typed: asking for ``counter("stored_bytes")`` when the
    schema declares a gauge raises, so a producer cannot silently change a
    metric's meaning.  Names outside :data:`SCHEMA` must be registered
    first via :meth:`register` — the schema stays the single source of
    truth for what the pipeline can emit.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._extra_specs: Dict[str, MetricSpec] = {}

    def register(self, name: str, kind: str, unit: str = "",
                 help: str = "") -> MetricSpec:
        """Declare an out-of-schema metric (tests, experiments)."""
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        spec = MetricSpec(name=name, kind=kind, unit=unit, help=help)
        self._extra_specs[name] = spec
        return spec

    def _get(self, name: str, kind: str) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if m.spec.kind != kind:
                raise TypeError(f"metric {name!r} is a {m.spec.kind}, "
                                f"requested as {kind}")
            return m
        spec = SCHEMA.get(name) or self._extra_specs.get(name)
        if spec is None:
            raise KeyError(f"metric {name!r} is not in the schema; "
                           f"register() it or add it to SCHEMA")
        if spec.kind != kind:
            raise TypeError(f"metric {name!r} is declared a {spec.kind}, "
                            f"requested as {kind}")
        m = _KINDS[kind](spec)
        self._metrics[name] = m
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")    # type: ignore[return-value]

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")      # type: ignore[return-value]

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")  # type: ignore[return-value]

    def as_stats(self) -> Dict[str, float]:
        """Flatten to the pipeline's historical ``Dict[str, float]`` shape."""
        out: Dict[str, float] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[f"{name}_count"] = float(m.count)
                out[f"{name}_sum"] = m.sum
                if m.count:
                    out[f"{name}_min"] = m.min
                    out[f"{name}_max"] = m.max
            else:
                out[name] = m.value
        return out

    def update_from(self, stats: Dict[str, float]) -> None:
        """Absorb a legacy stats dict (schema-checked, gauges overwritten).

        Counters *add* and gauges *set*, so a registry can aggregate
        several producers (e.g. the serve engine absorbing per-request
        stats).
        """
        for k, v in stats.items():
            spec = SCHEMA.get(k) or self._extra_specs.get(k)
            if spec is None or spec.kind == "histogram":
                continue
            if spec.kind == "counter":
                self.counter(k).inc(v)
            else:
                self.gauge(k).set(v)


def schema_markdown() -> str:
    """The schema as a markdown table (rendered in docs/observability.md)."""
    lines = ["| name | kind | unit | meaning |", "|---|---|---|---|"]
    for name in sorted(SCHEMA):
        s = SCHEMA[name]
        lines.append(f"| `{name}` | {s.kind} | {s.unit or '-'} | {s.help} |")
    return "\n".join(lines)
