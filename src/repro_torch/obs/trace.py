"""Phase-scoped tracing for the PH pipeline.

Port of ``src/repro/obs/trace.py``.  One span API for the whole package:
nested, thread-safe, and near-free when tracing is off.  A span is an
interval ``[t0, t1)`` on a *lane* — ``None`` for host work, an integer
``k`` for device ``k`` — with arbitrary attributes.

Three entry points:

* :func:`span` — the module-level context manager.  When no tracer is
  active it returns a shared no-op object (no allocation, no clock read).
* :func:`stopwatch` — *always* times (``.elapsed`` after exit) and records
  a span only when tracing is active; every phase timing of the package
  goes through it (the repo's ``raw-timing`` lint rule enforces this).
* :func:`tracing` — activates a tracer for a region and exports Chrome
  ``trace_event`` JSON on exit; ``compute_ph(trace=...)`` and the
  ``REPRO_TRACE`` environment variable both resolve through it.

Naming convention (see ``docs/observability.md``): ``area/what`` — e.g.
``ph/filtration``, ``harvest/tile``, ``reduce/sweep``, ``serve/decode``.

The exported JSON loads directly in https://ui.perfetto.dev (or
``chrome://tracing``): one process, thread 0 is the host track, thread
``k + 1`` is ``device:k``.  Setting ``REPRO_TRACE_TORCH=1`` additionally
wraps every live span in a ``torch.profiler.record_function`` so the same
names show up inside ``torch.profiler`` traces.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union

__all__ = [
    "Span", "Tracer", "active_tracer", "span", "stopwatch", "traced",
    "tracing", "critical_path", "chrome_trace", "coverage",
]

_CLOCK = time.perf_counter        # analyze: allow[raw-timing] the one blessed clock


class Span:
    """A closed, recorded interval: ``name`` on ``lane`` over ``[t0, t1)``."""

    __slots__ = ("name", "lane", "t0", "t1", "attrs")

    def __init__(self, name: str, lane: Optional[int], t0: float, t1: float,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.lane = lane
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, lane={self.lane}, "
                f"dur={self.dur:.6f}, attrs={self.attrs})")


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()
    dur = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NOOP = _NoopSpan()


class _SpanCtx:
    """Live (open) span: context manager handed out by :meth:`Tracer.span`.

    Closing — including on the exception path, since ``__exit__`` always
    runs — records an immutable :class:`Span` on the owning tracer.
    ``.set(**attrs)`` amends attributes mid-flight (e.g. the sweep's
    dependency set, known only once the sweep finishes).
    """

    __slots__ = ("_tracer", "name", "lane", "attrs", "t0", "dur", "_ann")

    def __init__(self, tracer: "Tracer", name: str, lane: Optional[int],
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.lane = lane
        self.attrs = attrs
        self.t0 = 0.0
        self.dur = 0.0
        self._ann = None

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_SpanCtx":
        tr = self._tracer
        tr._open_enter(self)
        if tr.bridge:
            self._ann = _torch_annotation(self.name)
            self._ann.__enter__()
        self.t0 = _CLOCK()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = _CLOCK()
        self.dur = t1 - self.t0
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        tr = self._tracer
        tr._open_exit(self)
        tr.record(Span(self.name, self.lane, self.t0, t1, self.attrs))
        return False


def _torch_annotation(name: str):
    from torch.profiler import record_function
    return record_function(name)


class Tracer:
    """Thread-safe span collector.

    ``forward_to`` dual-writes every recorded span to a second tracer —
    ``packed_reduce`` keeps an always-on local timeline (its simulated wall
    is *derived* from it) and forwards into the user's tracer when one is
    active, so one measurement feeds both accountings.
    ``bridge=True`` wraps live spans in ``torch.profiler.record_function``.
    """

    def __init__(self, forward_to: Optional["Tracer"] = None,
                 bridge: bool = False):
        self.spans: List[Span] = []
        self.bridge = bridge
        self._forward = forward_to
        self._lock = threading.Lock()
        self._open: Dict[int, str] = {}     # id(ctx) -> name, for balance

    # -- recording ---------------------------------------------------------
    def span(self, name: str, lane: Optional[int] = None,
             **attrs: Any) -> _SpanCtx:
        return _SpanCtx(self, name, lane, attrs)

    def record(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)
        if self._forward is not None:
            self._forward.record(sp)

    def _open_enter(self, ctx: _SpanCtx) -> None:
        with self._lock:
            self._open[id(ctx)] = ctx.name

    def _open_exit(self, ctx: _SpanCtx) -> None:
        with self._lock:
            self._open.pop(id(ctx), None)

    # -- invariants / summaries -------------------------------------------
    def open_spans(self) -> List[str]:
        """Names of spans entered but not yet exited (should be [] at export)."""
        with self._lock:
            return list(self._open.values())

    def assert_balanced(self) -> None:
        leaked = self.open_spans()
        if leaked:
            raise RuntimeError(f"unclosed spans at export: {leaked}")

    def coverage(self) -> float:
        return coverage(self.spans)

    # -- export ------------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.spans)

    def export_chrome(self, path: str) -> None:
        """Write Perfetto-loadable Chrome ``trace_event`` JSON to ``path``."""
        self.assert_balanced()
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


def _lane_tid(lane: Optional[int]) -> int:
    # tid 0 = host track; device lane k = tid k + 1 (named "device:k")
    return 0 if lane is None else int(lane) + 1


def chrome_trace(spans: Iterable[Span]) -> Dict[str, Any]:
    """Spans -> Chrome ``trace_event`` dict (``ph: "X"`` complete events).

    Timestamps are microseconds relative to the earliest span, one event
    per span, plus ``M`` metadata events naming the process and each lane's
    thread so Perfetto renders ``host`` / ``device:k`` tracks.
    """
    spans = list(spans)
    base = min((s.t0 for s in spans), default=0.0)
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
        "args": {"name": "repro"},
    }]
    tids = sorted({_lane_tid(s.lane) for s in spans} | {0})
    for tid in tids:
        events.append({
            "ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
            "args": {"name": "host" if tid == 0 else f"device:{tid - 1}"},
        })
        events.append({
            "ph": "M", "pid": 1, "tid": tid, "name": "thread_sort_index",
            "args": {"sort_index": tid},
        })
    for s in spans:
        args = {k: _json_safe(v) for k, v in s.attrs.items()}
        events.append({
            "ph": "X", "pid": 1, "tid": _lane_tid(s.lane),
            "name": s.name,
            "ts": (s.t0 - base) * 1e6,
            "dur": s.dur * 1e6,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:
        return float(v)          # numpy scalars
    except Exception:
        return str(v)


def coverage(spans: Iterable[Span]) -> float:
    """Fraction of the trace extent covered by the union of all spans."""
    ivals = sorted((s.t0, s.t1) for s in spans)
    if not ivals:
        return 0.0
    lo = ivals[0][0]
    hi = max(t1 for _, t1 in ivals)
    if hi <= lo:
        return 1.0
    covered = 0.0
    cur0, cur1 = ivals[0]
    for t0, t1 in ivals[1:]:
        if t0 > cur1:
            covered += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    covered += cur1 - cur0
    return covered / (hi - lo)


# ---------------------------------------------------------------------------
# module-level active tracer + the cheap entry points
# ---------------------------------------------------------------------------

_active: Optional[Tracer] = None
_process_tracer: Optional[Tracer] = None    # the REPRO_TRACE accumulator


def active_tracer() -> Optional[Tracer]:
    """The tracer activated by :func:`tracing`, or ``None`` (tracing off)."""
    return _active


def span(name: str, lane: Optional[int] = None,
         **attrs: Any) -> Union[_SpanCtx, _NoopSpan]:
    """Open a span on the active tracer; a shared no-op when tracing is off.

    The disabled path is one global read and a return of a singleton — no
    clock read, no allocation — so instrumented hot paths stay hot.
    """
    tr = _active
    if tr is None:
        return _NOOP
    return tr.span(name, lane=lane, **attrs)  # analyze: allow[span-leak] returns the context manager to the caller's `with`


class _Stopwatch:
    """Always-on timer that doubles as a span when tracing is active.

    ``.elapsed`` is valid after exit (including the exception path).
    """

    __slots__ = ("name", "lane", "attrs", "t0", "elapsed")

    def __init__(self, name: str, lane: Optional[int], attrs: Dict[str, Any]):
        self.name = name
        self.lane = lane
        self.attrs = attrs
        self.t0 = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "_Stopwatch":
        self.t0 = _CLOCK()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = _CLOCK()
        self.elapsed = t1 - self.t0
        tr = _active
        if tr is not None:
            tr.record(Span(self.name, self.lane, self.t0, t1, self.attrs))
        return False


def stopwatch(name: str, lane: Optional[int] = None,
              **attrs: Any) -> _Stopwatch:
    """``with stopwatch("ph/h1") as sw: ...`` then read ``sw.elapsed``."""
    return _Stopwatch(name, lane, attrs)


def traced(name: Optional[str] = None, lane: Optional[int] = None,
           **attrs: Any) -> Callable:
    """Decorator form of :func:`span` (defaults to the function qualname)."""
    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            with span(label, lane=lane, **attrs):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def tracing(trace: Union[None, bool, str, Tracer] = None) -> Iterator[Optional[Tracer]]:
    """Activate tracing for a region; resolves the user-facing knob.

    * ``None`` — defer to the environment: with ``REPRO_TRACE=out.json``
      set, activate the shared process tracer and (re-)export it to that
      path on exit, accumulating across calls; otherwise keep whatever is
      already active (no-op nesting).
    * ``False`` — do not start tracing (an already-active outer tracer
      keeps collecting).
    * a path ``str`` — fresh tracer for this region, exported to the path
      on exit.
    * a :class:`Tracer` — activate it, no auto-export (tests, benchmarks).

    ``REPRO_TRACE_TORCH=1`` turns on the ``torch.profiler.record_function``
    bridge for tracers this function creates.
    """
    global _active, _process_tracer
    export_path: Optional[str] = None
    bridge = os.environ.get("REPRO_TRACE_TORCH", "") not in ("", "0")
    if trace is None:
        env = os.environ.get("REPRO_TRACE", "")
        if not env or _active is not None:
            yield _active
            return
        if _process_tracer is None:
            _process_tracer = Tracer(bridge=bridge)
        tr: Optional[Tracer] = _process_tracer
        export_path = env
    elif trace is False:
        yield _active
        return
    elif isinstance(trace, Tracer):
        tr = trace
    elif isinstance(trace, str):
        tr = Tracer(bridge=bridge)
        export_path = trace
    else:
        raise TypeError(f"trace must be None, False, a path, or a Tracer; "
                        f"got {trace!r}")
    prev = _active
    _active = tr
    try:
        yield tr
    finally:
        _active = prev
        if export_path is not None and tr is not None:
            tr.export_chrome(export_path)


# ---------------------------------------------------------------------------
# simulated critical path from the reduce/* span timeline
# ---------------------------------------------------------------------------

def critical_path(spans: Iterable[Span]) -> Dict[str, float]:
    """Simulated P-device critical-path wall from ``reduce/*`` spans.

    This is the single source of truth for the packed driver's
    ``sim_wall_s`` (derived from the span timeline, not hand-rolled
    bookkeeping).  Span conventions, all carrying a ``step``
    attribute grouping them into supersteps:

    * ``reduce/fused`` — shared block ops; its ``weights`` attribute is the
      per-lane row share, so lane ``k`` is charged ``dur * weights[k]``.
    * ``reduce/slice`` (``lane=k``) — lane-local serial passes, charged
      fully to lane ``k``; the concurrent phase costs
      ``max_k(fused * weights[k] + slice_k)``.
    * ``reduce/tournament`` — sequential catch-up, full cost.
    * ``reduce/sweep`` (``lane=k``, ``deps=(..)``) — commit sweeps; cost is
      the longest path through the dependency DAG (``deps`` lists the lanes
      whose this-superstep pivots lane ``k`` absorbed; they point strictly
      backward, so one forward pass is the longest-path DP).
    * ``reduce/encode`` (``lane=k``) / ``reduce/exchange`` — an exchange
      round costs the slowest shard's encode plus decode + install.

    For ``P == 1`` the result reproduces the measured reduction wall.
    """
    steps: Dict[int, List[Span]] = {}
    for s in spans:
        if not s.name.startswith("reduce/"):
            continue
        st = s.attrs.get("step")
        if st is None:
            continue
        steps.setdefault(int(st), []).append(s)

    wall = conc = sweep_total = sync = 0.0
    for st in sorted(steps):
        group = steps[st]
        weights: List[float] = [1.0]
        fused = 0.0
        slice_d: Dict[int, float] = {}
        sweep_d: Dict[int, float] = {}
        deps: Dict[int, tuple] = {}
        enc: Dict[int, float] = {}
        tourn = 0.0
        exch = 0.0
        has_exchange = False
        for s in group:
            if s.name == "reduce/fused":
                fused += s.dur
                w = s.attrs.get("weights")
                if w is not None:
                    weights = [float(x) for x in w]
            elif s.name == "reduce/slice":
                k = int(s.lane or 0)
                slice_d[k] = slice_d.get(k, 0.0) + s.dur
            elif s.name == "reduce/tournament":
                tourn += s.dur
            elif s.name == "reduce/sweep":
                k = int(s.lane or 0)
                sweep_d[k] = sweep_d.get(k, 0.0) + s.dur
                deps[k] = tuple(s.attrs.get("deps", ()))
            elif s.name == "reduce/encode":
                k = int(s.lane or 0)
                enc[k] = enc.get(k, 0.0) + s.dur
            elif s.name == "reduce/exchange":
                exch += s.dur
                has_exchange = True

        step_conc = max(
            (fused * weights[k] + slice_d.get(k, 0.0)
             for k in range(len(weights))), default=0.0)
        finish: Dict[int, float] = {}
        for k in sorted(sweep_d):       # deps point strictly backward
            start = max((finish.get(d, 0.0) for d in deps.get(k, ())),
                        default=0.0)
            finish[k] = start + sweep_d[k]
        step_sweep = max(finish.values(), default=0.0)
        step_sync = tourn
        if has_exchange or enc:
            step_sync += max(enc.values(), default=0.0) + exch

        conc += step_conc
        sweep_total += step_sweep
        sync += step_sync
        wall += step_conc + step_sweep + step_sync

    return {
        "sim_wall_s": wall,
        "sim_conc_s": conc,
        "sim_sweep_s": sweep_total,
        "sim_sync_s": sync,
    }
