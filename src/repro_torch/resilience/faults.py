"""Deterministic fault injection for the PH pipeline (port of
``src/repro/resilience/faults.py``; numpy only, as there).

Long-running reductions and services meet lost work, corrupt payloads and
bit-rotted checkpoints as routine events.  This module gives the recovery
paths a *seeded, fully deterministic* adversary, so that exactness under
failure ("diagrams bit-identical to the fault-free run") is a tested
property rather than a hope.

The model is a :class:`FaultPlan` — an ordered list of :class:`FaultSpec`
records, each naming an *injection point* (a ``site``), a fault ``kind``,
and a deterministic trigger (occurrence index at that site, optionally a
shard id).  A :class:`FaultInjector` is armed over a region of code with
the :func:`inject` context manager; instrumented sites call
:func:`active_injector` and, when an injector is live, ``fire(site, ...)``
with their local context.  With no injector armed the cost is one ``None``
check per site.

Injection points (the reference's five; :data:`SITES`):

===================  =========================================================
site                 instrumented where / supported kinds
===================  =========================================================
``harvest.tile``     the tile harvest — ``fail_tile`` (transient, retried)
``reduce.superstep`` the distributed packed reduction's superstep loop —
                     ``kill_shard`` (``when="start"|"mid"``), ``slow_shard``
``exchange.wire``    the pivot-exchange transport — ``drop``, ``corrupt``,
                     ``delay`` (per payload delivery attempt)
``resume.load``      ``ReductionCheckpoint.load`` — ``bitflip``, ``truncate``
``serve.step``       ``serve/ph.py`` engine step — ``fail_reduce``,
                     ``overload``
===================  =========================================================

The port instruments all five sites where the reference does: the tile
loop of :func:`repro_torch.scale.tiles.iter_tile_edges`, the distributed
packed reduction's superstep loop and exchange rounds
(:mod:`repro_torch.core.packed_reduce`), ``core/resume.py``'s load and
``serve/ph.py``'s step loop.

Every random choice (which bit to flip, jitter in a backoff schedule)
derives from ``np.random.default_rng(seed)``, so an identical plan replays
an identical failure history; :meth:`FaultPlan.random` fuzzes plans that
are themselves reproducible from their seed.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "SITES",
    "CheckpointCorruption",
    "FaultInjector",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "TransientFault",
    "WireCorruption",
    "active_injector",
    "backoff_delays",
    "corrupt_payload",
    "flip_bit",
    "inject",
    "retry_with_backoff",
]

SITES: Tuple[str, ...] = (
    "harvest.tile",
    "reduce.superstep",
    "exchange.wire",
    "resume.load",
    "serve.step",
)

# kinds legal per site (validated at FaultSpec construction so a typo'd
# plan fails loudly instead of silently never firing)
_KINDS: Dict[str, Tuple[str, ...]] = {
    "harvest.tile": ("fail_tile",),
    "reduce.superstep": ("kill_shard", "slow_shard"),
    "exchange.wire": ("drop", "corrupt", "delay"),
    "resume.load": ("bitflip", "truncate"),
    "serve.step": ("fail_reduce", "overload"),
}


class InjectedFault(RuntimeError):
    """Base class for errors raised by an armed :class:`FaultInjector`."""


class TransientFault(InjectedFault):
    """A retryable failure (lost tile computation, flaky cold reduction).

    Recovery paths catch exactly this (never bare ``except``) and retry
    under :func:`retry_with_backoff`; anything else propagates."""


class WireCorruption(ValueError):
    """A pivot-exchange payload failed checksum/shape validation.

    Subclasses ``ValueError`` so callers that guard decode with ``except
    ValueError`` keep working."""


class CheckpointCorruption(ValueError):
    """A checkpoint failed its integrity check (hash, version, truncation).

    Raised by ``ReductionCheckpoint.load`` — callers fall back to a cold
    reduction, never to silently wrong state."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fire ``kind`` at ``site`` when the site's
    occurrence counter hits ``at`` (and the shard matches, if given).

    ``times`` consecutive matching occurrences are affected — e.g. a
    ``drop`` with ``times=2`` kills the first two delivery attempts of a
    payload and lets the third through, exercising bounded retry.
    ``params`` carries kind-specific knobs (``when`` for ``kill_shard``,
    ``lag``/``duration`` for ``slow_shard``, ``bit`` for ``corrupt`` /
    ``bitflip``) as a hashable tuple of pairs."""

    site: str
    kind: str
    at: Optional[int] = None
    shard: Optional[int] = None
    times: int = 1
    params: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown injection site {self.site!r}; "
                             f"sites: {SITES}")
        if self.kind not in _KINDS[self.site]:
            raise ValueError(f"kind {self.kind!r} not legal at {self.site!r}; "
                             f"legal: {_KINDS[self.site]}")
        if self.times < 1:
            raise ValueError("times must be >= 1")

    def param(self, key: str, default: Any = None) -> Any:
        return dict(self.params).get(key, default)

    def matches(self, site: str, index: Optional[int],
                shard: Optional[int]) -> bool:
        if site != self.site:
            return False
        if self.at is not None and index != self.at:
            return False
        if self.shard is not None and shard != self.shard:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, ordered fault schedule.  Frozen + hashable so two plans
    built from the same seed compare equal."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    @classmethod
    def of(cls, *specs: FaultSpec, seed: int = 0) -> "FaultPlan":
        return cls(specs=tuple(specs), seed=seed)

    @classmethod
    def random(cls, seed: int, n_faults: int = 4,
               sites: Sequence[str] = SITES,
               max_index: int = 8, max_shard: int = 4) -> "FaultPlan":
        """A reproducible random plan: same ``seed`` -> identical specs."""
        rng = np.random.default_rng(seed)
        specs = []
        sites = tuple(sites)
        for _ in range(int(n_faults)):
            site = sites[int(rng.integers(len(sites)))]
            kinds = _KINDS[site]
            kind = kinds[int(rng.integers(len(kinds)))]
            params: Tuple[Tuple[str, Any], ...] = ()
            if kind == "kill_shard":
                params = (("when", ("start", "mid")[int(rng.integers(2))]),)
            elif kind == "slow_shard":
                params = (("lag", float(rng.integers(1, 4))),
                          ("duration", int(rng.integers(1, 3))))
            elif kind in ("corrupt", "bitflip"):
                params = (("bit", int(rng.integers(0, 256))),)
            elif kind == "delay":
                params = (("delay_s", float(rng.uniform(1e-4, 1e-2))),)
            shard = (int(rng.integers(max_shard))
                     if site in ("reduce.superstep", "exchange.wire") else None)
            specs.append(FaultSpec(
                site=site, kind=kind, at=int(rng.integers(1, max_index + 1)),
                shard=shard, times=int(rng.integers(1, 3)), params=params))
        return cls(specs=tuple(specs), seed=seed)


class FaultInjector:
    """Replays a :class:`FaultPlan` against instrumented sites.

    Each call to :meth:`fire` advances nothing by itself — the *caller*
    supplies the occurrence index (engine step, load ordinal), so firing is
    a pure function of pipeline progress and the plan, never of wall-clock
    time.  Per-spec remaining ``times`` budgets and a structured ``fired``
    log are the only state."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._remaining: List[int] = [s.times for s in plan.specs]
        self.fired: List[Dict[str, Any]] = []
        self.rng = np.random.default_rng(plan.seed)

    def fire(self, site: str, index: Optional[int] = None,
             shard: Optional[int] = None,
             kinds: Optional[Tuple[str, ...]] = None,
             **ctx: Any) -> List[FaultSpec]:
        """Return the specs triggering at this site occurrence (may be
        empty), consuming one unit of each spec's ``times`` budget.

        ``kinds`` restricts which fault kinds this call site can consume —
        two instrumented sites sharing one injection point (the serve step
        loop handles ``overload``, its cold-reduction attempt handles
        ``fail_reduce``) each fire with their own filter so neither burns
        the other's budget."""
        hits: List[FaultSpec] = []
        for i, spec in enumerate(self.plan.specs):
            if kinds is not None and spec.kind not in kinds:
                continue
            if self._remaining[i] > 0 and spec.matches(site, index, shard):
                self._remaining[i] -= 1
                hits.append(spec)
                self.fired.append({"site": site, "kind": spec.kind,
                                   "index": index, "shard": shard, **ctx})
        return hits

    def n_fired(self, site: Optional[str] = None,
                kind: Optional[str] = None) -> int:
        return sum(1 for f in self.fired
                   if (site is None or f["site"] == site)
                   and (kind is None or f["kind"] == kind))

    def exhausted(self) -> bool:
        """True once every spec has spent its full ``times`` budget."""
        return all(r == 0 for r in self._remaining)


_ACTIVE: Optional[FaultInjector] = None


def active_injector() -> Optional[FaultInjector]:
    """The injector armed by the innermost :func:`inject`, or ``None``."""
    return _ACTIVE


@contextmanager
def inject(plan: Optional[FaultPlan]) -> Iterator[Optional[FaultInjector]]:
    """Arm a fault plan for the duration of the block::

        with inject(FaultPlan.of(FaultSpec("serve.step", "overload",
                                           at=1))) as inj:
            engine.step()

    ``inject(None)`` is a no-op (yields ``None``) so callers can thread an
    optional plan without branching."""
    global _ACTIVE
    if plan is None:
        yield None
        return
    previous = _ACTIVE
    _ACTIVE = FaultInjector(plan)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = previous


# ---------------------------------------------------------------------------
# deterministic backoff + retry
# ---------------------------------------------------------------------------

def backoff_delays(attempts: int, base_s: float = 1e-3, factor: float = 2.0,
                   jitter: float = 0.5, seed: int = 0) -> np.ndarray:
    """Exponential backoff schedule with deterministic jitter.

    ``delay[a] = base_s * factor**a * (1 + jitter * u_a)`` with ``u_a``
    drawn from ``default_rng(seed)`` — two calls with the same arguments
    return bit-identical schedules, so a retried recovery replays exactly."""
    if attempts <= 0:
        return np.zeros(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    u = rng.random(attempts)
    return base_s * factor ** np.arange(attempts) * (1.0 + jitter * u)


def retry_with_backoff(fn: Callable[[int], Any], attempts: int = 3,
                       base_s: float = 1e-3, factor: float = 2.0,
                       jitter: float = 0.5, seed: int = 0,
                       retry_on: Tuple[type, ...] = (TransientFault,),
                       sleep: Optional[Callable[[float], None]] = time.sleep,
                       on_retry: Optional[Callable[[int, BaseException, float],
                                                   None]] = None) -> Any:
    """Call ``fn(attempt)`` up to ``attempts`` times, sleeping the
    deterministic :func:`backoff_delays` schedule between failures.

    Only exceptions in ``retry_on`` are retried; the last one re-raises
    once the budget is spent.  ``sleep=None`` accounts the schedule
    without blocking; ``on_retry`` observes ``(attempt, error,
    scheduled_delay_s)`` for metrics."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    delays = backoff_delays(attempts - 1, base_s=base_s, factor=factor,
                            jitter=jitter, seed=seed)
    for a in range(attempts):
        try:
            return fn(a)
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            if a == attempts - 1:
                raise
            delay = float(delays[a])
            if on_retry is not None:
                on_retry(a, e, delay)
            if sleep is not None and delay > 0.0:
                sleep(delay)
    raise AssertionError("unreachable")


# ---------------------------------------------------------------------------
# deterministic corruption helpers
# ---------------------------------------------------------------------------

def flip_bit(buf: bytes, bit: int) -> bytes:
    """Return ``buf`` with one bit flipped (``bit`` taken mod the length)."""
    if len(buf) == 0:
        return buf
    bit = int(bit) % (len(buf) * 8)
    out = bytearray(buf)
    out[bit // 8] ^= 1 << (bit % 8)
    return bytes(out)


def corrupt_payload(payload: np.ndarray, bit: int) -> np.ndarray:
    """Bit-flip a wire payload (uint32 words) deterministically."""
    raw = flip_bit(np.ascontiguousarray(payload, dtype=np.uint32).tobytes(),
                   bit)
    return np.frombuffer(raw, dtype=np.uint32).copy()
