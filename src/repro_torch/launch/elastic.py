"""Fault tolerance primitives (port of ``src/repro/launch/elastic.py``,
whole): heartbeat supervision, shard supervision for the distributed
reduction, speculative straggler reassignment.

:mod:`repro_torch.core.packed_reduce` wires :class:`ShardSupervisor` into
its superstep loop, as the reference's driver does: every live shard beats
once per superstep on a *deterministic superstep-indexed clock*, dead
shards are detected by beat timeout and their remaining batch queue is
re-dealt to survivors from the last exact commit sweep, and stragglers are
sidelined for a cooldown so the fused superstep stops synchronizing on the
slowest shard.

Stdlib + numpy, as in the reference: no torch, no side effects.
"""
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Heartbeat:
    """Supervisor-side liveness table (host_id -> last beat time).

    ``beat``/``dead``/``stragglers`` accept explicit timestamps so callers
    with a deterministic clock (e.g. the reduction superstep counter) get
    reproducible failure detection; wall-clock is only a default."""
    timeout_s: float = 5.0
    beats: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, t: Optional[float] = None):
        self.beats[host] = time.monotonic() if t is None else t

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.beats.items() if now - t > self.timeout_s]

    def stragglers(self, factor: float = 3.0,
                   now: Optional[float] = None) -> List[int]:
        """Hosts whose last beat lags the median by ``factor``x the median
        inter-beat gap (cheap, coordination-free detection)."""
        now = time.monotonic() if now is None else now
        if len(self.beats) < 2:
            return []
        lags = {h: now - t for h, t in self.beats.items()}
        med = float(np.median(list(lags.values())))
        return [h for h, lag in lags.items()
                if lag > factor * max(med, 1e-3) and lag > med]


def speculative_reassign(assignment: Dict[int, List[int]],
                         stragglers: Sequence[int]) -> Dict[int, int]:
    """Speculative-execution policy: each straggler's pending work items
    are duplicated onto the least-loaded non-straggling survivor (first
    finisher wins).  Mutates ``assignment`` in place and returns the
    ``straggler -> backup`` map.  Deterministic given its inputs."""
    backups: Dict[int, int] = {}
    lagging = set(stragglers)
    for s in sorted(lagging):
        load = {h: len(v) for h, v in assignment.items() if h not in lagging}
        if not load:
            break
        backup = min(load, key=lambda h: (load[h], h))
        backups[s] = backup
        assignment[backup] = assignment[backup] + assignment.get(s, [])
    return backups


@dataclasses.dataclass
class RecoveryPlan:
    """What the supervisor decided for one superstep: which shards died
    since the last check, which are straggling, and the ``active`` set the
    driver should deal batches to this superstep."""
    dead: List[int]
    stragglers: List[int]
    active: List[int]


class ShardSupervisor:
    """Heartbeat-driven shard supervision on a deterministic clock.

    The reduction driver owns the clock (its superstep counter) and calls
    :meth:`observe` once per superstep with each live shard's beat time;
    shards that miss ``timeout`` clock units are declared dead and removed
    from ``live`` permanently, stragglers (beat lag > ``factor`` x median)
    are sidelined from dealing for ``sideline`` supersteps but stay live.
    With every shard beating on time this is a no-op returning
    ``active == live``."""

    def __init__(self, n_shards: int, timeout: float = 1.5,
                 factor: float = 3.0, sideline: int = 1) -> None:
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.hb = Heartbeat(timeout_s=timeout)
        self.live: List[int] = list(range(n_shards))
        self.factor = factor
        self.sideline = sideline
        self._sidelined_until: Dict[int, float] = {}
        for k in self.live:
            self.hb.beat(k, t=0.0)

    def observe(self, now: float,
                beats: Optional[Dict[int, float]] = None) -> RecoveryPlan:
        """Record this superstep's beats (``shard -> beat time``; a live
        shard absent from ``beats`` did not beat) and return the plan."""
        for k, t in (beats or {}).items():
            if k in self.live:
                self.hb.beat(k, t=t)
        newly_dead = sorted(k for k in self.hb.dead(now=now)
                            if k in self.live)
        for k in newly_dead:
            self.live.remove(k)
            self.hb.beats.pop(k, None)
            self._sidelined_until.pop(k, None)
        lagging = sorted(k for k in self.hb.stragglers(factor=self.factor,
                                                       now=now)
                         if k in self.live)
        for k in lagging:
            self._sidelined_until[k] = now + self.sideline
        active = [k for k in self.live
                  if self._sidelined_until.get(k, -np.inf) <= now
                  or len(self.live) == 1]
        if not active:                    # never stall: someone must deal
            active = list(self.live)
        return RecoveryPlan(dead=newly_dead, stragglers=lagging,
                            active=active)

    def kill(self, shard: int) -> None:
        """Remove a shard immediately (used once death is confirmed by a
        path faster than beat timeout, e.g. a transport-level error)."""
        if shard in self.live:
            self.live.remove(shard)
            self.hb.beats.pop(shard, None)
            self._sidelined_until.pop(shard, None)
