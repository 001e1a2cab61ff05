"""Resilience (port of ``src/repro/resilience``): deterministic fault
injection and recovery primitives (:mod:`.faults`)."""
from .faults import (
    SITES,
    CheckpointCorruption,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    TransientFault,
    WireCorruption,
    active_injector,
    backoff_delays,
    corrupt_payload,
    flip_bit,
    inject,
    retry_with_backoff,
)

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
