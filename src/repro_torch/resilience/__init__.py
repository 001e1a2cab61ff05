"""Resilience (port of ``src/repro/resilience``): so far only the wire
error the pivot-exchange codec raises (:mod:`.faults`)."""
from .faults import WireCorruption

__all__ = ["WireCorruption"]
