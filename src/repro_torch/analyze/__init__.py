"""Correctness tooling of the port (port of ``src/repro/analyze``, the
runtime half): the opt-in GF(2) sanitizer of :mod:`.invariants`.

The reference's static layers, ``lint`` (ROADMAP.md §1 item 8) and the
jaxpr/HLO collective checks of ``collectives`` (item 11), are not ported.
"""
from .invariants import (SanitizeViolation, Sanitizer, active_sanitizer,
                         sanitizing)

__all__ = [
    "SanitizeViolation",
    "Sanitizer",
    "active_sanitizer",
    "sanitizing",
]
