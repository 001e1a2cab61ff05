"""Fault types of the PH pipeline (port of ``src/repro/resilience/faults.py``).

Only :class:`WireCorruption` is here: the commit-delta codec
(:mod:`repro_torch.core.pivot_cache`) raises it on a payload that fails its
checksum.  The seeded injector (``FaultPlan``, ``FaultInjector``,
``inject``), the retry schedule and the other fault types come with the
service layer (ROADMAP.md §1 item 7), together with the injection sites of
the distributed reduction that they arm.
"""
from __future__ import annotations

__all__ = ["WireCorruption"]


class WireCorruption(ValueError):
    """A pivot-exchange payload failed checksum/shape validation.

    Subclasses ``ValueError`` so callers that guard decode with ``except
    ValueError`` keep working."""
