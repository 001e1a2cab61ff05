"""Serving (port of ``src/repro/serve``): token serving
(:mod:`.steps`, :mod:`.engine`) and PH-as-a-service (:mod:`.ph`).

Exports the names of ``src/repro/serve/__init__.py``, every one ported.
"""
from .steps import (extend_cache, make_decode_step, make_prefill_step,
                    sample_greedy, sample_temperature)
from .engine import ServeEngine, Request
from .ph import (AdmissionDecision, PHRequest, PHResponse, PHServeEngine,
                 fingerprint_points)

__all__ = ["ServeEngine", "Request", "extend_cache", "make_prefill_step",
           "make_decode_step", "sample_greedy", "sample_temperature",
           "AdmissionDecision", "PHRequest", "PHResponse", "PHServeEngine",
           "fingerprint_points"]
