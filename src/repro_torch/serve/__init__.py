"""Token serving (port of ``src/repro/serve/{steps,engine}.py``).

Exports the names of ``src/repro/serve/__init__.py`` that are ported;
``sample_temperature`` comes with the rest of the LM substrate and the
PH-service names with ``serve/ph.py`` (ROADMAP.md §1 items 10 and 7).
"""
from .steps import (extend_cache, make_decode_step, make_prefill_step,
                    sample_greedy)
from .engine import ServeEngine, Request

__all__ = ["ServeEngine", "Request", "extend_cache", "make_prefill_step",
           "make_decode_step", "sample_greedy"]
