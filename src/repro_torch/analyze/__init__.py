"""Correctness tooling of the port (port of ``src/repro/analyze``), in
three layers:

* :mod:`.lint` — the reference's AST lint rules, reading the port's idiom
  too (torch's host syncs in the hot modules, torch's global RNG, the
  port's tracer package);
* :mod:`.collectives` — the ordered collective schedule of every mesh
  round function of the port, recorded by running it on a port ``Mesh``
  (``launch/mesh.py``'s ``all_gather`` and ``ppermute``), with its axes,
  shard uniformity and the pivot-exchange wire checked;
* :mod:`.invariants` — the opt-in runtime GF(2) sanitizer.

``python -m repro_torch.analyze`` runs the first two over the repo and
exits non-zero on any unjustified finding or violation.
"""
from . import lint
from .invariants import (SanitizeViolation, Sanitizer, active_sanitizer,
                         sanitizing)

__all__ = [
    "SanitizeViolation",
    "Sanitizer",
    "active_sanitizer",
    "sanitizing",
    "lint",
]
