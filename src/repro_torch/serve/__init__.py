"""Token serving (port of ``src/repro/serve/{steps,engine}.py``)."""
