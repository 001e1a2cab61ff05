"""Point-cloud generators (port of ``src/repro/data``)."""
