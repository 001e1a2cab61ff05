"""Command-line drivers (port of ``src/repro/launch``)."""
