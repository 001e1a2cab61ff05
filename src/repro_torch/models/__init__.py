"""The LM substrate's dense decoder (port of ``src/repro/models``):
config dataclasses, layers, attention with the flash-kernel prefill route,
and the ``Transformer`` module with its forward and decode step."""
