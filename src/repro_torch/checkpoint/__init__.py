"""Fault-tolerant checkpointing (port of ``src/repro/checkpoint``)."""
from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
