"""Distributed transport (port of ``src/repro/dist``): the lossless
Elias–Fano codec of the pivot exchange (:mod:`.compression`) and the mesh
axis the PH paths shard over (:mod:`.sharding`)."""
from .compression import (ef_decode_sorted, ef_encode_sorted,
                          pack_column_payload, unpack_column_payload)
from .sharding import data_axis

__all__ = ["ef_encode_sorted", "ef_decode_sorted", "pack_column_payload",
           "unpack_column_payload", "data_axis"]
