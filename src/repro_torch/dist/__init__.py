"""Distributed transport (port of ``src/repro/dist``): so far the lossless
Elias–Fano codec of the pivot exchange (:mod:`.compression`)."""
from .compression import (ef_decode_sorted, ef_encode_sorted,
                          pack_column_payload, unpack_column_payload)

__all__ = ["ef_encode_sorted", "ef_decode_sorted", "pack_column_payload",
           "unpack_column_payload"]
