"""Distributed transport (port of ``src/repro/dist``): the lossless
Elias–Fano codec of the pivot exchange (:mod:`.compression`), the mesh
axis the PH paths shard over and the tree-path helper the checkpointer
names its leaves with (:mod:`.sharding`).

Of ``src/repro/dist/__init__.py``'s names it exports the ported one,
``tree_path_str``; the parameter and activation rules and the int8
gradient exchange wait for the sharded trainer (ROADMAP.md §1, item 10)."""
from .compression import (ef_decode_sorted, ef_encode_sorted,
                          pack_column_payload, unpack_column_payload)
from .sharding import data_axis, tree_path_str

__all__ = ["ef_encode_sorted", "ef_decode_sorted", "pack_column_payload",
           "unpack_column_payload", "data_axis", "tree_path_str"]
