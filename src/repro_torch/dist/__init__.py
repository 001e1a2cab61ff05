"""Distributed execution layer (port of ``src/repro/dist``): the sharding
rules and the compressed transports.

:mod:`.sharding` maps *logical* tensor axes (batch, heads, kv_seq, mlp,
vocab, expert, ...) and *parameter roles* (column/row-parallel
projections, MoE expert stacks, vocab tables) onto the physical mesh axes
(``pod``, ``data``, ``model``), lays whole tensors out as per-entry blocks
of the port's mesh, and names checkpoint leaves; :mod:`.compression`
holds the int8 error-feedback gradient exchange and the lossless
Elias–Fano codec of the pivot exchange.

It exports every name of ``src/repro/dist/__init__.py``'s ``__all__`` but
``tile_specs``, whose one choice the PH paths read as :func:`data_axis`;
beside them its own: the Elias–Fano codec and the data axis.
"""
from .compression import (compressed_psum_grads, dequantize_int8,
                          ef_compress, ef_decode_sorted, ef_encode_sorted,
                          pack_column_payload, unpack_column_payload)
from .sharding import (activation_rules, batch_specs, bind_activation_rules,
                       bound_axis, bound_mesh, bound_rules, cache_specs,
                       constrain, data_axis, shard_params,
                       shardings_from_specs, spec_for_param, tree_path_str)

__all__ = [
    "activation_rules", "batch_specs", "bind_activation_rules", "bound_axis",
    "bound_mesh", "bound_rules", "cache_specs", "compressed_psum_grads",
    "constrain", "dequantize_int8", "ef_compress", "shard_params",
    "shardings_from_specs", "spec_for_param", "tree_path_str",
    "ef_encode_sorted", "ef_decode_sorted", "pack_column_payload",
    "unpack_column_payload", "data_axis",
]
