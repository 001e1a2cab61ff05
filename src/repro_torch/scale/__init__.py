"""repro_torch.scale: streaming tiled filtration (port of ``src/repro/scale``).

Builds the sparse :class:`~repro_torch.core.filtration.Filtration` without
any ``O(n^2)`` allocation: tiled distance harvesting (``tiles``),
multi-device tile sharding over the ``data`` mesh axis (``shard``),
byte-budget ``tau_max`` estimation + maxmin landmarks (``budget``) and
sparse COO distance input (``sparse_input``).  Entry via
``build_filtration_tiled`` / ``build_filtration_sharded`` /
``build_filtration_coo`` directly, or ``compute_ph(..., backend="tiled",
memory_budget_bytes=..., mesh=...)``.
"""
from .budget import (account_bytes, edge_budget, estimate_tau_max,
                     landmark_points,
                     maxmin_landmarks, sample_pair_lengths,
                     sharded_edge_budget, tile_transient_bytes)
from .shard import (build_filtration_sharded, harvest_edges_sharded,
                    partition_tiles, shard_of_mesh)
from .sparse_input import (build_filtration_coo, contacts_to_distances,
                           coo_symmetrize)
from .tiles import (TileStats, build_filtration_tiled, harvest_edges,
                    iter_tile_edges, merge_edge_chunks, tile_grid)

__all__ = [
    "TileStats", "build_filtration_tiled", "harvest_edges", "iter_tile_edges",
    "merge_edge_chunks", "tile_grid",
    "build_filtration_sharded", "harvest_edges_sharded", "partition_tiles",
    "shard_of_mesh",
    "account_bytes", "edge_budget", "estimate_tau_max", "maxmin_landmarks",
    "landmark_points",
    "sample_pair_lengths", "sharded_edge_budget", "tile_transient_bytes",
    "build_filtration_coo", "contacts_to_distances", "coo_symmetrize",
]
