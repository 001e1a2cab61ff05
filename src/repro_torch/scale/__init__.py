"""repro_torch.scale: streaming tiled filtration (port of ``src/repro/scale``).

Builds the sparse :class:`~repro_torch.core.filtration.Filtration` without
any ``O(n^2)`` allocation (``tiles``), picks ``tau_max`` for a byte budget
(``budget``) and takes sparse COO distance input (``sparse_input``).
Entry via ``build_filtration_tiled`` / ``build_filtration_coo`` directly,
or ``compute_ph(..., backend="tiled", memory_budget_bytes=...)``.
"""
from .budget import (account_bytes, edge_budget, estimate_tau_max,
                     sample_pair_lengths)
from .sparse_input import (build_filtration_coo, contacts_to_distances,
                           coo_symmetrize)
from .tiles import (TileStats, build_filtration_tiled, harvest_edges,
                    iter_tile_edges, merge_edge_chunks, tile_grid)

__all__ = [
    "TileStats", "build_filtration_tiled", "harvest_edges", "iter_tile_edges",
    "merge_edge_chunks", "tile_grid",
    "account_bytes", "edge_budget", "estimate_tau_max", "sample_pair_lengths",
    "build_filtration_coo", "contacts_to_distances", "coo_symmetrize",
]
