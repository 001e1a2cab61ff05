"""repro_torch.core: the Dory pipeline (port of ``src/repro/core``)."""
from .filtration import (Filtration, build_filtration, filtration_from_arrays,
                         pairwise_distances)
from .homology import PHResult, compute_ph
from .h0 import compute_h0
from .pairing import EMPTY_KEY, pack, unpack
from . import diagrams
from . import ref

__all__ = [
    "Filtration", "build_filtration", "filtration_from_arrays",
    "pairwise_distances", "PHResult", "compute_ph", "compute_h0",
    "EMPTY_KEY", "pack", "unpack", "diagrams", "ref",
]
