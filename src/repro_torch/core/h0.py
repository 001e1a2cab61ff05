"""H0 persistence via Kruskal/union-find over the edge filtration.

Port of ``src/repro/core/h0.py`` (host numpy, unchanged semantics).

The paper computes H0 by (serial-parallel) boundary reduction of edges in
ascending order; for a VR filtration this is exactly minimum-spanning-forest
construction: an edge either merges two components (an H0 *death*: pair
``(0, len(e))``) or closes a cycle (an H1 *birth* candidate).  The set of
merge edges is what the clearing step of Algorithm 3 consumes
("if e is in a persistence pair in H0: continue").

Union-find with path compression — O(n_e α(n)) on the host.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from .filtration import Filtration


@dataclasses.dataclass
class H0Result:
    pairs: np.ndarray        # (k, 2) float64: (0, death)
    n_essential: int         # number of components never merged (death = inf)
    death_edges: np.ndarray  # (k,) int64 edge orders that killed a component

    def diagram(self) -> np.ndarray:
        ess = np.full((self.n_essential, 2), [0.0, np.inf])
        return np.concatenate([self.pairs, ess], axis=0)


def compute_h0(filt: Filtration) -> H0Result:
    n = filt.n
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:        # path compression
            parent[x], x = root, parent[x]
        return root

    deaths = []
    death_edges = []
    for o in range(filt.n_e):
        a, b = filt.edges[o]
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
            deaths.append(filt.edge_len[o])
            death_edges.append(o)
    pairs = np.stack([np.zeros(len(deaths)), np.array(deaths, dtype=np.float64)],
                     axis=1) if deaths else np.zeros((0, 2))
    pairs = pairs[pairs[:, 1] > 0.0] if pairs.size else pairs  # drop 0-persistence
    n_essential = n - len(deaths)
    return H0Result(
        pairs=pairs.reshape(-1, 2),
        n_essential=int(n_essential),
        death_edges=np.array(death_edges, dtype=np.int64),
    )
