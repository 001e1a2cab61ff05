"""Textbook persistent-homology oracle (standard column algorithm).

Port of ``src/repro/core/ref.py``, over the port's
:func:`~repro_torch.core.filtration.pairwise_distances`.  This is the
pure-numpy/python ground truth the port's engines are held against, beside
the JAX package.  It materializes the *entire* VR filtration up to dim-3
simplices and runs the standard column reduction of the boundary matrix
(paper appendix A, algorithm 4) with sparse set-valued columns — exactly the
``O(n^4)`` approach whose memory wall motivates the paper.  Deliberately
simple and slow; only usable for small ``n``.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

from .filtration import pairwise_distances


def vr_simplices(dists: np.ndarray, tau_max: float, maxdim: int):
    """All simplices of dim <= maxdim+1 with diameter <= tau_max.

    Returns a list of (diameter, dim, vertex-tuple), sorted in a valid
    filtration order: (diameter, dim, lexicographic) — faces always precede
    cofaces.
    """
    n = dists.shape[0]
    simplices: List[Tuple[float, int, Tuple[int, ...]]] = []
    for v in range(n):
        simplices.append((0.0, 0, (v,)))
    for dim in range(1, maxdim + 2):
        for comb in itertools.combinations(range(n), dim + 1):
            idx = np.array(comb)
            diam = float(dists[np.ix_(idx, idx)].max())
            if diam <= tau_max:
                simplices.append((diam, dim, comb))
    simplices.sort(key=lambda s: (s[0], s[1], s[2]))
    return simplices


def standard_reduction(dists: np.ndarray, tau_max: float = np.inf, maxdim: int = 2):
    """Standard column algorithm on the boundary matrix; returns diagrams.

    Output: dict ``dim -> float array (k, 2)`` of (birth, death) with
    ``death = inf`` for essential classes.  Zero-persistence pairs
    (birth == death) are dropped, matching persistence-diagram convention.
    """
    simplices = vr_simplices(dists, tau_max, maxdim)
    index_of: Dict[Tuple[int, ...], int] = {
        s[2]: j for j, s in enumerate(simplices)
    }
    diam = [s[0] for s in simplices]
    dim = [s[1] for s in simplices]

    # Sparse GF(2) columns as python sets of row indices.
    columns: List[set] = []
    for _, d, verts in simplices:
        if d == 0:
            columns.append(set())
        else:
            col = set()
            for face in itertools.combinations(verts, d):
                col.add(index_of[face])
            columns.append(col)

    n_cols = len(columns)
    pivot_of_row: Dict[int, int] = {}  # low row -> column index owning it
    lows = [-1] * n_cols
    for j in range(n_cols):
        col = columns[j]
        while col:
            low = max(col)
            owner = pivot_of_row.get(low)
            if owner is None:
                pivot_of_row[low] = j
                lows[j] = low
                break
            col ^= columns[owner]
        columns[j] = col

    pairs: Dict[int, List[Tuple[float, float]]] = {d: [] for d in range(maxdim + 1)}
    paired_rows = set(pivot_of_row.keys())
    for j in range(n_cols):
        if lows[j] >= 0:
            i = lows[j]
            b, d_ = diam[i], diam[j]
            if dim[i] <= maxdim and d_ > b:
                pairs[dim[i]].append((b, d_))
        else:
            # column reduced to zero: birth; essential iff never a pivot row.
            if j not in paired_rows and dim[j] <= maxdim:
                pairs[dim[j]].append((diam[j], np.inf))
    return {
        d: np.array(sorted(pairs[d]), dtype=np.float64).reshape(-1, 2)
        for d in range(maxdim + 1)
    }


def standard_reduction_points(points: np.ndarray, tau_max: float = np.inf,
                              maxdim: int = 2):
    return standard_reduction(pairwise_distances(points), tau_max, maxdim)


def betti_numbers(dists: np.ndarray, tau: float, maxdim: int = 2):
    """Betti numbers of the complex at scale ``tau`` (from the oracle PDs)."""
    pds = standard_reduction(dists, tau_max=np.inf, maxdim=maxdim)
    betti = {}
    for d in range(maxdim + 1):
        pd = pds[d]
        if pd.size == 0:
            betti[d] = 0
            continue
        alive = (pd[:, 0] <= tau) & (pd[:, 1] > tau)
        betti[d] = int(alive.sum())
    return betti
