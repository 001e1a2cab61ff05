"""Sparse (COO triplet) distance input — Hi-C contact graphs, no dense matrix.

Port of ``src/repro/scale/sparse_input.py``: host numpy, as in the
reference, over the port's :func:`~repro_torch.core.filtration
.filtration_from_edges`; the same bad inputs raise the same exceptions.

The paper's §6 genome workload starts from a Hi-C contact map: a sparse
symmetric matrix of contact counts over genomic loci.  This module feeds such
data straight into the pipeline as ``(row, col, value)`` triplets — entries
absent from the COO set are treated as infinitely far (no edge), exactly like
a dense matrix whose missing entries exceed ``tau_max``, so
``build_filtration_coo`` is bit-identical to a dense ``dists=`` call on the
materialized matrix (asserted in tests) while never allocating ``O(n^2)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.filtration import Filtration, filtration_from_edges


def coo_symmetrize(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n: Optional[int] = None,
) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Canonicalize COO triplets to unique upper-triangular ``(i < j)`` form.

    Diagonal entries are dropped; (a, b) and (b, a) collapse to
    ``(min, max)``; duplicate entries for the same pair resolve to the
    *minimum* value (for distance data the shortest measurement wins, and the
    rule is symmetric-input invariant).  Returns ``(n, iu, ju, vals)``.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError("rows/cols/vals must have identical shapes")
    if rows.size and (rows.min() < 0 or cols.min() < 0):
        raise ValueError("negative vertex ids in COO input")
    inferred = int(max(rows.max(), cols.max())) + 1 if rows.size else 0
    n = inferred if n is None else int(n)
    if inferred > n:
        raise ValueError(f"COO ids need n >= {inferred}, got n={n}")

    iu = np.minimum(rows, cols)
    ju = np.maximum(rows, cols)
    off = iu != ju
    iu, ju, vals = iu[off], ju[off], vals[off]
    # group duplicates: sort by (pair, value) so the first of each run is the min
    pair = iu * np.int64(n) + ju
    srt = np.lexsort((vals, pair))
    pair, iu, ju, vals = pair[srt], iu[srt], ju[srt], vals[srt]
    first = np.ones(pair.size, dtype=bool)
    np.not_equal(pair[1:], pair[:-1], out=first[1:])
    return n, iu[first], ju[first], vals[first]


def build_filtration_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n: Optional[int] = None,
    tau_max: float = np.inf,
    with_dense_order: bool = False,
) -> Filtration:
    """Sparse-input :class:`Filtration`: COO distances in, Dory structure out.

    Memory is ``O(nnz + n)`` throughout; the dense order matrix stays lazy
    (``with_dense_order=False``) so the sparse Dory path runs order-free.
    Non-finite values (the ``contacts_to_distances`` "no information" inf)
    never become edges, even at ``tau_max=inf``.
    """
    n, iu, ju, vals = coo_symmetrize(rows, cols, vals, n=n)
    keep = (vals <= tau_max) & np.isfinite(vals)
    return filtration_from_edges(n, iu[keep], ju[keep], vals[keep], tau_max,
                                 with_dense_order=with_dense_order)


def contacts_to_distances(
    counts: np.ndarray,
    alpha: float = -1.0,
    scale: float = 1.0,
) -> np.ndarray:
    """Hi-C contact counts -> distances via the power law ``d = s * c^alpha``.

    The standard polymer-physics conversion (Lieberman-Aiden et al.):
    frequently contacting loci are spatially close.  Zero / negative counts
    map to ``inf`` (no information, no edge).
    """
    counts = np.asarray(counts, dtype=np.float64)
    out = np.full(counts.shape, np.inf)
    pos = counts > 0
    out[pos] = scale * np.power(counts[pos], alpha)
    return out
