"""Edge-budget estimation + landmark subsampling (paper §5, appendix E).

Port of ``src/repro/scale/budget.py``: host numpy, equal to the reference
bit for bit (the row norms stay ``np.sum``, as in ``scale/tiles.py``).

Dory's memory story is the ``(3n + 12 n_e) * 4``-byte base account: for a
fixed byte budget the only free knob is ``n_e``, i.e. ``tau_max``.  This
module picks ``tau_max`` *before* any build by sampling pairwise distances
from random tile pairs (never the full matrix) and inverting the empirical
distance CDF at the edge count the budget affords.

For workloads where even the budgeted ``n_e`` is too dense, greedy maxmin
(farthest-point) landmark selection gives the standard sparsified-Rips
fallback: ``O(n k)`` time, ``O(n)`` memory, with the cover radius returned so
callers can bound the interleaving error of the subsampled diagram.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.filtration import pair_sq_dists


def account_bytes(n: int, n_e: int) -> int:
    """The paper's predicted base account: ``(3 n + 12 n_e) * 4`` bytes.

    This is the *model* side of the budget story; ``compute_ph`` records it
    as the ``predicted_account_bytes`` gauge next to the observed
    harvest/reduction high-water marks so budget-model drift is a
    measurable quantity.
    """
    return (3 * int(n) + 12 * int(n_e)) * 4


def edge_budget(n: int, memory_budget_bytes: int) -> int:
    """Largest ``n_e`` with ``account_bytes(n, n_e) <= memory_budget_bytes``."""
    return max(0, (int(memory_budget_bytes) // 4 - 3 * n) // 12)


def tile_transient_bytes(tile_m: int, tile_n: int, n_shards: int = 1,
                         backend: str = "numpy", d: int = 8) -> int:
    """Per-device transient of the tiled harvest, outside the paper account.

    The resident tile scratch (f64 lengths + threshold mask + worst-case
    diagonal mask on the numpy path; f32 candidates + masks on the kernel
    path) plus, when sharded over a mesh, the round's stacked f32 gather —
    ``n_shards`` tiles of f32 output and the two stacked ``(tile, d)`` f32
    input blocks land on the host at once (``TileStats.gather_bytes``
    measures the same quantity a posteriori).  ``d`` is the point
    dimension; pass the real one (``estimate_tau_max`` does) or the bound
    under-reserves for wide clouds.
    """
    tile = int(tile_m) * int(tile_n)
    resident = tile * ((8 if backend == "numpy" else 4) + 1 + 1)
    gather = 0
    if n_shards > 1:
        gather = n_shards * (tile * 4 + (tile_m + tile_n) * int(d) * 4)
    return resident + gather


def sharded_edge_budget(n: int, memory_budget_bytes: int, n_shards: int,
                        tile_m: int, tile_n: int,
                        backend: str = "numpy", d: int = 8) -> int:
    """Largest *global* ``n_e`` whose per-device footprint fits the budget.

    ``memory_budget_bytes`` is interpreted **per device**: every device
    duplicates the ``3n`` vertex arrays, holds ``~n_e / n_shards`` of the
    edge arrays, and additionally pays the harvest transient
    (:func:`tile_transient_bytes`, including the round gather).  Inverting
    the per-device account and scaling the edge share back up gives the
    global edge count the fleet affords.
    """
    avail = int(memory_budget_bytes) - tile_transient_bytes(
        tile_m, tile_n, n_shards, backend, d=d)
    if avail <= 0:
        raise ValueError(
            f"memory_budget_bytes={memory_budget_bytes} per device cannot "
            f"even hold the ({tile_m}, {tile_n}) tile transient for "
            f"n_shards={n_shards}")
    return n_shards * edge_budget(n, avail)


def sample_pair_lengths(points: np.ndarray, n_samples: int = 200_000,
                        seed: int = 0) -> np.ndarray:
    """Exact lengths of ``n_samples`` uniform random (i < j) pairs."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    if n < 2:
        return np.zeros(0)
    rng = np.random.default_rng(seed)
    iu = rng.integers(0, n, size=n_samples)
    ju = rng.integers(0, n, size=n_samples)
    neq = iu != ju
    iu, ju = iu[neq], ju[neq]
    lo = np.minimum(iu, ju)
    hi = np.maximum(iu, ju)
    return np.sqrt(pair_sq_dists(points, lo, hi))


def estimate_tau_max(
    points: np.ndarray,
    memory_budget_bytes: int,
    n_samples: int = 200_000,
    seed: int = 0,
    safety: float = 0.9,
    n_shards: int = 1,
    tile_m: Optional[int] = None,
    tile_n: Optional[int] = None,
    backend: str = "numpy",
) -> float:
    """Pick ``tau_max`` so the expected ``n_e`` fits the byte budget.

    The empirical CDF of sampled pair lengths estimates
    ``n_e(tau) ~= q(tau) * n(n-1)/2``; we take the quantile at the budgeted
    edge fraction, shrunk by ``safety`` to absorb sampling error.  Returns
    ``inf`` when the budget covers the full clique.

    With ``n_shards > 1`` (a mesh-sharded build) the budget is interpreted
    **per device**: the ``3n`` vertex arrays are duplicated on every device
    and the per-round gather transient is charged before the edge account is
    inverted (:func:`sharded_edge_budget`) — the serial form assumed one
    resident tile globally, which under-reserved on every device of a mesh.
    ``tile_m``/``tile_n`` size that transient (required when sharded).
    """
    points = np.asarray(points)
    n = int(points.shape[0])
    total_pairs = n * (n - 1) // 2
    if n_shards > 1:
        if tile_m is None or tile_n is None:
            raise ValueError("sharded budgets need tile_m and tile_n to "
                             "account the per-device tile + gather transient")
        max_edges = sharded_edge_budget(n, memory_budget_bytes, n_shards,
                                        tile_m, tile_n, backend=backend,
                                        d=int(points.shape[1]))
    else:
        max_edges = edge_budget(n, memory_budget_bytes)
    if max_edges <= 0:
        raise ValueError(
            f"memory_budget_bytes={memory_budget_bytes} cannot hold even the "
            f"O(n) part of a filtration on n={n} points")
    if total_pairs == 0 or max_edges >= total_pairs:
        return float(np.inf)
    lens = sample_pair_lengths(points, n_samples=n_samples, seed=seed)
    q = min(1.0, safety * max_edges / total_pairs)
    return float(np.quantile(lens, q))


def maxmin_landmarks(
    points: np.ndarray,
    k: int,
    seed: int = 0,
    first: Optional[int] = None,
) -> Tuple[np.ndarray, float]:
    """Greedy farthest-point (maxmin) landmark selection.

    Returns ``(indices, cover_radius)``: up to ``k`` landmark indices into
    ``points`` and the final covering radius ``max_i min_l d(x_i, x_l)`` —
    the Hausdorff distance between cloud and landmarks, which bounds the
    bottleneck error of the sparsified-Rips diagram.  Stops early (fewer
    than ``k`` indices) once the cloud is exactly covered — duplicate points
    never yield duplicate landmarks.  ``O(n k)`` time, ``O(n)`` memory: one
    running min-distance vector, no pairwise matrix.
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    k = min(int(k), n)
    if k <= 0:
        return np.zeros(0, dtype=np.int64), float(np.inf)
    rng = np.random.default_rng(seed)
    idx = np.empty(k, dtype=np.int64)
    idx[0] = int(rng.integers(0, n)) if first is None else int(first)
    sq = np.sum(points * points, axis=1)
    all_ids = np.arange(n, dtype=np.int64)
    mind = np.sqrt(pair_sq_dists(points, np.full(n, idx[0], dtype=np.int64),
                                 all_ids, sq))
    for t in range(1, k):
        if mind.max() == 0.0:
            return idx[:t].copy(), 0.0
        idx[t] = int(np.argmax(mind))
        d = np.sqrt(pair_sq_dists(points, np.full(n, idx[t], dtype=np.int64),
                                  all_ids, sq))
        np.minimum(mind, d, out=mind)
    return idx, float(mind.max())


def landmark_points(points: np.ndarray, k: int, seed: int = 0,
                    first: Optional[int] = None):
    """Convenience: ``(points[idx], idx, cover_radius)`` for maxmin landmarks."""
    idx, radius = maxmin_landmarks(points, k, seed=seed, first=first)
    return np.asarray(points, dtype=np.float64)[idx], idx, radius
