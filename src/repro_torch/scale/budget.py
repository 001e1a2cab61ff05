"""Edge-budget estimation (paper §5, appendix E).

Port of ``src/repro/scale/budget.py``: ``account_bytes``, ``edge_budget``,
``sample_pair_lengths`` and the one-device ``estimate_tau_max`` (host
numpy, unchanged semantics; the sharded budgets and the maxmin landmarks
are not ported yet).

Dory's memory story is the ``(3n + 12 n_e) * 4``-byte base account: for a
fixed byte budget the only free knob is ``n_e``, i.e. ``tau_max``.  This
module picks ``tau_max`` *before* any build by sampling pairwise distances
from random pairs (never the full matrix) and inverting the empirical
distance CDF at the edge count the budget affords.
"""
from __future__ import annotations

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
) -> float:
    """Pick ``tau_max`` so the expected ``n_e`` fits the byte budget.

    The empirical CDF of sampled pair lengths estimates
    ``n_e(tau) ~= q(tau) * n(n-1)/2``; we take the quantile at the budgeted
    edge fraction, shrunk by ``safety`` to absorb sampling error.  Returns
    ``inf`` when the budget covers the full clique.
    """
    points = np.asarray(points)
    n = int(points.shape[0])
    total_pairs = n * (n - 1) // 2
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
