"""Persistence-diagram utilities: comparison, summaries, TDA features.

Port of ``src/repro/core/diagrams.py`` (host numpy, unchanged semantics).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def canonicalize(pd: np.ndarray, drop_zero: bool = True) -> np.ndarray:
    """Sort a PD (k,2) lexicographically; optionally drop zero-persistence."""
    pd = np.asarray(pd, dtype=np.float64).reshape(-1, 2)
    if drop_zero and pd.size:
        pd = pd[pd[:, 1] > pd[:, 0]]
    if pd.size == 0:
        return pd.reshape(0, 2)
    idx = np.lexsort((pd[:, 1], pd[:, 0]))
    return pd[idx]


def diagrams_equal(pd_a: np.ndarray, pd_b: np.ndarray,
                   atol: float = 1e-9) -> bool:
    """Multiset equality of two diagrams up to tolerance (inf-aware)."""
    a, b = canonicalize(pd_a), canonicalize(pd_b)
    if a.shape != b.shape:
        return False
    if a.size == 0:
        return True
    finite = np.isfinite(a) & np.isfinite(b)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        return False
    return bool(np.allclose(a[finite], b[finite], atol=atol, rtol=0))


def assert_diagrams_equal(pds_a: Dict[int, np.ndarray],
                          pds_b: Dict[int, np.ndarray],
                          dims=None, atol: float = 1e-9) -> None:
    dims = dims if dims is not None else sorted(set(pds_a) & set(pds_b))
    for d in dims:
        a, b = canonicalize(pds_a[d]), canonicalize(pds_b[d])
        if not diagrams_equal(a, b, atol=atol):
            raise AssertionError(
                f"H{d} diagrams differ:\nA ({a.shape[0]} pts):\n{a}\n"
                f"B ({b.shape[0]} pts):\n{b}")


def betti_curve(pd: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """Betti number as a function of scale (vectorized)."""
    pd = np.asarray(pd, dtype=np.float64).reshape(-1, 2)
    if pd.size == 0:
        return np.zeros_like(taus, dtype=np.int64)
    alive = (pd[:, 0][None, :] <= taus[:, None]) & (pd[:, 1][None, :] > taus[:, None])
    return alive.sum(axis=1)


def total_persistence(pd: np.ndarray, tau_cap: float = np.inf) -> float:
    """Sum of (death - birth), with inf deaths capped at ``tau_cap``."""
    pd = canonicalize(pd)
    if pd.size == 0:
        return 0.0
    death = np.minimum(pd[:, 1], tau_cap)
    return float(np.clip(death - pd[:, 0], 0, None).sum())


def summary(pd: np.ndarray, tau_cap: float = np.inf) -> Dict[str, float]:
    pd = canonicalize(pd)
    n_inf = int(np.isinf(pd[:, 1]).sum()) if pd.size else 0
    return {
        "count": float(pd.shape[0]),
        "n_essential": float(n_inf),
        "total_persistence": total_persistence(pd, tau_cap),
        "max_persistence": float(
            np.max(np.minimum(pd[:, 1], tau_cap) - pd[:, 0])) if pd.size else 0.0,
    }


def persistence_image(pd: np.ndarray, resolution: int = 16,
                      sigma: float = 0.1, tau_cap: float = 1.0) -> np.ndarray:
    """Pixelated PD embedding (PI-Net-style target; used by the TDA monitor)."""
    pd = canonicalize(pd)
    img = np.zeros((resolution, resolution), dtype=np.float64)
    if pd.size == 0:
        return img
    birth = np.clip(pd[:, 0], 0, tau_cap)
    pers = np.clip(np.minimum(pd[:, 1], tau_cap) - pd[:, 0], 0, tau_cap)
    xs = np.linspace(0, tau_cap, resolution)
    gx = np.exp(-0.5 * ((xs[None, :] - birth[:, None]) / sigma) ** 2)
    gy = np.exp(-0.5 * ((xs[None, :] - pers[:, None]) / sigma) ** 2)
    img = np.einsum("ki,kj->ij", gy * pers[:, None], gx)
    return img / max(img.max(), 1e-12)
