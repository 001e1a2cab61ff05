"""Persistence-diagram comparison.

Port of ``src/repro/core/diagrams.py``: ``canonicalize`` and the
comparisons (numpy, unchanged semantics).  The summaries and TDA features
stay in the reference until a ported caller needs them.
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
