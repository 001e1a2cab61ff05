"""Point-cloud generators for the paper's benchmark suite.

Port of ``src/repro/data/pointclouds.py``: the two clouds the main path
and its smoke run use, following the paper's published definitions
exactly (random samples of the Clifford torus S^1 x S^1 in R^4; random
orthogonal 3x3 matrices in R^9).  Same seeds give the same points as the
reference.
"""
from __future__ import annotations

import numpy as np


def clifford_torus(n: int, seed: int = 0, grid: bool = False) -> np.ndarray:
    """torus4 (paper Table 1): points on S^1 x S^1 in R^4, radius 1/sqrt(2)."""
    if grid:
        k = int(round(np.sqrt(n)))
        a, b = np.meshgrid(np.linspace(0, 2 * np.pi, k, endpoint=False),
                           np.linspace(0, 2 * np.pi, k, endpoint=False))
        a, b = a.ravel(), b.ravel()
    else:
        rng = np.random.default_rng(seed)
        a = rng.uniform(0, 2 * np.pi, n)
        b = rng.uniform(0, 2 * np.pi, n)
    return np.stack([np.cos(a), np.sin(a), np.cos(b), np.sin(b)],
                    axis=1) / np.sqrt(2)


def o3_points(n: int, seed: int = 0) -> np.ndarray:
    """o3 (paper Table 1): n random orthogonal 3x3 matrices, points in R^9."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, 9))
    for i in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        out[i] = q.ravel()
    return out
