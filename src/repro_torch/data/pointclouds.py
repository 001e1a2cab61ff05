"""Point-cloud generators for the paper's benchmark suite.

Port of ``src/repro/data/pointclouds.py``, numpy throughout: the same seeds
give the same arrays as the reference.

``o3`` and ``torus4`` follow the paper's published definitions exactly
(8192 random orthogonal 3x3 matrices in R^9; random samples of the Clifford
torus S^1 x S^1 in R^4).  ``dragon``/``fractal`` stand-ins are generated
shapes with comparable regimes (3-D surface scan-like cloud; self-similar
network distance matrix), since the original files ship with external repos.
The Hi-C pair mimics the paper's §6 workload: a genome-like folded curve
("control") whose loop anchors are released in the "auxin" variant.
"""
from __future__ import annotations

import numpy as np


def circle_points(n: int, noise: float = 0.0, seed: int = 0) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([np.cos(t), np.sin(t)], axis=1)
    if noise:
        pts = pts + np.random.default_rng(seed).normal(scale=noise,
                                                       size=pts.shape)
    return pts


def two_circles(n: int = 20, separation: float = 6.0) -> np.ndarray:
    a = circle_points(n)
    b = circle_points(n) + np.array([separation, 0.0])
    return np.concatenate([a, b], axis=0)


def sphere_points(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


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


def dragon_like(n: int, seed: int = 0) -> np.ndarray:
    """3-D surface-scan-like cloud (dragon stand-in): noisy torus knot tube."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    p, q = 2, 3
    r = np.cos(q * t) + 2.0
    base = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)],
                    axis=1)
    return base + rng.normal(scale=0.08, size=base.shape)


def fractal_like(n: int = 512, seed: int = 0) -> np.ndarray:
    """Self-similar network distance matrix (fractal stand-in).

    Recursive block structure: distance = level at which two leaves split,
    scaled + jittered — returns a *distance matrix* like the paper's set.
    """
    rng = np.random.default_rng(seed)
    levels = int(np.ceil(np.log2(n)))
    idx = np.arange(n)
    d = np.zeros((n, n))
    for lvl in range(levels):
        blk = (idx >> lvl)
        same = blk[:, None] == blk[None, :]
        d = np.where(same, d, lvl + 1.0)
    d = d / levels
    jitter = rng.uniform(0, 0.02, size=(n, n))
    jitter = (jitter + jitter.T) / 2
    d = d + jitter
    np.fill_diagonal(d, 0.0)
    return d


def genome_like(n: int, n_loops: int, seed: int = 0,
                loop_strength: float = 0.95) -> np.ndarray:
    """Hi-C-like folded-polymer point cloud (paper §6 stand-in).

    A 3-D random-walk polymer ("chromatin fiber") with ``n_loops`` cohesin
    loop anchors: pairs of loci pulled spatially together.  The *control*
    condition keeps the anchors; *auxin* (cohesin degraded) uses
    ``loop_strength=0`` which releases them — PH should report fewer H1
    loops, reproducing Fig. 21's direction.
    """
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(n, 3))
    pts = np.cumsum(steps, axis=0) / np.sqrt(n)
    spacing = np.sqrt(3.0 / n)          # typical inter-locus distance
    anchors = np.sort(rng.choice(n - 8, size=n_loops, replace=False))
    spans = rng.integers(n // 16, n // 4, size=n_loops)
    for ai, sp in zip(anchors, spans):
        bi = min(ai + int(sp), n - 1)
        seg = pts[ai:bi + 1].copy()
        length = bi - ai
        if length < 8:
            continue
        # cohesin ring: anchors meet, the intervening fiber bulges into an
        # extended loop — blend the segment toward a circle whose
        # circumference matches the fiber's natural length (a real H1
        # feature with birth ~ spacing and death ~ loop radius)
        u = rng.normal(size=3)
        u /= np.linalg.norm(u)
        v = rng.normal(size=3)
        v -= v @ u * u
        v /= np.linalg.norm(v)
        r = length * spacing / (2 * np.pi)
        center = (seg[0] + seg[-1]) / 2
        theta = np.linspace(0.0, 2 * np.pi, length + 1)
        circle = center + r * (np.cos(theta)[:, None] * u
                               + np.sin(theta)[:, None] * v)
        new_seg = loop_strength * circle + (1 - loop_strength) * seg
        delta = new_seg[-1] - seg[-1]
        pts[ai:bi + 1] = new_seg
        pts[bi + 1:] += delta           # keep the downstream fiber attached
    return pts


def hic_pair(n: int, n_loops: int = 24, seed: int = 0):
    """(control, auxin) point-cloud pair for the Fig. 21 reproduction."""
    control = genome_like(n, n_loops, seed=seed, loop_strength=0.95)
    auxin = genome_like(n, n_loops, seed=seed, loop_strength=0.0)
    return control, auxin
