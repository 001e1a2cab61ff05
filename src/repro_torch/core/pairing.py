"""Paired-indexing for 2- and 3-simplices (Dory §4.1).

Port of ``src/repro/core/pairing.py`` (numpy, unchanged semantics).

A triangle/tetrahedron is identified by ``<k_p, k_s>``:

* primary key ``k_p``  — filtration order of the simplex *diameter* edge,
* secondary key ``k_s`` — for triangles, the remaining vertex id (``f_0``);
  for tetrahedra, the filtration order of the *opposite* edge (``f_1``).

Both keys are bounded by ``O(n_e)`` (number of permissible edges), never by the
combinatorial index space ``O(n^4)`` — this is the paper's central memory
insight and the reason 8 bytes always suffice.  We pack the pair into one
``int64`` lane (``k_p << 32 | k_s``) which *preserves the paper's ordering*
(eq. 1: lexicographic on ``(k_p, k_s)``), so packed keys sort/compare natively
without 128-bit arithmetic (the failure mode of combinatorial indexing that
crashed Ripser on the Hi-C data set).
"""
from __future__ import annotations

import numpy as np

# Sentinel: larger than any valid packed key (k_p < 2**31).  Used as the
# "Empty"/MAX marker of the paper's flowcharts and as the sort-to-the-end pad.
EMPTY_KEY = np.int64(np.iinfo(np.int64).max)

_SHIFT = np.int64(32)
_MASK = np.int64((1 << 32) - 1)


def pack(kp, ks):
    """Pack ``<k_p, k_s>`` into one int64; order-preserving (paper eq. 1)."""
    return (np.int64(kp) << _SHIFT) | (np.int64(ks) & _MASK)


def unpack(key):
    """Inverse of :func:`pack`; returns ``(k_p, k_s)``."""
    key = np.asarray(key, dtype=np.int64)
    return (key >> _SHIFT).astype(np.int64), (key & _MASK).astype(np.int64)


def pack_np(kp: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """Vectorized pack for numpy arrays (any broadcastable shapes)."""
    return (kp.astype(np.int64) << _SHIFT) | (ks.astype(np.int64) & _MASK)


def primary(key):
    """``k_p`` of a packed key (diameter-edge order)."""
    return np.asarray(key, dtype=np.int64) >> _SHIFT


def secondary(key):
    """``k_s`` of a packed key."""
    return np.asarray(key, dtype=np.int64) & _MASK
