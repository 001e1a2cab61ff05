"""Dispatch wrappers over the port's kernels.

Port of ``src/repro/kernels/ops.py``.  Where the reference picks the Pallas
kernel or its jnp oracle with ``use_pallas`` / ``interpret``, the port lets
the device of the inputs decide: CUDA tensors go through the hand-written
kernels, CPU tensors through their plain PyTorch versions (each wrapper
makes that choice itself, and never falls back on a CUDA tensor).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention
from .gf2 import gf2_find_low, gf2_serial_reduce
from .pairwise_dist import pairwise_sq_dists


def pairwise_distances(x: torch.Tensor,
                       y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Euclidean distances between the rows of x (M, d) and y (N, d),
    through the pairwise kernel; ``y=None`` is x against itself."""
    self_dist = y is None
    y = x if y is None else y
    d2 = pairwise_sq_dists(x.to(torch.float32).contiguous(),
                           y.to(torch.float32).contiguous())
    if self_dist:
        # kill catastrophic-cancellation residue on the diagonal
        d2 = d2 * (1.0 - torch.eye(d2.shape[0], dtype=d2.dtype,
                                   device=d2.device))
    return torch.sqrt(d2)


def find_low(cols: torch.Tensor) -> torch.Tensor:
    """First set bit per row of a (C, W) int32 bit block."""
    return gf2_find_low(cols)


def serial_reduce_bits(blocks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intra-block serial reduction of a (G, C, W) int32 bit batch."""
    return gf2_serial_reduce(blocks)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = -1) -> torch.Tensor:
    """(BH, S, d) attention: the flash kernel on the card, the plain
    version on the CPU."""
    return flash_attention(q, k, v, causal=causal, window=window)
