"""Shared neural layers: norms, MLPs, embeddings, rotary position encodings.

Port of ``src/repro/models/layers.py``.  Weights keep the reference's
``(in, out)`` layout and every product is ``x @ w``, so carrying a JAX
parameter tree across is a copy, not a transpose.  The functions take
plain tensors; :class:`RMSNorm` and :class:`MLP` are the ``nn.Module``
holders the transformer is built from.  ``constrain`` is dropped: without
a mesh it is a no-op.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch
from torch import nn


def dense_init(gen: torch.Generator, shape: Sequence[int],
               fan_in: Optional[int] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 1/fan_in) (fan_in defaults to ``shape[0]``), from ``gen``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        w_gate: Optional[torch.Tensor] = None,
        cdtype=torch.bfloat16) -> torch.Tensor:
    """SiLU-gated when ``w_gate`` is given, else GELU (tanh form, as
    ``jax.nn.gelu``'s default)."""
    x = x.to(cdtype)
    up = x @ w_up.to(cdtype)
    if w_gate is not None:
        h = torch.nn.functional.silu(x @ w_gate.to(cdtype)) * up
    else:
        h = torch.nn.functional.gelu(up, approximate="tanh")
    return h @ w_down.to(cdtype)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor,
            cdtype=torch.bfloat16) -> torch.Tensor:
    # 1/sqrt(d) keeps initial logits O(1) under tied N(0,1) embeddings
    d = x.shape[-1]
    logits = x.to(cdtype) @ table.to(cdtype).T
    return logits * (1.0 / d ** 0.5)


# ---------------------------------------------------------------------------
# Rotary position encodings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates in float32 and
    casts back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs              # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 1e6) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): x (B, S, H, D); positions3 (3, B, S).

    The D/2 frequency lanes are split into (temporal, height, width)
    sections; lane ``l`` rotates by ``positions3[sec[l]]``.  With the three
    grids equal it is :func:`apply_rope`.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # (D/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    assert sec.shape[0] == d // 2, (sections, d)
    lane_pos = positions3.float()[sec]                      # (D/2, B, S)
    ang = torch.movedim(lane_pos, 0, -1) * freqs            # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int,
                         device=None) -> torch.Tensor:
    """(seq, d_model) float32: sin at the even columns, cos at the odd,
    of ``pos · exp(-2i·ln(10000)/d_model)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * neg_log_10000_over(d_model, device))
    pe = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def neg_log_10000_over(d_model: int, device=None) -> torch.Tensor:
    """``-ln(10000) / d_model`` as a 0-d float32 tensor, each step
    rounded to float32 as the reference's ``-jnp.log(10000.0) / d_model``:
    the frequencies it scales are then the reference's to the last bit
    before ``exp``."""
    return -torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                   device=device)) / d_model


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    # Frozen: serving and the PH monitor only read the weights, and a frozen
    # weight keeps autograd from recording every forward.  The trainer turns
    # gradients on for its own model (``requires_grad_(True)``).
    return nn.Parameter(t, requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float):
        super().__init__()
        self.scale = _param(scale)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


class MLP(nn.Module):
    """From the reference's ``mlp`` params: ``w_up``, ``w_down`` and, for
    the SiLU-gated form, ``w_gate``."""

    def __init__(self, p: Mapping[str, torch.Tensor], cdtype: torch.dtype):
        super().__init__()
        self.w_up = _param(p["w_up"])
        self.w_down = _param(p["w_down"])
        self.w_gate = _param(p["w_gate"]) if "w_gate" in p else None
        self.cdtype = cdtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.w_up, self.w_down, self.w_gate, self.cdtype)
