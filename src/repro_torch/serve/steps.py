"""Serving steps: prefill, cache extension, one-token decode, sampling.

Port of ``src/repro/serve/steps.py`` for the dense decoder.  PyTorch runs
eagerly, so the step builders return plain closures where the reference
returns functions for ``jax.jit``.  ``extend_cache`` turns a prefill cache
(KV length = prompt length) into a fixed-capacity decode cache (KV length
= ``s_max``) by zero-padding every layer's self-attention K/V.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, check_supported,
                                            decode_step, forward)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(model, batch) -> (logits, cache_dict); batch: tokens
    (B, S), optional positions (B, S)."""
    check_supported(cfg)

    def prefill_step(model: Transformer, batch):
        logits, _aux, caches = forward(model, batch, return_caches=True)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """decode_fn(model, cache, batch) -> (logits, new_cache); batch: tokens
    (B, 1), cache_pos int."""
    check_supported(cfg)

    def decode_fn(model: Transformer, cache, batch):
        return decode_step(model, cache, batch)

    return decode_fn


def extend_cache(cfg: ModelConfig, prefill_cache: Dict[str, Any],
                 prompt_len: int, s_max: int) -> Dict[str, Any]:
    """Pad each layer's (K, V) (B, prompt_len, KV, D) along the sequence to
    ``s_max`` with zeros."""

    def pad(t: torch.Tensor) -> torch.Tensor:
        extra = s_max - t.shape[1]
        if extra <= 0 or t.shape[1] != prompt_len:
            return t
        return torch.cat([t, t.new_zeros((t.shape[0], extra) + t.shape[2:])],
                         dim=1)

    layers = [(pad(k), pad(v)) for k, v in prefill_cache["layers"]]
    return {"layers": layers, "enc_out": prefill_cache.get("enc_out")}


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) -> (B, 1) int32, the last position's argmax (first index
    on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)

