"""Serving steps: prefill, cache extension, one-token decode, sampling.

Port of ``src/repro/serve/steps.py``.  PyTorch runs eagerly, so the step
builders return plain closures where the reference returns functions for
``jax.jit``.  ``extend_cache`` turns a prefill cache (KV length = prompt
length) into a fixed-capacity decode cache (KV length = ``s_max``) by
zero-padding the sequence axis of the attention-family layers
(self-attention's and ``local_attn``'s K/V, MLA's latent ``c_kv`` and
rotary key); the recurrent layers' states, and a decoder layer's
cross-attention K/V, pass through.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, decode_step,
                                            forward, is_attention,
                                            layer_slots)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(model, batch) -> (logits, cache_dict); batch: tokens
    (B, S) | embeds (B, S, d), optional positions (B, S) (+ positions3 /
    enc_embeds)."""

    def prefill_step(model: Transformer, batch):
        logits, _aux, caches = forward(model, batch, return_caches=True)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """decode_fn(model, cache, batch) -> (logits, new_cache); batch: tokens
    (B, 1) | embeds (B, 1, d), cache_pos int."""

    def decode_fn(model: Transformer, cache, batch):
        return decode_step(model, cache, batch)

    return decode_fn


def extend_cache(cfg: ModelConfig, prefill_cache: Dict[str, Any],
                 prompt_len: int, s_max: int) -> Dict[str, Any]:
    """Pad each attention-family layer's cache along the sequence (axis 1)
    to ``s_max`` with zeros: (K, V) of (B, prompt_len, KV, D), or MLA's
    (c_kv, k_rope) of (B, prompt_len, r) and (B, prompt_len, d_rope).  The
    layers are chosen by their kind (:func:`layer_slots`), never by shape,
    as the reference chooses them: a recurrent state whose dimension
    happens to equal ``prompt_len`` passes through.  So do a decoder
    layer's slots 2 and 3, its cross-attention K/V, chosen by slot index:
    they keep the encoder's length even where it equals ``prompt_len``,
    since zero keys would take softmax mass."""

    def pad(t: torch.Tensor) -> torch.Tensor:
        extra = s_max - t.shape[1]
        if extra <= 0 or t.shape[1] != prompt_len:
            return t
        return torch.cat([t, t.new_zeros((t.shape[0], extra) + t.shape[2:])],
                         dim=1)

    def grown(layer, kind):
        if not is_attention(kind):
            return layer
        n_self = 2 if kind == "dec_attn_mlp" else len(layer)
        return tuple(pad(t) for t in layer[:n_self]) + tuple(layer[n_self:])

    layers = [grown(layer, slot.kind)
              for layer, slot in zip(prefill_cache["layers"],
                                     layer_slots(cfg))]
    return {"layers": layers, "enc_out": prefill_cache.get("enc_out")}


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) -> (B, 1) int32, the last position's argmax (first index
    on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)



def sample_temperature(logits: torch.Tensor, key: torch.Generator,
                       temperature: float = 1.0) -> torch.Tensor:
    """(B, S, V) -> (B, 1) int32: one token a row drawn from
    ``softmax(logits[:, -1, :] / max(temperature, 1e-6))``.

    ``key`` is a ``torch.Generator`` on the logits' device.  The draw is
    the reference's construction, the argmax of the scaled logits plus
    Gumbel noise (``jax.random.categorical``), but its noise comes from
    the generator, so the tokens are not the reference's.  The contract
    held instead: the same seed gives the same tokens on the same device;
    the draw frequencies are ``softmax(logits / temperature)``; and as
    ``temperature -> 0`` the result is :func:`sample_greedy`'s.
    """
    scaled = logits[:, -1, :].float() / max(temperature, 1e-6)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(scaled.shape, generator=key, dtype=torch.float32,
                   device=scaled.device).clamp_min(tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scaled + gumbel, dim=-1, keepdim=True).to(
        torch.int32)
