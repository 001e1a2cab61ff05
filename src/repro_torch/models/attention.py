"""Attention blocks: GQA/MQA with qk-norm + RoPE, sliding windows,
DeepSeek-style MLA (compressed KV), and the prefill/decode cache paths.

Port of ``src/repro/models/attention.py`` (M-RoPE and cross-attention
wait: ROADMAP.md §1, item 10).  Masking is data-driven (per-layer window
int; -1 = global).

**The prefill route.**  The reference's own attention is jnp, and its
docstring notes that the Pallas flash kernel handles the same masks on the
TPU.  The port's counterpart of that is a route: a prefill self-attention
whose positions are ``arange(S)`` (the caller passed ``positions=None``),
with no cache and ``window != 0``, goes through
``repro_torch.kernels.ops.attention``, the hand-written flash kernel on the
card.  Its masks are then exactly the kernel's: causal, a window of -1 or
> 0, no padded key.  KV heads are expanded to the query heads first
(``repeat_interleave``, the order of ``jnp.repeat``), and q, k and v are
copied to (B·H, S, D): on the card these copies are the next cost beside
the kernel (PERF.md).  Every other case (explicit positions, decode
against the cache, and ``window == 0``, which means "self only" here but
"global" in the kernel) takes :func:`_sdpa_masked`.  The route is forward
only: where autograd records and q, k or v requires grad it raises, and
the training forward passes explicit positions.  In arithmetic the
routes differ in summation order and in one rounding on the CPU: the
bfloat16 kernel on the card rounds the probabilities to bfloat16 before
the P.V product, as :func:`_sdpa` rounds them to ``v.dtype``, while the
kernel's plain version (the CPU route) keeps them in float32.  In float32
compute they agree.

MLA's prefill takes the same route.  Its q and k are ``nope + rope`` wide
(192 in deepseek-v2-lite) and its values ``v_head_dim`` (128), while the
kernel takes one width for all three: :func:`_flash_prefill` zero-pads the
values to q's width and slices the output back.  The padded columns add
nothing to P.V and the scale is ``1/sqrt(nope + rope)``, the reference's,
so it is the same function.

Decode writes the new K/V (MLA: the latent ``c_kv`` and the rotary key)
into the cache in place (the reference returns an updated copy);
:func:`attention_apply` and :func:`mla_apply` return the same cache
tensors.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import _param, apply_rope, dense_init, rmsnorm

NEG_INF = -2.0e38


def attn_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> dict:
    """Seeded init in the reference's layout (flat: the qk-norm scales sit
    under ``q_norm`` / ``k_norm``)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kw = dict(dtype=cfg.pdtype, device=device)
    p = {
        "wq": dense_init(gen, (d, h * hd), **kw),
        "wk": dense_init(gen, (d, kv * hd), **kw),
        "wv": dense_init(gen, (d, kv * hd), **kw),
        "wo": dense_init(gen, (h * hd, d), fan_in=h * hd, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, **kw)
        p["k_norm"] = torch.ones(hd, **kw)
    return p


def mla_params(cfg: ModelConfig, gen: torch.Generator,
               device=None) -> dict:
    """Seeded init in the reference's layout: ``wq`` (d, h·(nope+rope)),
    the latent down-projection ``w_dkv`` (d, r), the shared rotary key
    ``w_krope`` (d, rope), the up-projections ``w_uk`` (r, h·nope) and
    ``w_uv`` (r, h·v), ``wo`` and the latent's norm scale ``kv_norm``."""
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    r = m.kv_lora_rank
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "wq": dense_init(gen, (d, h * (m.nope_head_dim + m.rope_head_dim)),
                         **kw),
        "w_dkv": dense_init(gen, (d, r), **kw),
        "w_krope": dense_init(gen, (d, m.rope_head_dim), **kw),
        "w_uk": dense_init(gen, (r, h * m.nope_head_dim), fan_in=r, **kw),
        "w_uv": dense_init(gen, (r, h * m.v_head_dim), fan_in=r, **kw),
        "wo": dense_init(gen, (h * m.v_head_dim, d), fan_in=h * m.v_head_dim,
                         **kw),
        "kv_norm": torch.ones(r, **kw),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               causal: bool = True) -> torch.Tensor:
    """(.., Sq, Sk) additive float32 bias from positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    ok = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        ok &= diff >= 0
    if window >= 0:
        ok &= diff < max(window, 1)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,D) k/v: (B,Sk,KV,D'); returns float32 (B,Sq,H,D').

    The reference's two GQA layouts: decode (Sq == 1) groups q as
    (kv, group) against the cache; prefill broadcasts KV to the full head
    count.  Operands keep their dtype's values and products accumulate in
    float32 (the reference's ``preferred_element_type``); probabilities are
    cast to ``v.dtype`` before the P.V product.
    """
    b, sq, h, dq = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(dq)
    f32 = torch.float32
    if sq == 1 and kvh != h:
        g = h // kvh
        qg = q.reshape(b, sq, kvh, g, dq)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(f32),
                              k.to(f32)) * scale
        scores = scores + bias[:, None, None, :, :]
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd",
                           probs.to(v.dtype).to(f32), v.to(f32))
        return out.reshape(b, sq, h, v.shape[-1])
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), k.to(f32)) * scale
    scores = scores + bias[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(f32),
                        v.to(f32))


def _q_chunk(sq: int) -> int:
    """Query-block size for chunked attention (0 = unchunked): bounds the
    live float32 scores to one query block on long sequences."""
    if sq <= 2048:
        return 0
    return 1024 if sq <= 8192 else 512


def _sdpa_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                 causal: bool = True) -> torch.Tensor:
    """Mask-from-positions SDPA with automatic query chunking.

    q: (B,Sq,H,D); k/v: (B,Sk,KV,D'); q_pos: (B,Sq); k_pos: (B,Sk) or
    (Sk,)."""
    sq = q.shape[1]
    bq = _q_chunk(sq)
    if bq == 0 or sq % bq != 0:
        return _sdpa(q, k, v, _mask_bias(q_pos, k_pos, window, causal))
    outs = [_sdpa(q[:, i:i + bq], k, v,
                  _mask_bias(q_pos[:, i:i + bq], k_pos, window, causal))
            for i in range(0, sq, bq)]
    return torch.cat(outs, dim=1)


def _flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int, causal: bool) -> torch.Tensor:
    """Self-attention over positions ``arange(S)`` through the flash kernel:
    KV expanded to H heads, (B, S, H, D) -> (B·H, S, D) and back.  Values
    narrower than q and k (MLA) are zero-padded to their width for the
    kernel; the output has the values' head dim.

    Forward only, on every device: the kernel's output on the card has no
    ``grad_fn`` (``wq``, ``wk`` and ``wv`` would get no gradient through
    attention), while its plain version on the CPU would differentiate, so
    the two devices would train differently.  Under autograd it raises; a
    training forward passes explicit positions, which take
    :func:`_sdpa_masked`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the flash-kernel route is forward only: q, k or v requires "
            "grad; pass explicit positions (the training forward does) to "
            "take _sdpa_masked, or run under torch.no_grad()")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    dv = v.shape[-1]
    if dv > hd:
        raise ValueError(f"values of head dim {dv} wider than q's {hd}: the "
                         "kernel's scale would change with padded q and k")
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    if dv < hd:
        v = torch.nn.functional.pad(v, (0, hd - dv))

    def heads_first(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, t.shape[-1])

    out = ops.attention(heads_first(q), heads_first(k), heads_first(v),
                        causal=causal, window=window)
    return out.reshape(b, h, s, hd)[..., :dv].permute(0, 2, 1, 3)


def attention_apply(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, positions: Optional[torch.Tensor],
                    window: int,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_pos: Optional[int] = None, causal: bool = True):
    """Standard GQA attention over ``p`` (``wq``, ``wk``, ``wv``, ``wo``,
    and ``q_norm`` / ``k_norm`` scales with qk-norm).

    ``cache=(K, V)`` (capacity S_max): a decode step, x is (B, 1, d), the
    new K/V are written at ``cache_pos``.  Otherwise a prefill;
    ``positions=None`` stands for ``arange(S)`` and, with ``window != 0``,
    takes the flash-kernel route (module docstring).  Explicit positions
    take :func:`_sdpa_masked` even when they are ``arange(S)``, which is
    how the route is checked against it.  Returns (out, (K, V)).
    """
    cdt = cfg.cdtype
    b, s, _ = x.shape
    flash = positions is None and cache is None and window != 0
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    x = x.to(cdt)
    q = (x @ p["wq"].to(cdt)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(cdt)).reshape(b, s, kv, hd)
    v = (x @ p["wv"].to(cdt)).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if flash:
            out = _flash_prefill(q, k, v, window, causal)
        else:
            out = _sdpa_masked(q, k, v, positions, positions, window,
                               causal=causal)
        new_cache = (k, v)
    else:
        ck, cv = cache
        ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
        cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
        s_max = ck.shape[1]
        k_pos = torch.arange(s_max, device=x.device)
        diff = cache_pos - k_pos
        ok = diff >= 0                                       # causal/valid
        if window >= 0:
            ok &= diff < max(window, 1)
        bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
        bias = bias[None, None, :].expand(b, s, s_max)
        out = _sdpa(q, ck.to(cdt), cv.to(cdt), bias)
        new_cache = (ck, cv)
    out = out.reshape(b, s, h * hd).to(cdt)
    return out @ p["wo"].to(cdt), new_cache


def mla_apply(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor, positions: Optional[torch.Tensor],
              window: int,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None):
    """DeepSeek-V2 Multi-head Latent Attention over ``p`` (the
    :func:`mla_params` layout): KV compressed to ``kv_lora_rank`` plus one
    shared rotary key head; the cache holds only the latent ``c_kv`` and
    the rotary key, (B, S_max, r) and (B, S_max, rope).

    ``cache`` given: a decode step in the reference's absorbed form, scored
    against the latent cache, ``q·K^T = (q_nope W_uk^T)·c^T`` and ``out =
    (P·c) W_uv``, with ``q_nope W_uk^T`` rounded to the compute dtype and
    the scores accumulated in float32.  Otherwise a prefill whose K is
    ``[c_kv W_uk, k_rope]`` and V ``c_kv W_uv``; ``positions=None`` (with
    ``window != 0``) takes the flash-kernel route, explicit positions
    :func:`_sdpa_masked`.  Returns (out, (c_kv, k_rope)).
    """
    cdt = cfg.cdtype
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    flash = positions is None and cache is None and window != 0
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    x = x.to(cdt)
    q = (x @ p["wq"].to(cdt)).reshape(b, s, h, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    c_kv = rmsnorm(x @ p["w_dkv"].to(cdt), p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_krope"].to(cdt))[:, :, None, :],
                        positions, cfg.rope_theta)            # (B,S,1,rope)

    if cache is not None:
        c_cache, kr_cache = cache
        c_cache[:, cache_pos:cache_pos + s] = c_kv.to(c_cache.dtype)
        kr_cache[:, cache_pos:cache_pos + s] = k_rope[:, :, 0].to(
            kr_cache.dtype)
        f32 = torch.float32
        c_all = c_cache.to(cdt).to(f32)
        kr_all = kr_cache.to(cdt).to(f32)
        w_uk_h = p["w_uk"].to(cdt).reshape(r, h, nope)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk_h)  # cdt
        s_nope = torch.einsum("bqhr,bkr->bhqk", q_lat.to(f32), c_all)
        s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32), kr_all)
        scores = (s_nope + s_rope) * (1.0 / math.sqrt(nope + rope))
        k_idx = torch.arange(c_cache.shape[1], device=x.device)
        ok = k_idx <= cache_pos
        if window >= 0:
            ok &= cache_pos - k_idx < max(window, 1)
        scores = torch.where(ok, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out_lat = torch.einsum("bhqk,bkr->bqhr", probs.to(cdt).to(f32),
                               c_all)                          # float32
        w_uv_h = p["w_uv"].to(cdt).reshape(r, h, dv)
        out = torch.einsum("bqhr,rhv->bqhv", out_lat.to(cdt), w_uv_h)
        out = out.reshape(b, s, h * dv).to(cdt)
        return out @ p["wo"].to(cdt), (c_cache, kr_cache)

    k_nope = (c_kv @ p["w_uk"].to(cdt)).reshape(b, s, h, nope)
    val = (c_kv @ p["w_uv"].to(cdt)).reshape(b, s, h, dv)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, rope)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    if flash:
        out = _flash_prefill(q_full, k_full, val, window, True)
    else:
        out = _sdpa_masked(q_full, k_full, val, positions, positions, window,
                           causal=True)
    out = out.reshape(b, s, h * dv).to(cdt)
    return out @ p["wo"].to(cdt), (c_kv, k_rope[:, :, 0])


class Attention(nn.Module):
    """Holds one layer's attention weights (the :func:`attn_params`
    layout) and applies :func:`attention_apply`."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({name: _param(t) for name, t in p.items()})

    def forward(self, x, positions, window, cache=None, cache_pos=None):
        return attention_apply(self.p, self.cfg, x, positions, window,
                               cache=cache, cache_pos=cache_pos)


class MLA(nn.Module):
    """Holds one layer's latent-attention weights (the :func:`mla_params`
    layout) and applies :func:`mla_apply`."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({name: _param(t) for name, t in p.items()})

    def forward(self, x, positions, window, cache=None, cache_pos=None):
        return mla_apply(self.p, self.cfg, x, positions, window,
                         cache=cache, cache_pos=cache_pos)
