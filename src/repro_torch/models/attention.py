"""Attention blocks: GQA/MQA with qk-norm + RoPE/M-RoPE, sliding windows,
DeepSeek-style MLA (compressed KV), cross-attention, and the
prefill/decode cache paths.

Port of ``src/repro/models/attention.py``.  Masking is data-driven
(per-layer window int; -1 = global).

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
"global" in the kernel) takes :func:`_sdpa_masked`.  M-RoPE rotates by
its three position grids, but its mask is the 1-D ``positions``': a
qwen2-vl prefill without ``positions`` takes the kernel whatever its
image grid.  Cross-attention (:func:`cross_attention_apply`) attends
S_dec queries to S_enc keys, while the kernel takes one length for both,
as the Pallas kernel does: it always takes :func:`_sdpa_masked`, as the
reference keeps it off the Pallas kernel.  The route is forward
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

The meshed forms sit at the end: :func:`attention_meshed`,
:func:`mla_meshed` and :func:`cross_attention_meshed` run each data
entry's rows with the heads split over ``model`` where they align, on the
rotation tables and mask biases of :func:`attention_tables` (RoPE at MLA's
rotary width, M-RoPE from ``positions3``, the encoder's not causal);
:func:`attention_meshed` is the serving prefill's too, on the flash route,
and :func:`attention_decode_meshed` the meshed decode against a
sequence-sharded cache, its softmax combined over the blocks by
log-sum-exp.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import _param, apply_mrope, apply_rope, dense_init, rmsnorm

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


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """:func:`_sdpa_masked` with the whole (B, Sq, Sk) bias computed
    already: the same query chunks, each its rows of the bias."""
    sq = q.shape[1]
    bq = _q_chunk(sq)
    if bq == 0 or sq % bq != 0:
        return _sdpa(q, k, v, bias)
    return torch.cat([_sdpa(q[:, i:i + bq], k, v, bias[:, i:i + bq])
                      for i in range(0, sq, bq)], dim=1)


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
                    cache_pos: Optional[int] = None,
                    positions3: Optional[torch.Tensor] = None,
                    causal: bool = True):
    """Standard GQA attention over ``p`` (``wq``, ``wk``, ``wv``, ``wo``,
    and ``q_norm`` / ``k_norm`` scales with qk-norm).  With
    ``cfg.rope_kind == "mrope"``, q and k rotate by ``positions3`` (3, B,
    S) and ``positions`` only masks; ``causal=False`` is the encoder's
    self-attention.

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
    elif cfg.rope_kind == "mrope":
        q = apply_mrope(q, positions3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions3, cfg.mrope_sections, cfg.rope_theta)

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


def cross_attn_params(cfg: ModelConfig, gen: torch.Generator,
                      device=None) -> dict:
    """Seeded init in the reference's layout: ``wq``, ``wk``, ``wv`` (d,
    h·hd) and ``wo`` (h·hd, d); K and V have all ``n_heads`` heads."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "wq": dense_init(gen, (d, h * hd), **kw),
        "wk": dense_init(gen, (d, h * hd), **kw),
        "wv": dense_init(gen, (d, h * hd), **kw),
        "wo": dense_init(gen, (h * hd, d), fan_in=h * hd, **kw),
    }


def cross_attention_apply(params: Mapping[str, torch.Tensor],
                          cfg: ModelConfig, x: torch.Tensor,
                          enc_out: Optional[torch.Tensor],
                          kv_cache: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None):
    """Decoder-to-encoder attention (whisper): x (B, S, d) attends to every
    encoder position, unmasked.  K and V come from ``enc_out`` (B, Se, d)
    at prefill and are returned; ``kv_cache=(xk, xv)`` (decode) reuses
    them and ``enc_out`` is not read.  Always :func:`_sdpa_masked`, with
    zero positions, ``causal=False`` and window -1: S != Se, and the flash
    kernel takes one length for q and k.  Returns (out, (xk, xv))."""
    cdt = cfg.cdtype
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim_
    x = x.to(cdt)
    q = (x @ params["wq"].to(cdt)).reshape(b, s, h, hd)
    if kv_cache is not None:
        k, v = (t.to(cdt) for t in kv_cache)
    else:
        e = enc_out.to(cdt)
        se = e.shape[1]
        k = (e @ params["wk"].to(cdt)).reshape(b, se, h, hd)
        v = (e @ params["wv"].to(cdt)).reshape(b, se, h, hd)
    q_pos = torch.zeros((b, s), dtype=torch.int64, device=x.device)
    k_pos = torch.zeros((k.shape[1],), dtype=torch.int64, device=x.device)
    out = _sdpa_masked(q, k, v, q_pos, k_pos, -1, causal=False)
    out = out.reshape(b, s, h * hd).to(cdt)
    return out @ params["wo"].to(cdt), (k, v)


class Attention(nn.Module):
    """Holds one layer's attention weights (the :func:`attn_params`
    layout) and applies :func:`attention_apply`."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({name: _param(t) for name, t in p.items()})

    def forward(self, x, positions, window, cache=None, cache_pos=None,
                causal=True, positions3=None):
        return attention_apply(self.p, self.cfg, x, positions, window,
                               cache=cache, cache_pos=cache_pos,
                               positions3=positions3, causal=causal)


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


class CrossAttention(nn.Module):
    """Holds one decoder layer's cross-attention weights (the
    :func:`cross_attn_params` layout) and applies
    :func:`cross_attention_apply`."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({name: _param(t) for name, t in p.items()})

    def forward(self, x, enc_out, kv_cache=None):
        return cross_attention_apply(self.p, self.cfg, x, enc_out,
                                     kv_cache=kv_cache)


def _project(plan, x, w, m: int):
    """``x @ w`` for model entry ``m`` of a sharded projection: its column
    block when ``w`` is column-parallel, the whole output (row-parallel
    partials ``psum``-ed, or one product) otherwise."""
    from .layers import model_psum

    cdt = x.dtype
    dim = plan.split_model(w)
    if dim == 1:
        return x @ plan.local(w, m, cdt)
    if dim == 0:
        d = x.shape[-1] // plan.tp
        return model_psum(plan, [x[..., j * d:(j + 1) * d]
                                 @ plan.local(w, j, cdt)
                                 for j in range(plan.tp)])
    return x @ plan.local(w, 0, cdt)


def _out_meshed(plan, wo, parts, q_split: bool, cdt):
    """One data entry's out-projection.  Aligned heads (``q_split``):
    ``parts[m]`` is model entry ``m``'s own heads' output, times its row
    block of ``wo``, ``psum``-ed.  Misaligned: ``parts[0]`` is the whole
    output, times ``wo`` column-parallel over ``d_model`` with its blocks
    gathered (or one product where ``wo`` does not split)."""
    from repro_torch.launch.mesh import all_gather

    from .layers import model_psum

    if q_split:
        return model_psum(plan, [o @ plan.local(wo, m, cdt)
                                 for m, o in enumerate(parts)])
    out = parts[0]
    if plan.split_model(wo) == 1:
        cols = [out @ plan.local(wo, m, cdt) for m in range(plan.tp)]
        return torch.cat(list(all_gather(plan.mesh, "model", cols)), dim=-1)
    return out @ plan.local(wo, 0, cdt)


def attention_tables(cfg: ModelConfig, positions: torch.Tensor, windows,
                     causal: bool = True,
                     positions3: Optional[torch.Tensor] = None,
                     flash: bool = False) -> dict:
    """What every layer's meshed attention of one data entry shares: the
    mask bias of each window in ``windows`` (not causal for the encoder)
    and the rotation tables, computed once a forward: RoPE's
    (:func:`~repro_torch.models.layers.rope_tables`, at MLA's rotary
    width for MLA), or M-RoPE's by ``positions3`` (3, B, S), by default
    ``positions`` on all three grids
    (:func:`~repro_torch.models.layers.mrope_tables`).

    ``flash=True`` (the serving prefill, whose ``positions`` are
    ``arange(S)``): the layers of a window other than 0 take the flash
    route, which needs no bias, so only window 0 gets one."""
    from .layers import mrope_tables, rope_tables

    wins = sorted(set(windows))
    if flash:
        wins = [w for w in wins if w == 0]
    out = {"positions": positions, "causal": causal, "flash": flash,
           "bias": {w: _mask_bias(positions, positions, w, causal)
                    for w in wins}}
    if cfg.rope_kind == "rope":
        dim = cfg.mla.rope_head_dim if cfg.mla is not None \
            else cfg.head_dim_
        out["rope"] = rope_tables(positions, dim, cfg.rope_theta)
    elif cfg.rope_kind == "mrope":
        if positions3 is None:
            positions3 = positions[None].expand(3, *positions.shape)
        out["rope"] = mrope_tables(positions3, cfg.head_dim_,
                                   cfg.mrope_sections, cfg.rope_theta)
    return out


def attention_meshed(plan, p, cfg: ModelConfig, xs, tables, window: int,
                     kv_out: Optional[list] = None):
    """The training and prefill form of :func:`attention_apply` (no cache)
    over ``plan``'s mesh: ``xs`` has one tensor a data entry and
    ``tables`` its :func:`attention_tables` (the encoder's not causal),
    ``p`` the layer's sharded weights; returns the output of each data
    entry.  Explicit positions take :func:`_sdpa_masked`'s arithmetic;
    tables made with ``flash=True`` (positions ``arange(S)``) take the
    flash route where ``window != 0``, each (data, model) entry running
    :func:`_flash_prefill` on its own block of query heads, as the
    unmeshed :func:`attention_apply` takes it.

    Aligned query heads (``wq`` column-parallel): model entry ``m`` runs
    its own block of heads end to end and its row-parallel ``wo``
    partial is ``psum``-ed.  Its keys and values are its own block of KV
    heads when they are aligned too (a query block's KV heads are the
    same block of the KV heads), else the whole K and V, each the
    ``psum`` of the row-parallel partials over ``d_model``, normalised
    and rotated once, with each local query head's KV head picked out:
    no head is ever split.  Misaligned query heads: the whole attention
    once a data entry, then ``wo`` column-parallel over ``d_model``, its
    blocks gathered (:func:`_out_meshed`).

    ``kv_out`` (a list; the serving prefill's cache): each data entry's
    rotated keys and values are appended to it, one ``(K, V)`` a model
    entry, its own block of KV heads where they align, else the whole K
    and V (the same tensors on every model entry)."""
    from .layers import rotate

    cdt = cfg.cdtype
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q_split = plan.split_model(p["wq"]) == 1
    kv_split = plan.split_model(p["wk"]) == 1
    tp = plan.tp if q_split else 1
    h_l = h // tp
    outs = []
    for x, tab in zip(xs, tables):
        b, s, _ = x.shape
        x = x.to(cdt)
        flash = tab["flash"] and window != 0

        def heads(w, norm, m, n):
            t = _project(plan, x, p[w], m).reshape(b, s, n, hd)
            if cfg.qk_norm:
                t = rmsnorm(t, plan.local(p[norm]), cfg.norm_eps)
            return rotate(t, *tab["rope"]) if "rope" in tab else t

        if not kv_split:
            k_whole = heads("wk", "k_norm", 0, kv)
            v_whole = _project(plan, x, p["wv"], 0).reshape(b, s, kv, hd)
        parts, kvs = [], []
        for m in range(tp):
            q = heads("wq", "q_norm", m, h_l)
            if kv_split:
                kv_l = kv // plan.tp
                k = heads("wk", "k_norm", m, kv_l)
                v = _project(plan, x, p["wv"], m).reshape(b, s, kv_l, hd)
                kvs.append((k, v))
            else:
                kvs.append((k_whole, v_whole))
                k, v = k_whole, v_whole
                if tp > 1:
                    # each local query head's KV head, so they pair 1:1
                    pick = torch.arange(m * h_l, (m + 1) * h_l,
                                        device=x.device) // (h // kv)
                    k, v = k_whole[:, :, pick], v_whole[:, :, pick]
            if flash:
                out = _flash_prefill(q, k, v, window, tab["causal"])
            else:
                out = _sdpa_chunked(q, k, v, tab["positions"],
                                    tab["bias"][window])
            parts.append(out.reshape(b, s, h_l * hd).to(cdt))
        outs.append(_out_meshed(plan, p["wo"], parts, q_split, cdt))
        if kv_out is not None:
            kv_out.append(kvs)
    return outs


def _heads_whole(plan, x, w, split: bool, n: int, hd: int):
    """One data entry's projection to all ``n`` heads on every model entry
    (the decode rule: heads whole): where ``w`` is column-parallel each
    model entry's block of heads, gathered over ``model``; else
    :func:`_project`'s whole output."""
    from repro_torch.launch.mesh import all_gather

    b, s, _ = x.shape
    if not split:
        return _project(plan, x, w, 0).reshape(b, s, n, hd)
    rows = all_gather(plan.mesh, "model", [_project(plan, x, w, m)
                                           for m in range(plan.tp)])
    return rows.movedim(0, -2).reshape(b, s, n, hd)


def _seq_blocks(plan, cache_t, di: int):
    """The sequence blocks of a decode cache tensor (a ``ShardedTensor``
    of (B, S_max, ...), its batch over the plan's data axes or whole, its
    sequence over the axes of its spec's second entry) that data entry
    ``di`` reads, in sequence order: ``(first position, [its distinct
    block tensors])``, one a block; and those axes."""
    from repro_torch.dist.sharding import _entry_axes

    spec = tuple(cache_t.spec) + (None,) * 2
    if _entry_axes(spec[0]) != tuple(plan.data_axes):
        raise ValueError(f"a decode cache of spec {cache_t.spec!r} over "
                         f"the data axes {plan.data_axes}: lay it out by "
                         "cache_specs under the decode rules of its batch")
    found: dict = {}
    for i, blk in enumerate(cache_t.blocks):
        if plan.coords(i)[0] != di:
            continue
        lo = cache_t.sharding.block_slices(cache_t.shape, i)[1].start
        got = found.setdefault(lo, [])
        if all(blk is not t for t in got):
            got.append(blk)
    return sorted(found.items()), _entry_axes(spec[1])


def _decode_partial(qg, kb, vb, lo: int, pos: int, window: int, cdt):
    """The softmax over one block of cache positions ``[lo, lo + len)``
    for queries ``qg`` (B, 1, KV, G, D) at position ``pos``: the block's
    largest masked score ``m``, its sum of ``exp(s - m)`` and its
    unnormalised P·V, float32, each (B, KV, G, 1, ·).  The mask is
    :func:`attention_apply`'s decode mask on the global positions; a block
    wholly masked has ``m`` near ``NEG_INF``, which is finite, so its
    weight ``exp(m - M)`` in :func:`_lse_combine` underflows to 0."""
    f32 = torch.float32
    k_pos = torch.arange(lo, lo + kb.shape[1], device=kb.device)
    diff = pos - k_pos
    ok = diff >= 0
    if window >= 0:
        ok &= diff < max(window, 1)
    bias = torch.where(ok, 0.0, NEG_INF).to(f32)
    scale = 1.0 / math.sqrt(qg.shape[-1])
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(f32),
                          kb.to(cdt).to(f32)) * scale + bias
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", e.to(cdt).to(f32),
                       vb.to(cdt).to(f32))
    return m, e.sum(dim=-1, keepdim=True), acc


def _lse_combine(mesh, axes, parts):
    """The log-sum-exp combine of per-block softmax partials ``(m, l,
    acc)`` over the mesh ``axes`` they lie along (major-to-minor, the
    blocks in that order), innermost axis first: the largest ``m`` by a
    ``pmax``, each partial rescaled by ``exp(m_j - M)``, then ``psum``-ed.
    Returns the whole row's ``(M, L, ACC)``."""
    from repro_torch.launch.mesh import pmax, psum

    for a in reversed(axes):
        n = mesh.shape[a]
        nxt = []
        for i in range(0, len(parts), n):
            grp = parts[i:i + n]
            big = pmax(mesh, a, [m for m, _, _ in grp])
            w = [torch.exp(m - big.to(m.device)) for m, _, _ in grp]
            nxt.append((big, psum(mesh, a, [l * wj for (_, l, _), wj
                                            in zip(grp, w)]),
                        psum(mesh, a, [acc * wj for (_, _, acc), wj
                                       in zip(grp, w)])))
        parts = nxt
    if len(parts) != 1:
        raise ValueError(f"{len(parts)} partials left after combining "
                         f"over {axes}")
    return parts[0]


def attention_decode_meshed(plan, p, cfg: ModelConfig, xs, tables,
                            window: int, cache, cache_pos: int):
    """The decode form of :func:`attention_apply` over ``plan``'s mesh, by
    the reference's decode rules: one token, heads whole, K and V
    sequence-sharded.  ``cache`` is the layer's (K, V), each a
    ``ShardedTensor`` of (B, S_max, KV, D) laid out by ``cache_specs``;
    ``xs`` holds each data entry's (B_d, 1, d) rows and ``tables`` their
    rotation tables at ``cache_pos``.

    Each model entry gets all heads of q and of the new K and V (its
    column block, gathered over ``model``; a row-parallel projection is
    ``psum``-ed whole).  The new K and V are written in place into the
    block that owns ``cache_pos``, on that entry alone.  Each entry then
    takes the softmax over its block of positions
    (:func:`_decode_partial`), and the partials are combined over the
    sequence's axes by log-sum-exp (:func:`_lse_combine`): the result is
    :func:`_sdpa` over the whole cache, in another summation order.
    Under the batch fallback the sequence lies over the data entries too,
    and every entry's block takes part.  The output projection is
    :func:`_out_meshed`'s."""
    from .layers import rotate

    cdt = cfg.cdtype
    ck, cv = cache
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q_split = plan.split_model(p["wq"]) == 1
    kv_split = plan.split_model(p["wk"]) == 1
    h_l = h // plan.tp if q_split else h
    outs = []
    for di, (x, tab) in enumerate(zip(xs, tables)):
        b = x.shape[0]
        x = x.to(cdt)
        q = _heads_whole(plan, x, p["wq"], q_split, h, hd)
        k = _heads_whole(plan, x, p["wk"], kv_split, kv, hd)
        v = _heads_whole(plan, x, p["wv"], kv_split, kv, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, plan.local(p["q_norm"]), cfg.norm_eps)
            k = rmsnorm(k, plan.local(p["k_norm"]), cfg.norm_eps)
        if "rope" in tab:
            q, k = rotate(q, *tab["rope"]), rotate(k, *tab["rope"])
        k_blocks, axes = _seq_blocks(plan, ck, di)
        v_blocks, _ = _seq_blocks(plan, cv, di)
        qg = q.reshape(b, 1, kv, h // kv, hd)
        partials = []
        for (lo, kbs), (_, vbs) in zip(k_blocks, v_blocks):
            _write_at(kbs, lo, cache_pos, k)
            _write_at(vbs, lo, cache_pos, v)
            partials.append(_decode_partial(qg, kbs[0], vbs[0], lo,
                                            cache_pos, window, cdt))
        _, tot, acc = _lse_combine(plan.mesh, axes, partials)
        out = (acc / tot).permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
        parts = [out[:, :, m * h_l:(m + 1) * h_l].reshape(b, 1, h_l * hd)
                 .to(cdt) for m in range(plan.tp if q_split else 1)]
        outs.append(_out_meshed(plan, p["wo"], parts, q_split, cdt))
    return outs


def mla_meshed(plan, p, cfg: ModelConfig, xs, tables, window: int,
               kv_out: Optional[list] = None):
    """The training and prefill form of :func:`mla_apply` (no cache) over
    ``plan``'s mesh, as :func:`attention_meshed` takes its arguments.
    Explicit positions take :func:`_sdpa_masked`'s arithmetic at q·k
    ``nope + rope`` and P·V ``v_head_dim``; tables made with
    ``flash=True`` take the flash route where ``window != 0``, each (data,
    model) entry running :func:`_flash_prefill` on its own heads, the
    values zero-padded to q's width, as :func:`mla_apply` takes it.  The
    latent ``c_kv`` and the rotary key are whole on every model entry:
    ``w_dkv`` and ``w_krope`` fall to the generic 2-D rule (``d_model``
    over ``model``), so their row-parallel partials are ``psum``-ed, and
    ``kv_norm`` normalises the whole latent.  Aligned heads: ``wq`` and
    the up-projections ``w_uk`` / ``w_uv`` are column-parallel, so model
    entry ``m`` expands only its own heads' keys and values, and ``wo``
    is row-parallel and ``psum``-ed.  Misaligned heads: the whole MLA
    once a data entry on the gathered up-projections, then ``wo`` as
    :func:`_out_meshed` takes it.

    ``kv_out`` (a list; the serving prefill's cache): each data entry's
    ``(c_kv, k_rope)``, (B, S, r) and (B, S, rope), is appended to it."""
    from .layers import rotate

    cdt = cfg.cdtype
    mc = cfg.mla
    nope, rope, dv = mc.nope_head_dim, mc.rope_head_dim, mc.v_head_dim
    q_split = plan.split_model(p["wq"]) == 1
    tp = plan.tp if q_split else 1
    h_l = cfg.n_heads // tp
    if q_split:
        w_uk = [plan.local(p["w_uk"], m, cdt) for m in range(tp)]
        w_uv = [plan.local(p["w_uv"], m, cdt) for m in range(tp)]
    else:
        w_uk, w_uv = [plan.whole(p["w_uk"], cdt)], [plan.whole(p["w_uv"], cdt)]
    kv_norm = plan.local(p["kv_norm"])
    outs = []
    for x, tab in zip(xs, tables):
        b, s, _ = x.shape
        x = x.to(cdt)
        flash = tab["flash"] and window != 0
        c_kv = rmsnorm(_project(plan, x, p["w_dkv"], 0), kv_norm,
                       cfg.norm_eps)
        k_rope = rotate(_project(plan, x, p["w_krope"], 0)[:, :, None],
                        *tab["rope"])                      # (B, S, 1, rope)
        parts = []
        for m in range(tp):
            q = _project(plan, x, p["wq"], m).reshape(b, s, h_l, nope + rope)
            q_full = torch.cat([q[..., :nope],
                                rotate(q[..., nope:], *tab["rope"])], dim=-1)
            k_nope = (c_kv @ w_uk[m]).reshape(b, s, h_l, nope)
            val = (c_kv @ w_uv[m]).reshape(b, s, h_l, dv)
            k_full = torch.cat([k_nope, k_rope.expand(b, s, h_l, rope)],
                               dim=-1)
            if flash:
                out = _flash_prefill(q_full, k_full, val, window, True)
            else:
                out = _sdpa_chunked(q_full, k_full, val, tab["positions"],
                                    tab["bias"][window])
            parts.append(out.reshape(b, s, h_l * dv).to(cdt))
        outs.append(_out_meshed(plan, p["wo"], parts, q_split, cdt))
        if kv_out is not None:
            kv_out.append((c_kv, k_rope[:, :, 0]))
    return outs


def _write_at(blocks, lo: int, pos: int, new: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) at global position ``pos`` into each of
    ``blocks`` (one sequence block's tensors, from ``lo``) when the block
    holds ``pos``."""
    if lo <= pos < lo + blocks[0].shape[1]:
        for t in blocks:
            t[:, pos - lo:pos - lo + 1] = new.to(t.dtype)


def _mla_partial(q_lat, q_rope, cb, kb, lo: int, pos: int, window: int,
                 scale: float, cdt):
    """:func:`_decode_partial` for MLA's absorbed decode: the softmax over
    one block of latent cache positions ``[lo, lo + len)`` for the
    absorbed queries ``q_lat`` (B, 1, H, r) and rotary queries ``q_rope``
    (B, 1, H, rope), scored as ``q_lat·c + q_rope·k_rope`` in float32
    (:func:`mla_apply`'s decode) against the block's ``c_kv`` ``cb`` (B,
    L, r) and rotary keys ``kb`` (B, L, rope).  Returns the block's
    largest masked score, its sum of ``exp(s - m)``, each (B, H, 1, 1),
    and its unnormalised P·c (B, H, 1, r), float32."""
    f32 = torch.float32
    c = cb.to(cdt).to(f32)
    k_pos = torch.arange(lo, lo + cb.shape[1], device=cb.device)
    ok = k_pos <= pos
    if window >= 0:
        ok &= pos - k_pos < max(window, 1)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.to(f32), c)
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32),
                             kb.to(cdt).to(f32))) * scale
    scores = torch.where(ok, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    acc = torch.einsum("bhqk,bkr->bhqr", e.to(cdt).to(f32), c)
    return m, e.sum(dim=-1, keepdim=True), acc


def mla_decode_meshed(plan, p, cfg: ModelConfig, xs, tables, window: int,
                      cache, cache_pos: int):
    """The absorbed decode of :func:`mla_apply` over ``plan``'s mesh, by
    the reference's decode rules: one token, heads whole, the latent cache
    sequence-sharded.  ``cache`` is the layer's ``(c_kv, k_rope)``, each a
    ``ShardedTensor`` of (B, S_max, r) and (B, S_max, rope) laid out by
    ``cache_specs``; ``xs`` and ``tables`` as
    :func:`attention_decode_meshed` takes them.

    Every model entry gets all heads of q (its column block of ``wq``,
    gathered over ``model``), the whole new latent and rotary key (the
    ``psum`` of the row-parallel partials, as :func:`mla_meshed`) and
    the absorbed ``q_nope W_uk^T`` over the gathered ``w_uk``, rounded to
    the compute dtype.  The new ``c_kv`` and rotary key are written in
    place into the block that owns ``cache_pos``.  Each block gives its
    masked maximum, its sum of exponentials and its unnormalised P·c in
    float32 (:func:`_mla_partial`); :func:`_lse_combine` merges them over
    the sequence's axes.  Then each model entry's heads of the latent
    output, rounded to the compute dtype, times its heads of ``w_uv``
    (the whole of it where the heads do not split), and ``wo`` as
    :func:`_out_meshed` takes it."""
    from .layers import rotate

    cdt = cfg.cdtype
    mc = cfg.mla
    h = cfg.n_heads
    nope, rope, dv = mc.nope_head_dim, mc.rope_head_dim, mc.v_head_dim
    r = mc.kv_lora_rank
    scale = 1.0 / math.sqrt(nope + rope)
    c_cache, kr_cache = cache
    q_split = plan.split_model(p["wq"]) == 1
    tp = plan.tp if q_split else 1
    h_l = h // tp
    w_uk = plan.whole(p["w_uk"], cdt).reshape(r, h, nope)
    w_uv = [plan.local(p["w_uv"], m, cdt) for m in range(tp)] if q_split \
        else [plan.whole(p["w_uv"], cdt)]
    kv_norm = plan.local(p["kv_norm"])
    outs = []
    for di, (x, tab) in enumerate(zip(xs, tables)):
        b = x.shape[0]
        x = x.to(cdt)
        q = _heads_whole(plan, x, p["wq"], q_split, h, nope + rope)
        q_nope, q_rope = q[..., :nope], rotate(q[..., nope:], *tab["rope"])
        c_kv = rmsnorm(_project(plan, x, p["w_dkv"], 0), kv_norm,
                       cfg.norm_eps)                        # (B, 1, r)
        k_rope = rotate(_project(plan, x, p["w_krope"], 0)[:, :, None],
                        *tab["rope"])[:, :, 0]              # (B, 1, rope)
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)   # cdt
        c_blocks, axes = _seq_blocks(plan, c_cache, di)
        kr_blocks, _ = _seq_blocks(plan, kr_cache, di)
        partials = []
        for (lo, cbs), (_, kbs) in zip(c_blocks, kr_blocks):
            _write_at(cbs, lo, cache_pos, c_kv)
            _write_at(kbs, lo, cache_pos, k_rope)
            partials.append(_mla_partial(q_lat, q_rope, cbs[0], kbs[0], lo,
                                         cache_pos, window, scale, cdt))
        _, tot, acc = _lse_combine(plan.mesh, axes, partials)
        lat = (acc / tot).permute(0, 2, 1, 3).to(cdt)       # (B, 1, H, r)
        parts = [torch.einsum(
            "bqhr,rhv->bqhv", lat[:, :, m * h_l:(m + 1) * h_l],
            w_uv[m].reshape(r, h_l, dv)).reshape(b, 1, h_l * dv).to(cdt)
            for m in range(tp)]
        outs.append(_out_meshed(plan, p["wo"], parts, q_split, cdt))
    return outs


def _data_block(plan, st, di: int) -> torch.Tensor:
    """Data entry ``di``'s block of ``st``, a ``ShardedTensor`` whose batch
    (axis 0) lies over the plan's data axes, or is whole under the batch
    fallback, and whose other axes are whole: a recurrent state or a
    cross-attention K/V of the decode cache (``cache_specs``)."""
    from repro_torch.dist.sharding import _entry_axes

    spec = tuple(st.spec) + (None,)
    if _entry_axes(spec[0]) != tuple(plan.data_axes) or any(
            a is not None for a in spec[1:]):
        raise ValueError(f"a decode cache tensor of spec {st.spec!r} over "
                         f"the data axes {plan.data_axes}: lay it out by "
                         "cache_specs under the decode rules of its batch")
    return st.blocks[plan.entry(di)]


def cross_attention_meshed(plan, p, cfg: ModelConfig, xs, enc_outs,
                           kv_out: Optional[list] = None, cache=None):
    """:func:`cross_attention_apply` over ``plan``'s mesh: data entry
    ``d``'s decoder rows ``xs[d]`` attend to its own encoder output
    ``enc_outs[d]``, unmasked.  ``wq``, ``wk``, ``wv`` and ``wo`` follow
    the head rules of self-attention: aligned, model entry ``m``
    projects, attends and out-projects its own heads (the ``wo`` partials
    ``psum``-ed); where ``wk`` is not column-parallel (it is then
    row-parallel on ``d_model``) K and V are whole (``psum``-ed partials)
    and each model entry picks its heads; misaligned, the whole attention
    once a data entry (:func:`_out_meshed`).

    ``kv_out`` (a list; the serving prefill's cache): each data entry's
    K and V are appended to it, one ``(xK, xV)`` a model entry, its own
    heads where they split, else the whole K and V once.  ``cache`` (the
    decode form): the layer's ``(xK, xV)``, ``ShardedTensor``s of (B,
    S_enc, H, D) with the batch over the data axes and the rest whole
    (``cache_specs``); each data entry attends to its own block, at the
    encoder's length, never padded, and ``enc_outs`` is not read."""
    cdt = cfg.cdtype
    h, hd = cfg.n_heads, cfg.head_dim_
    q_split = plan.split_model(p["wq"]) == 1
    kv_split = cache is None and q_split and plan.split_model(p["wk"]) == 1
    tp = plan.tp if q_split else 1
    h_l = h // tp
    outs = []
    for di, x in enumerate(xs):
        b, s, _ = x.shape
        x = x.to(cdt)
        if cache is not None:
            k_whole, v_whole = (_data_block(plan, t, di).to(cdt)
                                for t in cache)
            se = k_whole.shape[1]
        else:
            e = enc_outs[di].to(cdt)
            se = e.shape[1]
            if not kv_split:
                k_whole = _project(plan, e, p["wk"], 0).reshape(b, se, h, hd)
                v_whole = _project(plan, e, p["wv"], 0).reshape(b, se, h, hd)
        q_pos = torch.zeros((b, s), dtype=torch.int64, device=x.device)
        k_pos = torch.zeros((se,), dtype=torch.int64, device=x.device)
        parts, kvs = [], []
        for m in range(tp):
            q = _project(plan, x, p["wq"], m).reshape(b, s, h_l, hd)
            if kv_split:
                k = _project(plan, e, p["wk"], m).reshape(b, se, h_l, hd)
                v = _project(plan, e, p["wv"], m).reshape(b, se, h_l, hd)
                kvs.append((k, v))
            else:
                heads = slice(m * h_l, (m + 1) * h_l)
                k, v = k_whole[:, :, heads], v_whole[:, :, heads]
            out = _sdpa_masked(q, k, v, q_pos, k_pos, -1, causal=False)
            parts.append(out.reshape(b, s, h_l * hd).to(cdt))
        outs.append(_out_meshed(plan, p["wo"], parts, q_split, cdt))
        if kv_out is not None:
            kv_out.append(kvs if kv_split else [(k_whole, v_whole)])
    return outs
