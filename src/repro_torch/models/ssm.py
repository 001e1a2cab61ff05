"""Recurrent blocks: xLSTM (mLSTM + sLSTM) and RG-LRU (RecurrentGemma).

Port of ``src/repro/models/ssm.py``.  The reference computes these blocks
in ``jnp``, outside any Pallas kernel, so the port is plain PyTorch and
launches no kernel of its own:

* **mLSTM**, chunkwise-parallel: within a chunk the matrix-memory
  recurrence is a decay-masked attention (batched products); across
  chunks the (nh, hd, hd) state is carried by a loop over the chunks (the
  reference's ``lax.scan``).  The reference's arithmetic is copied as it
  is, including two places where its sequence form disagrees with its own
  decode form (ROADMAP.md §3, "Reference fault, kept in the port"): the
  intra-chunk scores alone are scaled by ``1/sqrt(hd)``, and the
  intra-chunk normaliser weights k by ``scores·D`` where the decode step's
  ``n = f·n + i·k`` has ``D`` alone.  So its output depends on the chunk
  length, as the reference's does.
* **sLSTM**, the scalar-memory recurrence with block-diagonal per-head
  recurrent weights: a loop over time (the reference's ``lax.scan``),
  about 20 launches a step.
* **RG-LRU**, a per-channel gated linear recurrence with the Griffin
  block around it.  The reference's ``jax.lax.associative_scan`` becomes
  :func:`_linear_scan`, a Hillis–Steele scan of ``ceil(log2 S)`` doubling
  steps in torch ops; its order of association differs from XLA's, so it
  agrees to rounding, not bit for bit.

Each block has a sequence form (``cache=None``) and a one-token decode
form (``cache`` given, a tuple of state tensors); both return ``(x,
new_cache)`` and the decode state is returned new, never written in place.
Parameters keep the reference's flat layout (``*_params``; its
``{"scale": ...}`` norms are the scale tensors ``norm`` and
``out_norm``), drawn as ``attn_params`` draws them; the recurrent gate
weights, ``b_f``, ``b`` and ``lam`` are float32 whatever ``param_dtype``
says.  :class:`MLSTM`, :class:`SLSTM` and :class:`RGLRU` hold one layer's
weights, as ``Attention`` does.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _param, dense_init, rmsnorm

I_CLIP = 5.0


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, d); w: (cw, d).  state: (B, cw-1,
    d), the trailing inputs for decode.  Returns (out, new_state); the new
    state is a copy, so it does not hold ``x`` alive in a cache."""
    cw = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(cw))
    new_state = xp[:, -(cw - 1):, :].clone() if cw > 1 else pad
    return out, new_state


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = int(cfg.d_model * cfg.xlstm.proj_factor)
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None) -> dict:
    """Seeded init in the reference's layout: ``w_up`` (d, 2·di), the
    conv ``conv_w`` (cw, di), ``wq``/``wk``/``wv`` (di, di), the float32
    gates ``w_i``/``w_f`` (di, nh) and ``b_f`` (nh,) at 3.0 (open forget
    gates), ``w_down`` (di, d), and the norms ``norm`` (d) and
    ``out_norm`` (di)."""
    d = cfg.d_model
    xc = cfg.xlstm
    di, nh, _ = _mlstm_dims(cfg)
    kw = dict(dtype=cfg.pdtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.ones(d, **kw),
        "w_up": dense_init(gen, (d, 2 * di), **kw),
        "conv_w": dense_init(gen, (xc.conv_width, di), fan_in=xc.conv_width,
                             **kw),
        "wq": dense_init(gen, (di, di), **kw),
        "wk": dense_init(gen, (di, di), **kw),
        "wv": dense_init(gen, (di, di), **kw),
        "w_i": dense_init(gen, (di, nh), **f32),
        "w_f": dense_init(gen, (di, nh), **f32),
        "b_f": torch.full((nh,), 3.0, **f32),
        "out_norm": torch.ones(di, **kw),
        "w_down": dense_init(gen, (di, d), fan_in=di, **kw),
    }


def _mlstm_chunk(q, k, v, log_i, log_f, state):
    """One chunk, in float32.  q, k, v: (B, L, nh, hd); log_i, log_f: (B,
    L, nh).  state: (C (B, nh, hd, hd), n (B, nh, hd)).  Returns (h,
    new_state)."""
    b, L, nh, hd = q.shape
    C_prev, n_prev = state
    Fc = torch.cumsum(log_f, dim=1)                   # (B, L, nh), <= 0
    # intra-chunk decay matrix D[i,j] = exp(F_i - F_j + log_i_j), j <= i
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    idx = torch.arange(L, device=q.device)
    mask = (idx[:, None] >= idx[None, :])[None, :, :, None]
    D = torch.where(mask, torch.exp(torch.clamp_max(logD, 30.0)), 0.0)
    scores = torch.einsum("bihd,bjhd->bijh", q, k) / math.sqrt(hd)
    sd = scores * D
    h_intra = torch.einsum("bijh,bjhd->bihd", sd, v)
    n_intra = torch.einsum("bijh,bjhd->bihd", sd, k)
    # inter-chunk contribution
    qd = q * torch.exp(Fc)[..., None]
    h_inter = torch.einsum("bihd,bhde->bihe", qd, C_prev)
    n_inter = torch.einsum("bihd,bhd->bih", qd, n_prev)     # (B, L, nh)
    den = torch.abs(torch.einsum("bihd,bihd->bih", q, n_intra)
                    + n_inter)[..., None]
    h = (h_intra + h_inter) / torch.clamp_min(den, 1.0)
    # state update
    F_L = Fc[:, -1:, :]                               # (B, 1, nh)
    kd = k * torch.exp(torch.clamp_max(F_L - Fc + log_i, 30.0))[..., None]
    C_new = torch.exp(F_L[:, 0, :, None, None]) * C_prev + torch.einsum(
        "bjhd,bjhe->bhde", kd, v)
    n_new = torch.exp(F_L[:, 0, :, None]) * n_prev + torch.sum(kd, dim=1)
    return h, (C_new, n_new)


def mlstm_apply(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, cache=None):
    """Sequence (chunkwise; ``S`` a multiple of ``min(chunk, S)``) or
    decode-step (``cache`` given: ``(C, n, conv)``, x of one token) mLSTM
    block.  Returns ``(x + out, (C, n, conv))``."""
    cdt = cfg.cdtype
    b, s, d = x.shape
    di, nh, hd = _mlstm_dims(cfg)
    res = x
    xn = rmsnorm(x.to(cdt), params["norm"], cfg.norm_eps)
    up = xn @ params["w_up"].to(cdt)
    xm, z = torch.chunk(up, 2, dim=-1)
    conv_state = None if cache is None else cache[2]
    xc_out, new_conv = _causal_conv(xm, params["conv_w"].to(cdt),
                                    conv_state)
    xc_act = F.silu(xc_out)
    q = (xc_act @ params["wq"].to(cdt)).reshape(b, s, nh, hd)
    k = (xc_act @ params["wk"].to(cdt)).reshape(b, s, nh, hd)
    v = (xm @ params["wv"].to(cdt)).reshape(b, s, nh, hd)
    xf = xm.float()
    log_i = torch.clamp_max(xf @ params["w_i"], I_CLIP)
    log_f = F.logsigmoid(xf @ params["w_f"] + params["b_f"])

    q32, k32, v32 = q.float(), k.float(), v.float()
    if cache is None:
        L = min(cfg.xlstm.chunk, s)
        if s % L:
            raise ValueError(f"mlstm_apply: sequence length S = {s} is not "
                             f"a multiple of the chunk {L}")
        C = q32.new_zeros((b, nh, hd, hd))
        n = q32.new_zeros((b, nh, hd))
        hs = []
        for c0 in range(0, s, L):
            sl = slice(c0, c0 + L)
            h_c, (C, n) = _mlstm_chunk(q32[:, sl], k32[:, sl], v32[:, sl],
                                       log_i[:, sl], log_f[:, sl], (C, n))
            hs.append(h_c)
        h = torch.cat(hs, dim=1)
        new_cache = (C, n, new_conv)
    else:
        C_prev, n_prev = cache[0], cache[1]
        i_t = torch.exp(log_i[:, 0])                  # (B, nh)
        f_t = torch.exp(log_f[:, 0])
        kv = torch.einsum("bhd,bhe->bhde", k32[:, 0], v32[:, 0])
        C_new = f_t[..., None, None] * C_prev + i_t[..., None, None] * kv
        n_new = f_t[..., None] * n_prev + i_t[..., None] * k32[:, 0]
        num = torch.einsum("bhd,bhde->bhe", q32[:, 0], C_new)
        den = torch.abs(torch.einsum("bhd,bhd->bh", q32[:, 0],
                                     n_new))[..., None]
        h = (num / torch.clamp_min(den, 1.0))[:, None].reshape(b, s, nh, hd)
        new_cache = (C_new, n_new, new_conv)

    h = h.reshape(b, s, di).to(cdt)
    h = rmsnorm(h, params["out_norm"], cfg.norm_eps)
    out = (h * F.silu(z)) @ params["w_down"].to(cdt)
    return res + out.to(res.dtype), new_cache


def mlstm_init_cache(cfg: ModelConfig, batch: int, device=None):
    """Zero decode state: C (B, nh, hd, hd) and n (B, nh, hd) in float32,
    the conv's trailing inputs (B, cw-1, di) in the compute dtype."""
    di, nh, hd = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, nh, hd, hd), **f32),
            torch.zeros((batch, nh, hd), **f32),
            torch.zeros((batch, cfg.xlstm.conv_width - 1, di),
                        dtype=cfg.cdtype, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None) -> dict:
    """Seeded init in the reference's layout: ``w`` (d, 4d), the per-head
    recurrent weights ``r`` (nh, hd, 4·hd), the float32 bias ``b`` (4d,)
    at 0, ``w_out`` (d, d) and the norm ``norm`` (d)."""
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    kw = dict(dtype=cfg.pdtype, device=device)
    return {
        "norm": torch.ones(d, **kw),
        "w": dense_init(gen, (d, 4 * d), **kw),
        "r": dense_init(gen, (nh, hd, 4 * hd), fan_in=hd, **kw),
        "b": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "w_out": dense_init(gen, (d, d), **kw),
    }


def _slstm_cell(params_r, gates_x, state, nh: int, hd: int):
    """gates_x: (B, 4d), the precomputed ``W x_t + b``; state: (c, n, h),
    each (B, nh, hd).  The gates split per head: (B, nh, 4·hd) into i, f,
    z, o."""
    c, n, h = state
    rec = torch.einsum("bhd,hdg->bhg", h, params_r)   # (B, nh, 4hd)
    g = gates_x.reshape(-1, nh, 4 * hd) + rec
    i_r, f_r, z_r, o_r = torch.chunk(g, 4, dim=-1)
    i = torch.exp(torch.clamp_max(i_r, I_CLIP))
    f = torch.sigmoid(f_r + 1.0)
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    c = f * c + i * z
    n = f * n + i
    h = o * (c / torch.clamp_min(torch.abs(n), 1.0))
    return c, n, h


def slstm_apply(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, cache=None):
    """Sequence (a loop over time) or decode-step sLSTM block; ``cache``
    is ``(c, n, h)``.  Returns ``(x + out, (c, n, h))``."""
    cdt = cfg.cdtype
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    res = x
    xn = rmsnorm(x.to(cdt), params["norm"], cfg.norm_eps)
    gates_x = (xn @ params["w"].to(cdt)).float() + params["b"]
    if cache is None:
        state = tuple(gates_x.new_zeros((b, nh, hd)) for _ in range(3))
    else:
        state = tuple(cache)
    r32 = params["r"].float()

    if s == 1:
        state = _slstm_cell(r32, gates_x[:, 0], state, nh, hd)
        hs = state[2][:, None]
    else:
        steps = []
        for t in range(s):
            state = _slstm_cell(r32, gates_x[:, t], state, nh, hd)
            steps.append(state[2])
        hs = torch.stack(steps, dim=1)
    out = hs.reshape(b, s, d).to(cdt) @ params["w_out"].to(cdt)
    return res + out.to(res.dtype), state


def slstm_init_cache(cfg: ModelConfig, batch: int, device=None):
    """Zero decode state: (c, n, h), each (B, nh, hd) float32."""
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return tuple(torch.zeros((batch, nh, hd), dtype=torch.float32,
                             device=device) for _ in range(3))


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

def rglru_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                 device=None) -> dict:
    """Seeded init in the reference's layout: the branch ``w_x`` and gate
    ``w_gate`` (d, dr), the conv ``conv_w`` (cw, dr), the float32 gates
    ``w_a``/``w_i`` (dr, dr) and ``lam`` (dr,) at 2.0, ``w_down`` (dr,
    d) and the norm ``norm`` (d); ``dr = d_rnn or d_model``."""
    d = cfg.d_model
    dr = cfg.rglru.d_rnn or d
    kw = dict(dtype=cfg.pdtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": torch.ones(d, **kw),
        "w_x": dense_init(gen, (d, dr), **kw),
        "w_gate": dense_init(gen, (d, dr), **kw),
        "conv_w": dense_init(gen, (cfg.rglru.conv_width, dr),
                             fan_in=cfg.rglru.conv_width, **kw),
        "w_a": dense_init(gen, (dr, dr), **f32),
        "w_i": dense_init(gen, (dr, dr), **f32),
        "lam": torch.full((dr,), 2.0, **f32),         # sigmoid(2) ~ 0.88
        "w_down": dense_init(gen, (dr, d), fan_in=dr, **kw),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_(t-1) + b_t`` from ``h_(-1) = 0`` along axis 1: a
    Hillis–Steele scan under ``(a, b) ∘ (a', b') = (a·a', a'·b + b')``,
    ``ceil(log2 S)`` doubling steps of a few whole-tensor ops each."""
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        if 2 * k < s:
            a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def rglru_apply(params: Mapping[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor, cache=None):
    """Griffin recurrent block: conv + RG-LRU branch gated by a GeLU (tanh
    form, ``jax.nn.gelu``'s default) branch.  ``cache`` is ``(h, conv)``.
    Returns ``(x + out, (h_last, conv))``."""
    cdt = cfg.cdtype
    res = x
    xn = rmsnorm(x.to(cdt), params["norm"], cfg.norm_eps)
    branch = xn @ params["w_x"].to(cdt)
    gate = F.gelu(xn @ params["w_gate"].to(cdt), approximate="tanh")
    conv_state = None if cache is None else cache[1]
    u, new_conv = _causal_conv(branch, params["conv_w"].to(cdt), conv_state)
    uf = u.float()
    log_a_max = 8.0 * F.logsigmoid(params["lam"])          # (dr,), < 0
    r = torch.sigmoid(uf @ params["w_a"])
    i = torch.sigmoid(uf @ params["w_i"])
    a = torch.exp(r * log_a_max[None, None, :])
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-8)) * (i * uf)

    if cache is None:
        h = _linear_scan(a, gated_x)
        h_last = h[:, -1].clone()        # not a view that holds h alive
    else:
        h_last = a[:, 0] * cache[0] + gated_x[:, 0]
        h = h_last[:, None]
    out = (h.to(cdt) * gate) @ params["w_down"].to(cdt)
    return res + out.to(res.dtype), (h_last, new_conv)


def rglru_init_cache(cfg: ModelConfig, batch: int, device=None):
    """Zero decode state: h (B, dr) float32 and the conv's trailing inputs
    (B, cw-1, dr) in the compute dtype."""
    dr = cfg.rglru.d_rnn or cfg.d_model
    return (torch.zeros((batch, dr), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.rglru.conv_width - 1, dr),
                        dtype=cfg.cdtype, device=device))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _Recurrent(nn.Module):
    """Holds one layer's weights (the flat ``*_params`` layout) and
    applies the block's function."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({name: _param(t) for name, t in p.items()})

    def forward(self, x, cache=None):
        return type(self).apply_fn(self.p, self.cfg, x, cache)


class MLSTM(_Recurrent):
    apply_fn = staticmethod(mlstm_apply)


class SLSTM(_Recurrent):
    apply_fn = staticmethod(slstm_apply)


class RGLRU(_Recurrent):
    apply_fn = staticmethod(rglru_apply)
