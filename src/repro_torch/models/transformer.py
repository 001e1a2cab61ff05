"""Model assembly: the layer plan, the ``Transformer`` module, forward and
decode.

Port of ``src/repro/models/transformer.py`` for the dense decoder.  Where
the reference scans one stacked parameter group over its repeats, the port
holds an ``nn.ModuleList`` of blocks, each with its own window int (the
reference's per-repeat window scalar).  Entry points:

* :func:`init_params` — seeded init on the card (``device=None``) or the
  CPU, returning the module;
* :func:`params_from_arrays` — the module from the reference's parameter
  tree as numpy arrays (``jax.tree.map(np.asarray, params)``): a copy, no
  transpose, since both keep ``(in, out)`` weights;
  :func:`params_to_arrays` the other way, and :func:`arrays_from_named` /
  :func:`named_from_arrays` for any tree that mirrors the parameters (the
  optimizer's moments, gradients) and :func:`load_arrays_` to copy such a
  tree into tensors in place;
* :func:`forward` — tokens -> float32 logits (+ per-layer ``(K, V)`` with
  ``return_caches``), the training forward too, with ``cfg.remat``'s
  activation checkpointing per block under autograd;
* :func:`decode_step` — one token against the fixed-capacity cache.

MoE, MLA, the recurrent blocks, enc-dec, M-RoPE and embedding inputs raise
``NotImplementedError`` (ROADMAP.md §1, item 10).  The trainer
(``repro_torch.train``) differentiates :func:`forward` with explicit
positions, which take ``_sdpa_masked`` as the reference's training forward
does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device, to_host

from .attention import Attention, attn_params
from .config import ModelConfig
from .layers import MLP, RMSNorm, _param, dense_init, embed, unembed

_NOT_PORTED = "not ported yet (ROADMAP.md §1, item 10, LM substrate)"


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    parts: Tuple[Tuple[str, int], ...]      # ((kind, count), ...)
    repeats: int
    windows: Optional[np.ndarray] = None    # (repeats, n_instances) int32
    d_ff_override: int = 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    missing = [what for what, has in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("xlstm", cfg.xlstm is not None), ("rglru", cfg.rglru is not None),
        ("enc_dec", cfg.enc_dec), ('rope_kind="mrope"',
                                   cfg.rope_kind == "mrope"),
        ('input_kind="embeddings"', cfg.input_kind != "tokens")) if has]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} "
                                  f"{_NOT_PORTED}")


def build_plan(cfg: ModelConfig) -> List[GroupSpec]:
    """The dense branch of the reference's plan: one group of
    ``attn_mlp`` blocks with per-layer windows."""
    check_supported(cfg)
    win = np.array([[cfg.window_for_layer(i)] for i in range(cfg.n_layers)],
                   dtype=np.int32)
    return [GroupSpec("blocks", (("attn_mlp", 1),), cfg.n_layers,
                      windows=win)]


class Block(nn.Module):
    """Pre-norm attention + MLP, with this layer's window."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any], window: int):
        super().__init__()
        self.window = int(window)
        self.ln1 = RMSNorm(p["ln1"], cfg.norm_eps)
        self.attn = Attention(cfg, p["attn"])
        self.ln2 = RMSNorm(p["ln2"], cfg.norm_eps)
        self.ffn = MLP(p["ffn"], cfg.cdtype)
        self.cdtype = cfg.cdtype

    def forward(self, x, positions, cache=None, cache_pos=None):
        h = self.ln1(x.to(self.cdtype))
        a_out, new_cache = self.attn(h, positions, self.window, cache=cache,
                                     cache_pos=cache_pos)
        x = x + a_out.to(x.dtype)
        h = self.ln2(x.to(self.cdtype))
        return x + self.ffn(h).to(x.dtype), new_cache


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any]):
        super().__init__()
        plan = build_plan(cfg)
        self.cfg = cfg
        self.embed = _param(p["embed"])
        self.final_norm = RMSNorm(p["final_norm"], cfg.norm_eps)
        self.lm_head = _param(p["lm_head"]) if "lm_head" in p else None
        windows = plan[0].windows[:, 0]
        self.blocks = nn.ModuleList(
            Block(cfg, bp, w) for bp, w in zip(p["blocks"], windows))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _block_init(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device)
    ffn = {"w_up": dense_init(gen, (cfg.d_model, cfg.d_ff), **kw),
           "w_down": dense_init(gen, (cfg.d_ff, cfg.d_model), **kw)}
    if cfg.act in ("silu", "swiglu"):
        ffn["w_gate"] = dense_init(gen, (cfg.d_model, cfg.d_ff), **kw)
    return {"ln1": torch.ones(cfg.d_model, **kw),
            "attn": attn_params(cfg, gen, device),
            "ln2": torch.ones(cfg.d_model, **kw), "ffn": ffn}


def _param_tree(cfg: ModelConfig, gen: Optional[torch.Generator],
                device) -> Dict[str, Any]:
    """The module's parameters as ``Transformer`` takes them, drawn from
    ``gen`` (``None`` on the meta device, where nothing is drawn)."""
    kw = dict(dtype=cfg.pdtype, device=device)
    p: Dict[str, Any] = {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model), fan_in=1,
                            **kw),
        "final_norm": torch.ones(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.padded_vocab, cfg.d_model), **kw)
    p["blocks"] = [_block_init(cfg, gen, device)
                   for _ in range(cfg.n_layers)]
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Seeded random init (an explicit ``torch.Generator`` on the target
    device; its numbers are not ``jax.random``'s)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, _param_tree(cfg, gen, dev))


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device: DeviceLike = None) -> Transformer:
    """The module from the reference's params as numpy arrays: ``embed``,
    ``final_norm``, optional ``lm_head`` and ``groups[0]["attn_mlp_0"]``
    stacked on a leading ``repeats`` axis.  The module is laid out on the
    meta device, allocated on ``device`` uninitialised and then loaded
    (:func:`load_arrays_`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    model = Transformer(cfg, _param_tree(cfg, None, torch.device("meta")))
    model.to_empty(device=dev)
    load_arrays_(dict(model.named_parameters()), tree)
    return model


def _slot(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where the module's parameter ``name`` sits in the reference's tree:
    the key path (inside ``groups[0]["attn_mlp_0"]`` for a block's
    weights) and the layer index on the stacked ``repeats`` axis."""
    parts = name.split(".")
    if parts[0] == "blocks":
        layer, kind = int(parts[1]), parts[2]
        if kind == "attn":                          # blocks.i.attn.p.<w>
            w = parts[4]
            path = ("attn", w, "scale") if w in ("q_norm", "k_norm") \
                else ("attn", w)
        elif kind in ("ln1", "ln2"):
            path = (kind, "scale")
        else:
            path = ("ffn", parts[3])
        return path, layer
    if name in ("embed", "lm_head"):
        return (name, "table"), None
    if name == "final_norm.scale":
        return ("final_norm", "scale"), None
    raise KeyError(f"no reference slot for parameter {name!r}")


def _stand_in(t) -> np.ndarray:
    """A zero-stride array of ``t``'s shape and dtype: it copies nothing."""
    dtype = torch.empty(0, dtype=t.dtype).numpy().dtype \
        if isinstance(t, torch.Tensor) else np.asarray(t).dtype
    return np.broadcast_to(np.zeros((), dtype=dtype), tuple(t.shape))


def arrays_from_named(named: Mapping[str, Any],
                      shapes_only: bool = False) -> Dict[str, Any]:
    """The reference's parameter tree, as numpy arrays on the host, from a
    mapping keyed by the module's parameter names (the parameters, their
    gradients or a moment of the optimizer): ``embed``, ``final_norm``,
    optional ``lm_head`` and ``groups[0]["attn_mlp_0"]`` stacked on
    ``repeats``.  With ``shapes_only`` each leaf is a zero-stride array of
    its shape and dtype (a restore template that copies nothing)."""
    leaf = _stand_in if shapes_only else to_host
    tree: Dict[str, Any] = {}
    layers: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, t in named.items():
        path, layer = _slot(name)
        if layer is None:
            tree.setdefault(path[0], {})[path[1]] = leaf(t)
        else:
            layers.setdefault(path, {})[layer] = leaf(t)
    stack: Dict[str, Any] = {}
    for path, per in layers.items():
        node = stack
        for k in path[:-1]:
            node = node.setdefault(k, {})
        rows = [per[i] for i in range(len(per))]
        node[path[-1]] = np.broadcast_to(rows[0], (len(rows),)
                                         + rows[0].shape) \
            if shapes_only else np.stack(rows)
    tree["groups"] = [{"attn_mlp_0": stack}]
    return tree


def named_from_arrays(tree: Mapping[str, Any],
                      names) -> Dict[str, np.ndarray]:
    """The inverse of :func:`arrays_from_named` for the parameter
    ``names``: each name's array out of the reference's tree."""
    out = {}
    for name in names:
        path, layer = _slot(name)
        node = tree if layer is None else tree["groups"][0]["attn_mlp_0"]
        for k in path:
            node = node[k]
        out[name] = np.asarray(node if layer is None else node[layer])
    return out


def load_arrays_(named: Mapping[str, torch.Tensor],
                 tree: Mapping[str, Any]) -> None:
    """Copy the reference's tree into the tensors of ``named`` (keyed by
    the module's parameter names: the parameters or a moment), in place,
    each converted to its tensor's dtype."""
    with torch.no_grad():
        for name, a in named_from_arrays(tree, named).items():
            if not a.flags.writeable:     # torch wants a writeable buffer
                a = a.copy()
            named[name].copy_(torch.from_numpy(a))


def params_to_arrays(model: Transformer) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays`: the reference's parameter
    tree as numpy arrays (host copies)."""
    return arrays_from_named(dict(model.named_parameters()))


def count_params(model: Transformer) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None) -> List[Tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """Per-layer zero (K, V) of (batch, s_max, KV, head_dim) in the compute
    dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
    return [(torch.zeros(shape, dtype=cfg.cdtype, device=dev),
             torch.zeros(shape, dtype=cfg.cdtype, device=dev))
            for _ in range(cfg.n_layers)]


def make_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    return {"layers": init_cache(cfg, batch, s_max, device), "enc_out": None}


def _head(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = model.final_norm(x)
    table = model.lm_head if model.lm_head is not None else model.embed
    return unembed(table, x, cfg.cdtype).float()


# The reference's "dots" policy, ``dots_with_no_batch_dims_saveable``:
# keep the products without batch dimensions (the projections, the MLP and
# the unembedding, ``aten.mm`` once ``x @ w`` is folded to two dimensions)
# and recompute the rest, the attention's batched products among it.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy)


def _run_block(blk: Block, x: torch.Tensor, positions, remat: str):
    """One block, under ``remat``'s activation checkpointing when autograd
    records: ``"full"`` keeps only the block's input and recomputes the
    rest in the backward pass, ``"dots"`` keeps the products without batch
    dimensions too (the reference's ``_run_group`` policies)."""
    if remat == "none" or not torch.is_grad_enabled():
        return blk(x, positions)
    from torch.utils.checkpoint import checkpoint

    if remat == "full":
        return checkpoint(blk, x, positions, use_reentrant=False)
    if remat == "dots":
        return checkpoint(blk, x, positions, use_reentrant=False,
                          context_fn=_dots_saveable)
    raise ValueError(f"unknown remat policy {remat!r}")


def forward(model: Transformer, batch: Mapping[str, torch.Tensor],
            return_caches: bool = False):
    """Prefill forward.  batch: ``tokens`` (B, S), optional ``positions``
    (B, S); without them the positions are ``arange(S)`` and prefill
    attention takes the flash-kernel route (``models/attention.py``),
    which is forward only: a training forward passes explicit positions.
    Returns ``(logits, aux)``, or ``(logits, aux, {"layers": [(K, V), ...],
    "enc_out": None})`` with ``return_caches``.  ``aux`` is the MoE
    auxiliary loss of the reference, 0 for dense blocks."""
    cfg = model.cfg
    x = embed(model.embed, batch["tokens"]).to(cfg.cdtype)
    positions = batch.get("positions")
    caches = []
    for blk in model.blocks:
        x, kv = _run_block(blk, x, positions, cfg.remat)
        if return_caches:
            caches.append(kv)
    logits = _head(model, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_caches:
        return logits, aux, {"layers": caches, "enc_out": None}
    return logits, aux


def decode_step(model: Transformer, cache: Dict[str, Any],
                batch: Mapping[str, Any]):
    """One-token serving step.  batch: ``tokens`` (B, 1), ``cache_pos``
    int.  The cache's K/V are updated in place.  Returns (logits, cache)."""
    cfg = model.cfg
    x = embed(model.embed, batch["tokens"]).to(cfg.cdtype)
    pos = int(batch["cache_pos"])
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    new_layers = []
    for blk, kv in zip(model.blocks, cache["layers"]):
        x, kv = blk(x, positions, cache=kv, cache_pos=pos)
        new_layers.append(kv)
    return _head(model, x), {"layers": new_layers,
                             "enc_out": cache.get("enc_out")}
