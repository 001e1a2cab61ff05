"""Model assembly: the layer plan, the ``Transformer`` module, forward and
decode.

Port of ``src/repro/models/transformer.py`` for the decoder-only families:
dense, MoE (``models/moe.py``) and MLA (``mla_apply``).  Where the
reference scans each stacked parameter group of its plan over its repeats
(deepseek-v2-lite: a ``dense_head`` group of one ``mla_mlp`` layer, then
``blocks`` of ``mla_moe``), the port holds one ``nn.ModuleList`` of blocks
in the same order, each with its own kind and window int (the reference's
per-repeat window scalar); :func:`layer_slots` says where each sits in the
reference's groups.  Entry points:

* :func:`init_params` — seeded init on the card (``device=None``) or the
  CPU, returning the module;
* :func:`params_from_arrays` — the module from the reference's parameter
  tree as numpy arrays (``jax.tree.map(np.asarray, params)``): a copy, no
  transpose, since both keep ``(in, out)`` weights;
  :func:`params_to_arrays` the other way, and :func:`arrays_from_named` /
  :func:`named_from_arrays` for any tree that mirrors the parameters (the
  optimizer's moments, gradients) and :func:`load_arrays_` to copy such a
  tree into tensors in place;
* :func:`forward` — tokens -> float32 logits and the summed MoE auxiliary
  loss (+ per-layer caches with ``return_caches``), the training forward
  too, with ``cfg.remat``'s activation checkpointing per block under
  autograd;
* :func:`decode_step` — one token against the fixed-capacity cache.

The recurrent blocks, enc-dec, M-RoPE and embedding inputs raise
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

from .attention import MLA, Attention, attn_params, mla_params
from .config import ModelConfig
from .layers import MLP, RMSNorm, _param, dense_init, embed, unembed
from .moe import MoE, moe_params

_NOT_PORTED = "not ported yet (ROADMAP.md §1, item 10, LM substrate)"


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    parts: Tuple[Tuple[str, int], ...]      # ((kind, count), ...)
    repeats: int
    windows: Optional[np.ndarray] = None    # (repeats, n_instances) int32
    d_ff_override: int = 0

    @property
    def instances(self) -> List[Tuple[str, int]]:
        out = []
        for kind, count in self.parts:
            for _ in range(count):
                out.append((kind, len(out)))
        return out


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    """Where one module layer sits in the reference's parameter tree:
    ``groups[group][key]`` at index ``repeat`` of the stacked axis."""
    group: int
    key: str                # "<kind>_<instance>", e.g. "mla_moe_0"
    repeat: int
    kind: str               # "<mixer>_<ffn>": attn|mla x mlp|moe
    window: int
    d_ff: int               # the dense MLP's hidden width


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's model lacks."""
    missing = [what for what, has in (
        ("xlstm", cfg.xlstm is not None), ("rglru", cfg.rglru is not None),
        ("enc_dec", cfg.enc_dec), ('rope_kind="mrope"',
                                   cfg.rope_kind == "mrope"),
        ('input_kind="embeddings"', cfg.input_kind != "tokens")) if has]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} "
                                  f"{_NOT_PORTED}")


def build_plan(cfg: ModelConfig) -> List[GroupSpec]:
    """The reference's plan for the decoder-only families: with MoE's
    ``first_dense_layers``, a ``dense_head`` group of ``{mixer}_mlp``
    layers at ``d_ff_override = dense_d_ff``; then ``blocks`` of
    ``{mixer}_{ffn}`` (mixer ``attn`` or ``mla``, ffn ``mlp`` or ``moe``)
    with per-layer windows."""
    check_supported(cfg)
    mixer = "mla" if cfg.mla is not None else "attn"
    ffn = "moe" if cfg.moe is not None else "mlp"
    groups = []
    start = 0
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        groups.append(GroupSpec(
            "dense_head", ((f"{mixer}_mlp", 1),), cfg.moe.first_dense_layers,
            d_ff_override=cfg.moe.dense_d_ff))
        start = cfg.moe.first_dense_layers
    n = cfg.n_layers - start
    win = np.array([[cfg.window_for_layer(start + i)] for i in range(n)],
                   dtype=np.int32)
    groups.append(GroupSpec("blocks", ((f"{mixer}_{ffn}", 1),), n,
                            windows=win))
    return groups


def layer_slots(cfg: ModelConfig) -> List[LayerSlot]:
    """Each module layer's place in the reference's plan, in the order the
    reference runs them (group by group, repeat by repeat).  A group
    without windows is global (-1) everywhere, as the reference's scan."""
    out = []
    for gi, g in enumerate(build_plan(cfg)):
        for r in range(g.repeats):
            for kind, idx in g.instances:
                win = -1 if g.windows is None else int(g.windows[r, idx])
                out.append(LayerSlot(gi, f"{kind}_{idx}", r, kind, win,
                                     g.d_ff_override or cfg.d_ff))
    return out


class Block(nn.Module):
    """Pre-norm attention (GQA or MLA) + FFN (MLP or MoE), with this
    layer's window.  Returns ``(x, cache, aux)``; ``aux`` is the MoE
    router's loss, ``None`` for a dense FFN."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any],
                 slot: LayerSlot):
        super().__init__()
        mixer, ffn = slot.kind.split("_")
        self.kind = slot.kind
        self.window = int(slot.window)
        self.ln1 = RMSNorm(p["ln1"], cfg.norm_eps)
        self.attn = (MLA if mixer == "mla" else Attention)(cfg, p["attn"])
        self.ln2 = RMSNorm(p["ln2"], cfg.norm_eps)
        self.moe = ffn == "moe"
        self.ffn = MoE(cfg, p["ffn"]) if self.moe \
            else MLP(p["ffn"], cfg.cdtype)
        self.cdtype = cfg.cdtype

    def forward(self, x, positions, cache=None, cache_pos=None):
        h = self.ln1(x.to(self.cdtype))
        a_out, new_cache = self.attn(h, positions, self.window, cache=cache,
                                     cache_pos=cache_pos)
        x = x + a_out.to(x.dtype)
        h = self.ln2(x.to(self.cdtype))
        if self.moe:
            f_out, aux = self.ffn(h)
        else:
            f_out, aux = self.ffn(h), None
        return x + f_out.to(x.dtype), new_cache, aux


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(p["embed"])
        self.final_norm = RMSNorm(p["final_norm"], cfg.norm_eps)
        self.lm_head = _param(p["lm_head"]) if "lm_head" in p else None
        self.blocks = nn.ModuleList(
            Block(cfg, bp, slot) for bp, slot in zip(p["blocks"],
                                                     layer_slots(cfg)))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _block_init(cfg: ModelConfig, gen: Optional[torch.Generator], device,
                slot: LayerSlot) -> dict:
    kw = dict(dtype=cfg.pdtype, device=device)
    mixer, kind = slot.kind.split("_")
    if kind == "moe":
        ffn = moe_params(cfg, gen, device)
    else:
        d_ff = slot.d_ff
        ffn = {"w_up": dense_init(gen, (cfg.d_model, d_ff), **kw),
               "w_down": dense_init(gen, (d_ff, cfg.d_model), **kw)}
        if cfg.act in ("silu", "swiglu"):
            ffn["w_gate"] = dense_init(gen, (cfg.d_model, d_ff), **kw)
    attn = mla_params(cfg, gen, device) if mixer == "mla" \
        else attn_params(cfg, gen, device)
    return {"ln1": torch.ones(cfg.d_model, **kw), "attn": attn,
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
    p["blocks"] = [_block_init(cfg, gen, device, slot)
                   for slot in layer_slots(cfg)]
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
    ``final_norm``, optional ``lm_head`` and ``groups``, each layer's
    weights stacked on its group's leading ``repeats`` axis
    (:func:`layer_slots`).  The module is laid out on the meta device,
    allocated on ``device`` uninitialised and then loaded
    (:func:`load_arrays_`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    model = Transformer(cfg, _param_tree(cfg, None, torch.device("meta")))
    model.to_empty(device=dev)
    load_arrays_(dict(model.named_parameters()), tree, cfg)
    return model


def _layer_places(cfg: ModelConfig) -> Dict[int, Tuple[int, str, int]]:
    """Each module layer's ``(group, key, repeat)`` in the reference's tree,
    from the plan (:func:`layer_slots`)."""
    return {i: (s.group, s.key, s.repeat)
            for i, s in enumerate(layer_slots(cfg))}


def _slot(name: str, slots: Mapping[int, Tuple[int, str, int]]
          ) -> Tuple[Tuple[str, ...], Optional[Tuple[int, str, int]]]:
    """Where the module's parameter ``name`` sits in the reference's tree:
    the key path (inside ``groups[group][key]`` for a block's weights) and,
    for a block's weights, ``(group, key, repeat)`` from ``slots``
    (:func:`_layer_places`)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        layer, kind, w = int(parts[1]), parts[2], parts[-1]
        if kind in ("ln1", "ln2"):
            path = (kind, "scale")
        elif kind == "attn" and w in ("q_norm", "k_norm", "kv_norm"):
            path = ("attn", w, "scale")      # blocks.i.attn.p.<norm>
        else:                                # blocks.i.{attn,ffn}[.p].<w>
            path = (kind, w)
        return path, slots[layer]
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


def arrays_from_named(named: Mapping[str, Any], cfg: ModelConfig,
                      shapes_only: bool = False) -> Dict[str, Any]:
    """The reference's parameter tree, as numpy arrays on the host, from a
    mapping keyed by the module's parameter names (the parameters, their
    gradients or a moment of the optimizer) of a model of ``cfg``:
    ``embed``, ``final_norm``, optional ``lm_head`` and ``groups``, a dict a
    group of ``cfg``'s plan (``attn_mlp_0``; deepseek's ``mla_mlp_0``, then
    ``mla_moe_0``) of each layer's weights stacked on ``repeats``.  With ``shapes_only`` each leaf is a
    zero-stride array of its shape and dtype (a restore template that
    copies nothing)."""
    leaf = _stand_in if shapes_only else to_host
    slots = _layer_places(cfg)
    tree: Dict[str, Any] = {}
    layers: Dict[Tuple[int, str, Tuple[str, ...]], Dict[int, Any]] = {}
    for name, t in named.items():
        path, slot = _slot(name, slots)
        if slot is None:
            tree.setdefault(path[0], {})[path[1]] = leaf(t)
        else:
            group, key, rep = slot
            layers.setdefault((group, key, path), {})[rep] = leaf(t)
    groups: List[Dict[str, Any]] = [
        {} for _ in range(1 + max((g for g, _, _ in slots.values()),
                                  default=-1))]
    for (group, key, path), per in layers.items():
        node = groups[group].setdefault(key, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        rows = [per[i] for i in range(len(per))]
        node[path[-1]] = np.broadcast_to(rows[0], (len(rows),)
                                         + rows[0].shape) \
            if shapes_only else np.stack(rows)
    tree["groups"] = groups
    return tree


def named_from_arrays(tree: Mapping[str, Any], names,
                      cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`arrays_from_named` for the parameter
    ``names`` of a model of ``cfg``: each name's array out of the
    reference's tree."""
    slots = _layer_places(cfg)
    out = {}
    for name in names:
        path, slot = _slot(name, slots)
        node = tree if slot is None else tree["groups"][slot[0]][slot[1]]
        for k in path:
            node = node[k]
        out[name] = np.asarray(node if slot is None else node[slot[2]])
    return out


def load_arrays_(named: Mapping[str, torch.Tensor],
                 tree: Mapping[str, Any], cfg: ModelConfig) -> None:
    """Copy the reference's tree into the tensors of ``named`` (keyed by
    the parameter names of a model of ``cfg``: the parameters or a
    moment), in place, each converted to its tensor's dtype."""
    with torch.no_grad():
        for name, a in named_from_arrays(tree, named, cfg).items():
            if not a.flags.writeable:     # torch wants a writeable buffer
                a = a.copy()
            named[name].copy_(torch.from_numpy(a))


def params_to_arrays(model: Transformer) -> Dict[str, Any]:
    """The inverse of :func:`params_from_arrays`: the reference's parameter
    tree as numpy arrays (host copies)."""
    return arrays_from_named(dict(model.named_parameters()), model.cfg)


def count_params(model: Transformer) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None) -> List[Tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """Per-layer zero caches in the compute dtype: (K, V) of (batch, s_max,
    KV, head_dim), or for MLA the latent ``c_kv`` (batch, s_max, r) and
    the rotary key (batch, s_max, rope) (the reference's
    ``_block_cache``)."""
    dev = resolve_device(device)
    kw = dict(dtype=cfg.cdtype, device=dev)
    out = []
    for slot in layer_slots(cfg):
        if slot.kind.startswith("mla"):
            m = cfg.mla
            out.append((torch.zeros((batch, s_max, m.kv_lora_rank), **kw),
                        torch.zeros((batch, s_max, m.rope_head_dim), **kw)))
        else:
            shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
            out.append((torch.zeros(shape, **kw), torch.zeros(shape, **kw)))
    return out


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
    dimensions too (the reference's ``_run_group`` policies).  Returns
    ``(x, cache, aux)``."""
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
    Returns ``(logits, aux)``, or ``(logits, aux, {"layers": [cache, ...],
    "enc_out": None})`` with ``return_caches`` (a layer's cache: (K, V),
    or MLA's (c_kv, k_rope)).  ``aux`` is the sum over the MoE layers of
    the router's auxiliary loss, in layer order as the reference sums it;
    0 without MoE."""
    cfg = model.cfg
    x = embed(model.embed, batch["tokens"]).to(cfg.cdtype)
    positions = batch.get("positions")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for blk in model.blocks:
        x, kv, a = _run_block(blk, x, positions, cfg.remat)
        if a is not None:
            aux = aux + a
        if return_caches:
            caches.append(kv)
    logits = _head(model, x)
    if return_caches:
        return logits, aux, {"layers": caches, "enc_out": None}
    return logits, aux


def decode_step(model: Transformer, cache: Dict[str, Any],
                batch: Mapping[str, Any]):
    """One-token serving step.  batch: ``tokens`` (B, 1), ``cache_pos``
    int.  The caches are updated in place.  Returns (logits, cache); the
    MoE layers' auxiliary loss is dropped, as the reference's decode step
    drops it."""
    cfg = model.cfg
    x = embed(model.embed, batch["tokens"]).to(cfg.cdtype)
    pos = int(batch["cache_pos"])
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    new_layers = []
    for blk, kv in zip(model.blocks, cache["layers"]):
        x, kv, _ = blk(x, positions, cache=kv, cache_pos=pos)
        new_layers.append(kv)
    return _head(model, x), {"layers": new_layers,
                             "enc_out": cache.get("enc_out")}
