"""Model assembly: the layer plan, the ``Transformer`` module, forward and
decode.

Port of ``src/repro/models/transformer.py`` for every family: dense, MoE
(``models/moe.py``), MLA (``mla_apply``), the recurrent and hybrid ones
(``models/ssm.py``: xLSTM's mLSTM and sLSTM, Griffin's RG-LRU beside
windowed ``local_attn``), the vision-language decoder (qwen2-vl: M-RoPE
over three position grids, embedding inputs) and the encoder-decoder
(whisper: an ``encoder`` group of ``enc_attn_mlp`` layers, then a
``decoder`` group of ``dec_attn_mlp`` layers with cross-attention,
sinusoidal positions on both sides).  Where the reference scans each stacked
parameter group of its plan over its repeats (deepseek-v2-lite: a
``dense_head`` group of one ``mla_mlp`` layer, then ``blocks`` of
``mla_moe``; xlstm-1.3b: ``xlstm``, a superblock of ``mlstm_0`` ...
``mlstm_6`` and ``slstm_7`` six times), the port holds one
``nn.ModuleList`` of blocks in the same order, each with its own kind and
window int (the reference's per-repeat window scalar); :func:`layer_slots`
says where each sits in the reference's groups.  Entry points:

* :func:`init_params` — seeded init on the card (``device=None``) or the
  CPU, returning the module;
* :func:`params_from_arrays` — the module from the reference's parameter
  tree as numpy arrays (``jax.tree.map(np.asarray, params)``): a copy, no
  transpose, since both keep ``(in, out)`` weights;
  :func:`params_to_arrays` the other way, and :func:`arrays_from_named` /
  :func:`named_from_arrays` for any tree that mirrors the parameters (the
  optimizer's moments, gradients) and :func:`load_arrays_` to copy such a
  tree into tensors in place;
* :func:`forward` — tokens or embeddings -> float32 logits and the summed
  MoE auxiliary loss (+ per-layer caches with ``return_caches``), the
  training forward too, with ``cfg.remat``'s activation checkpointing per
  block under autograd;
* :func:`decode_step` — one token against the fixed-capacity cache;
* :func:`forward_meshed` — the sharded trainer's forward over the port's
  ``Mesh``: the reference's parameter tree as per-entry blocks, each
  layer run once an entry, for every block kind (attention, MLA and
  cross-attention split by heads over ``model``, the recurrent blocks
  once a data entry on whole weights);
* :func:`prefill_meshed` and :func:`decode_meshed` — serving over the
  port's ``Mesh`` for every family (the flash prefill on each entry's
  heads; decode against a sequence-sharded attention cache, the
  recurrent states batch-only).

A layer's cache is its kind's: (K, V) for attention and ``local_attn``,
MLA's (c_kv, k_rope), mLSTM's (C, n, conv), sLSTM's (c, n, h), RG-LRU's
(h, conv), a decoder layer's (K, V, xK, xV) with the cross-attention's K
and V at the encoder's length, and ``()`` for an encoder layer, which has
none (the reference's ``{}`` group).  The trainer (``repro_torch.train``)
differentiates :func:`forward` with explicit positions, which take
``_sdpa_masked`` as the reference's training forward does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device, to_host

from .attention import (MLA, Attention, CrossAttention,
                        attention_decode_meshed, attention_meshed,
                        attention_tables, attn_params,
                        cross_attention_meshed, cross_attn_params,
                        mla_decode_meshed, mla_meshed, mla_params)
from .config import ModelConfig
from .layers import (MLP, RMSNorm, _param, dense_init, embed,
                     neg_log_10000_over, rmsnorm as rmsnorm_,
                     sinusoidal_positions, unembed)
from .moe import MoE, moe_params
from . import ssm

# The recurrent block kinds: (module, params, zero cache) of models/ssm.py.
RECURRENT = {"mlstm": (ssm.MLSTM, ssm.mlstm_params, ssm.mlstm_init_cache),
             "slstm": (ssm.SLSTM, ssm.slstm_params, ssm.slstm_init_cache),
             "rglru": (ssm.RGLRU, ssm.rglru_params, ssm.rglru_init_cache)}


def is_attention(kind: str) -> bool:
    """The block kinds whose cache has a sequence axis: self-attention
    (GQA, MLA), ``local_attn`` and the encoder-decoder's layers (an
    encoder layer's cache is empty)."""
    return kind not in RECURRENT


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
    kind: str               # "<mixer>_<ffn>" (attn|mla x mlp|moe), or
                            # local_attn, mlstm, slstm, rglru,
                            # enc_attn_mlp, dec_attn_mlp
    window: int
    d_ff: int               # the dense MLP's hidden width


def build_plan(cfg: ModelConfig) -> List[GroupSpec]:
    """The reference's plan.  xLSTM: one group ``xlstm`` of ``slstm_every
    - 1`` mLSTM blocks and one sLSTM, ``n_layers // slstm_every`` times.  Griffin: ``griffin``, the block
    pattern (RG-LRU, RG-LRU, ``local_attn`` at ``attn_window``) repeated,
    then ``griffin_rem`` with the pattern's first blocks for the layers
    left over.  Enc-dec: ``encoder``, ``n_enc_layers`` of
    ``enc_attn_mlp``, then ``decoder``, ``n_layers`` of ``dec_attn_mlp``,
    both global.  Otherwise, with MoE's ``first_dense_layers``, a
    ``dense_head`` group of ``{mixer}_mlp`` layers at ``d_ff_override =
    dense_d_ff``; then ``blocks`` of ``{mixer}_{ffn}`` (mixer ``attn`` or
    ``mla``, ffn ``mlp`` or ``moe``) with per-layer windows."""
    if cfg.xlstm is not None:
        se = cfg.xlstm.slstm_every
        reps = cfg.n_layers // se
        return [GroupSpec("xlstm", (("mlstm", se - 1), ("slstm", 1)), reps)]
    if cfg.rglru is not None:
        pat = cfg.rglru.block_pattern
        plen = len(pat)
        reps = cfg.n_layers // plen
        rem = cfg.n_layers - reps * plen
        win = np.full((reps, plen), -1, dtype=np.int32)
        for i, k in enumerate(pat):
            if k == "local_attn":
                win[:, i] = cfg.rglru.attn_window
        groups = [GroupSpec("griffin", tuple((k, 1) for k in pat), reps,
                            windows=win)]
        if rem:
            groups.append(GroupSpec(
                "griffin_rem", tuple((pat[i], 1) for i in range(rem)), 1,
                windows=np.full((1, rem), -1, dtype=np.int32)))
        return groups
    if cfg.enc_dec:
        return [GroupSpec("encoder", (("enc_attn_mlp", 1),),
                          cfg.n_enc_layers),
                GroupSpec("decoder", (("dec_attn_mlp", 1),), cfg.n_layers)]
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
    """One layer of the plan, with this layer's window.  Attention kinds
    (GQA, MLA, ``local_attn``, ``enc_attn_mlp``, ``dec_attn_mlp``):
    pre-norm self-attention (not causal in the encoder), for a decoder
    layer pre-norm cross-attention to ``enc_out``, then, where the layer
    has one, a pre-norm FFN (MLP or MoE).  Recurrent kinds (``mlstm``,
    ``slstm``, ``rglru``): the block of ``models/ssm.py`` (its own norms
    and residual), then for RG-LRU the pre-norm MLP where the config has a
    ``d_ff`` (the reference's ``_apply_block``).  Returns ``(x, cache,
    aux)``; ``aux`` is the MoE router's loss, ``None`` without MoE."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any],
                 slot: LayerSlot):
        super().__init__()
        self.kind = slot.kind
        self.window = int(slot.window)
        self.causal = slot.kind != "enc_attn_mlp"
        self.cdtype = cfg.cdtype
        self.moe = slot.kind.endswith("_moe")
        if slot.kind in RECURRENT:
            self.ssm = RECURRENT[slot.kind][0](cfg, p["ssm"])
        else:
            self.ssm = None
            self.ln1 = RMSNorm(p["ln1"], cfg.norm_eps)
            self.attn = (MLA if slot.kind.startswith("mla")
                         else Attention)(cfg, p["attn"])
        self.cross = None
        if slot.kind == "dec_attn_mlp":
            self.ln_cross = RMSNorm(p["ln_cross"], cfg.norm_eps)
            self.cross = CrossAttention(cfg, p["cross"])
        if "ffn" in p:
            self.ln2 = RMSNorm(p["ln2"], cfg.norm_eps)
            self.ffn = MoE(cfg, p["ffn"]) if self.moe \
                else MLP(p["ffn"], cfg.cdtype)
        else:
            self.ffn = None

    def forward(self, x, positions, cache=None, cache_pos=None,
                positions3=None, enc_out=None):
        if self.ssm is not None:
            x, new_cache = self.ssm(x, cache)
        else:
            cross_cache = None
            if self.cross is not None and cache is not None:
                cache, cross_cache = cache[:2], cache[2:]
            h = self.ln1(x.to(self.cdtype))
            kw = {} if self.kind.startswith("mla") else dict(
                causal=self.causal, positions3=positions3)
            a_out, new_cache = self.attn(h, positions, self.window,
                                         cache=cache, cache_pos=cache_pos,
                                         **kw)
            x = x + a_out.to(x.dtype)
            if self.cross is not None:
                h = self.ln_cross(x.to(self.cdtype))
                c_out, cross_kv = self.cross(h, enc_out, kv_cache=cross_cache)
                x = x + c_out.to(x.dtype)
                new_cache = tuple(new_cache) + tuple(cross_kv)
        if self.ffn is None:
            return x, new_cache, None
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
        self.enc_final_norm = RMSNorm(p["enc_final_norm"], cfg.norm_eps) \
            if "enc_final_norm" in p else None
        self.blocks = nn.ModuleList(
            Block(cfg, bp, slot) for bp, slot in zip(p["blocks"],
                                                     layer_slots(cfg)))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _ffn_init(cfg: ModelConfig, gen: Optional[torch.Generator], device,
              slot: LayerSlot) -> dict:
    if slot.kind.endswith("_moe"):
        return moe_params(cfg, gen, device)
    kw = dict(dtype=cfg.pdtype, device=device)
    ffn = {"w_up": dense_init(gen, (cfg.d_model, slot.d_ff), **kw),
           "w_down": dense_init(gen, (slot.d_ff, cfg.d_model), **kw)}
    if cfg.act in ("silu", "swiglu"):
        ffn["w_gate"] = dense_init(gen, (cfg.d_model, slot.d_ff), **kw)
    return ffn


def _block_init(cfg: ModelConfig, gen: Optional[torch.Generator], device,
                slot: LayerSlot) -> dict:
    ones = torch.ones(cfg.d_model, dtype=cfg.pdtype, device=device)
    if slot.kind in RECURRENT:
        # of the recurrent blocks only RG-LRU carries an MLP, where d_ff
        # is set (the reference's _block_params)
        p = {"ssm": RECURRENT[slot.kind][1](cfg, gen, device)}
        if slot.kind == "rglru" and cfg.d_ff:
            p.update(ln2=ones.clone(), ffn=_ffn_init(cfg, gen, device, slot))
        return p
    # The FFN is drawn before the attention: a seed gives the weights it
    # gave before the recurrent kinds came.
    ffn = _ffn_init(cfg, gen, device, slot) \
        if slot.kind != "local_attn" or cfg.d_ff else None
    attn = mla_params(cfg, gen, device) if slot.kind.startswith("mla") \
        else attn_params(cfg, gen, device)
    p = {"ln1": ones, "attn": attn}
    if slot.kind == "dec_attn_mlp":
        p.update(ln_cross=ones.clone(),
                 cross=cross_attn_params(cfg, gen, device))
    if ffn is not None:
        p.update(ln2=ones.clone(), ffn=ffn)
    return p


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
    if cfg.enc_dec:
        p["enc_final_norm"] = torch.ones(cfg.d_model, **kw)
    p["blocks"] = [_block_init(cfg, gen, device, slot)
                   for slot in layer_slots(cfg)]
    return p


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Transformer:
    """Seeded random init (an explicit ``torch.Generator`` on the target
    device; its numbers are not ``jax.random``'s)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, _param_tree(cfg, gen, dev))


def params_from_arrays(cfg: ModelConfig, tree: Mapping[str, Any],
                       device: DeviceLike = None) -> Transformer:
    """The module from the reference's params as numpy arrays (or tensors):
    ``embed``, ``final_norm``, optional ``lm_head`` and ``groups``, each
    layer's
    weights stacked on its group's leading ``repeats`` axis
    (:func:`layer_slots`).  The module is laid out on the meta device,
    allocated on ``device`` uninitialised and then loaded
    (:func:`load_arrays_`)."""
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
        if kind in ("ln1", "ln2", "ln_cross"):
            path = (kind, "scale")
        elif kind == "attn" and w in ("q_norm", "k_norm", "kv_norm"):
            path = ("attn", w, "scale")      # blocks.i.attn.p.<norm>
        elif kind == "ssm":                  # blocks.i.ssm.p.<w>, flat
            path = (w, "scale") if w in ("norm", "out_norm") else (w,)
        else:                                # blocks.i.{attn,ffn}[.p].<w>
            path = (kind, w)
        return path, slots[layer]
    if name in ("embed", "lm_head"):
        return (name, "table"), None
    if name in ("final_norm.scale", "enc_final_norm.scale"):
        return tuple(name.split(".")), None
    raise KeyError(f"no reference slot for parameter {name!r}")


def _stand_in(t) -> np.ndarray:
    """A zero-stride array of ``t``'s shape and dtype: it copies nothing.
    The dtype is read off an empty real tensor, also inside a
    ``FakeTensorMode`` (where a new tensor would be fake, and a fake one
    has no ``numpy()``)."""
    if isinstance(t, torch.Tensor):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
    else:
        dtype = np.asarray(t).dtype
    return np.broadcast_to(np.zeros((), dtype=dtype), tuple(t.shape))


def arrays_from_named(named: Mapping[str, Any], cfg: ModelConfig,
                      shapes_only: bool = False,
                      on_device: bool = False) -> Dict[str, Any]:
    """The reference's parameter tree, as numpy arrays on the host, from a
    mapping keyed by the module's parameter names (the parameters, their
    gradients or a moment of the optimizer) of a model of ``cfg``:
    ``embed``, ``final_norm``, optional ``lm_head`` and ``groups``, a dict a
    group of ``cfg``'s plan (``attn_mlp_0``; deepseek's ``mla_mlp_0``, then
    ``mla_moe_0``) of each layer's weights stacked on ``repeats``.  With ``shapes_only`` each leaf is a
    zero-stride array of its shape and dtype (a restore template that
    copies nothing); with ``on_device`` each is a tensor where the named
    one lives (detached; a stacked leaf is a new tensor)."""
    leaf = _stand_in if shapes_only else (
        (lambda t: t.detach()) if on_device else to_host)
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
            if shapes_only else (torch.stack(rows) if on_device
                                 else np.stack(rows))
    tree["groups"] = groups
    return tree


def named_from_arrays(tree: Mapping[str, Any], names,
                      cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`arrays_from_named` for the parameter
    ``names`` of a model of ``cfg``: each name's array (or tensor) out of
    the reference's tree."""
    slots = _layer_places(cfg)
    out = {}
    for name in names:
        path, slot = _slot(name, slots)
        node = tree if slot is None else tree["groups"][slot[0]][slot[1]]
        for k in path:
            node = node[k]
        got = node if slot is None else node[slot[2]]
        out[name] = got if isinstance(got, torch.Tensor) else np.asarray(got)
    return out


def load_arrays_(named: Mapping[str, torch.Tensor],
                 tree: Mapping[str, Any], cfg: ModelConfig) -> None:
    """Copy the reference's tree into the tensors of ``named`` (keyed by
    the parameter names of a model of ``cfg``: the parameters or a
    moment), in place, each converted to its tensor's dtype."""
    with torch.no_grad():
        for name, a in named_from_arrays(tree, named, cfg).items():
            if isinstance(a, torch.Tensor):
                named[name].copy_(a)
                continue
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
               device: DeviceLike = None) -> List[Tuple[torch.Tensor, ...]]:
    """Per-layer zero caches, each its kind's (the reference's
    ``_block_cache``): (K, V) of (batch, s_max, KV, head_dim) for
    attention and ``local_attn``; MLA's latent ``c_kv`` (batch, s_max, r)
    and rotary key (batch, s_max, rope); a decoder layer's (K, V) and its
    cross-attention's (xK, xV) of (batch, s_max, n_heads, head_dim), as
    the reference allocates them; ``()`` for an encoder layer; in the
    compute dtype.  The recurrent kinds' states do not grow with
    ``s_max``: mLSTM's (C, n, conv), sLSTM's (c, n, h), RG-LRU's (h,
    conv), float32 but for the convs' trailing inputs
    (``models/ssm.py``)."""
    dev = resolve_device(device)
    kw = dict(dtype=cfg.cdtype, device=dev)
    out = []
    for slot in layer_slots(cfg):
        if slot.kind in RECURRENT:
            out.append(RECURRENT[slot.kind][2](cfg, batch, dev))
        elif slot.kind.startswith("mla"):
            m = cfg.mla
            out.append((torch.zeros((batch, s_max, m.kv_lora_rank), **kw),
                        torch.zeros((batch, s_max, m.rope_head_dim), **kw)))
        elif slot.kind == "enc_attn_mlp":
            out.append(())
        else:
            shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim_)
            kv = (torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            if slot.kind == "dec_attn_mlp":
                shape = (batch, s_max, cfg.n_heads, cfg.head_dim_)
                kv += (torch.zeros(shape, **kw), torch.zeros(shape, **kw))
            out.append(kv)
    return out


def make_cache(cfg: ModelConfig, batch: int, s_max: int,
               device: DeviceLike = None, *,
               enc_out: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Zero caches (:func:`init_cache`) on ``device`` and the encoder's
    output beside them: the reference's ``make_cache``, with ``enc_out``
    keyword-only."""
    return {"layers": init_cache(cfg, batch, s_max, device),
            "enc_out": enc_out}


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


def _run_block(blk: Block, x: torch.Tensor, positions, remat: str,
               positions3=None, enc_out=None):
    """One block, under ``remat``'s activation checkpointing when autograd
    records: ``"full"`` keeps only the block's inputs (``x``, and
    ``positions3`` and ``enc_out`` where given) and recomputes the rest in
    the backward pass, ``"dots"`` keeps the products without batch
    dimensions too (the reference's ``_run_group`` policies).  Returns
    ``(x, cache, aux)``."""
    return _checkpointed(functools.partial(blk, positions3=positions3,
                                           enc_out=enc_out),
                         remat, x, positions)


def _inputs(model: Transformer, batch: Mapping[str, Any]) -> torch.Tensor:
    """The decoder's input in the compute dtype: the embedded ``tokens``,
    or ``embeds`` (B, S, d) for an embedding-input model."""
    cfg = model.cfg
    if cfg.input_kind == "tokens":
        return embed(model.embed, batch["tokens"]).to(cfg.cdtype)
    return batch["embeds"].to(cfg.cdtype)


def _encode(model: Transformer, enc_embeds: torch.Tensor,
            explicit_positions: bool) -> torch.Tensor:
    """The encoder over ``enc_embeds`` (B, Se, d) plus its sinusoid, then
    ``enc_final_norm``.  Its positions are ``arange(Se)``: given
    explicitly when ``explicit_positions`` (the training forward's
    differentiable route), else ``None``, the flash kernel's route."""
    cfg = model.cfg
    e = enc_embeds.to(cfg.cdtype)
    b, se = e.shape[:2]
    e = e + sinusoidal_positions(se, cfg.d_model, e.device).to(
        cfg.cdtype)[None]
    pos = torch.arange(se, device=e.device).expand(b, se) \
        if explicit_positions else None
    for blk in model.blocks:
        if blk.kind == "enc_attn_mlp":
            e, _, _ = _run_block(blk, e, pos, cfg.remat)
    return model.enc_final_norm(e)


def forward(model: Transformer, batch: Mapping[str, torch.Tensor],
            return_caches: bool = False):
    """Prefill forward.  batch: ``tokens`` (B, S), or ``embeds`` (B, S, d)
    for an embedding-input model; optional ``positions`` (B, S);
    ``positions3`` (3, B, S) for M-RoPE (default: ``positions`` on all
    three grids); ``enc_embeds`` (B, Se, d) for the encoder-decoder.
    Without ``positions`` the positions are ``arange(S)`` (the encoder's
    ``arange(Se)``) and prefill self-attention takes the flash-kernel
    route (``models/attention.py``), which is forward only: a training
    forward passes explicit positions, and the encoder then gets explicit
    ``arange(Se)`` too.  Returns ``(logits, aux)``, or ``(logits, aux,
    {"layers": [cache, ...], "enc_out": enc_out})`` with ``return_caches``
    (a layer's cache is its kind's, as :func:`init_cache` lists them;
    ``enc_out`` is ``None`` but for the encoder-decoder).  ``aux`` is the
    sum over the MoE layers of the router's auxiliary loss, in layer order
    as the reference sums it; 0 without MoE."""
    cfg = model.cfg
    x = _inputs(model, batch)
    b, s = x.shape[:2]
    positions = batch.get("positions")
    positions3 = batch.get("positions3")
    if cfg.rope_kind == "mrope" and positions3 is None:
        base = positions if positions is not None \
            else torch.arange(s, device=x.device).expand(b, s)
        positions3 = base[None].expand(3, b, s)
    enc_out = None
    if cfg.enc_dec:
        enc_out = _encode(model, batch["enc_embeds"], positions is not None)
        x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(
            cfg.cdtype)[None]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for blk in model.blocks:
        if blk.kind == "enc_attn_mlp":
            kv, a = (), None
        else:
            x, kv, a = _run_block(blk, x, positions, cfg.remat, positions3,
                                  enc_out)
        if a is not None:
            aux = aux + a
        if return_caches:
            caches.append(kv)
    logits = _head(model, x)
    if return_caches:
        return logits, aux, {"layers": caches, "enc_out": enc_out}
    return logits, aux


def _sinusoidal_at(pos, d_model: int, device=None) -> torch.Tensor:
    """The sinusoidal embedding at one position, (d_model,) float32, in the
    reference's decode arithmetic: the frequencies as ``exp(i · (-ln(10000)
    / d_model) · 2)``, which :func:`sinusoidal_positions` computes in
    another float32 order."""
    half = d_model // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * neg_log_10000_over(d_model, device) * 2.0)
    ang = torch.as_tensor(pos, dtype=torch.float32, device=device) * div
    pe = torch.zeros((d_model,), dtype=torch.float32, device=device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe


def decode_step(model: Transformer, cache: Dict[str, Any],
                batch: Mapping[str, Any]):
    """One-token serving step.  batch: ``tokens`` (B, 1) or ``embeds`` (B,
    1, d), ``cache_pos`` int, optional ``positions3`` (3, B, 1) (default:
    ``cache_pos`` on all three grids) and ``enc_out`` (default: the
    cache's).  A decoder layer attends to the cross K/V its cache holds.
    Attention caches are updated in place; the recurrent layers' states
    come back new.  Returns (logits, cache); the MoE layers' auxiliary
    loss is dropped, as the reference's decode step drops it."""
    cfg = model.cfg
    x = _inputs(model, batch)
    pos = int(batch["cache_pos"])
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    enc_out = batch.get("enc_out")
    if enc_out is None:
        enc_out = cache.get("enc_out")
    positions3 = batch.get("positions3")
    if cfg.rope_kind == "mrope" and positions3 is None:
        positions3 = positions[None].expand(3, b, 1)
    if cfg.enc_dec:
        x = x + _sinusoidal_at(pos, cfg.d_model, x.device).to(
            cfg.cdtype)[None, None]
    new_layers = []
    for blk, kv in zip(model.blocks, cache["layers"]):
        if blk.kind != "enc_attn_mlp":
            x, kv, _ = blk(x, positions, cache=kv, cache_pos=pos,
                           positions3=positions3, enc_out=enc_out)
        new_layers.append(kv)
    return _head(model, x), {"layers": new_layers,
                             "enc_out": cache.get("enc_out")}


# ---------------------------------------------------------------------------
# The meshed forward (the sharded trainer's)
# ---------------------------------------------------------------------------

def _unstack(st, mesh):
    """A stacked group leaf (its blocks ``(repeats, ...)``) as one sharded
    view a repeat: each distinct block unbound once, so that the backward
    stacks the repeats' gradients in one step."""
    from repro_torch.dist.sharding import NamedSharding, ShardedTensor

    views = {id(b): b.unbind(0) for b in st.distinct()}
    sharding = NamedSharding(mesh, type(st.spec)(*tuple(st.spec)[1:]))
    return [ShardedTensor(sharding, [views[id(b)][r] for b in st.blocks],
                          st.shape[1:]) for r in range(st.shape[0])]


def _unstack_node(node, mesh):
    """A node of the reference's group tree as per-repeat sharded views
    (:func:`_unstack`), its ``{"scale": ...}`` norms collapsed to the
    scale."""
    if not isinstance(node, dict):
        return _unstack(node, mesh)
    if set(node) == {"scale"}:
        return _unstack(node["scale"], mesh)
    return {k: _unstack_node(v, mesh) for k, v in node.items()}


def _at(node, r: int):
    return {k: _at(v, r) for k, v in node.items()} \
        if isinstance(node, dict) else node[r]


def _layer_weights(params, cfg: ModelConfig, mesh) -> List[dict]:
    """Each layer's sharded weights out of the reference's tree, in its
    node's layout (``src/repro/models/transformer.py::_block_params``) with
    the norms as their scales: ``ln1``, ``attn`` (its qk-norm or
    ``kv_norm`` scales inside), ``ln_cross`` and ``cross`` of a decoder
    layer, ``ln2`` and ``ffn`` where the layer has an FFN; a recurrent
    block's flat weights (``norm``, ``w_up``, ...), RG-LRU's with its
    ``ln2`` and ``ffn``."""
    per_group: Dict[Tuple[int, str], dict] = {}
    out = []
    for slot in layer_slots(cfg):
        key = (slot.group, slot.key)
        if key not in per_group:
            per_group[key] = _unstack_node(
                params["groups"][slot.group][slot.key], mesh)
        out.append(_at(per_group[key], slot.repeat))
    return out


def _block_meshed(plan, cfg: ModelConfig, slot: LayerSlot, lp: dict, xs,
                  tables, enc_outs=None, mixer=None, cross=None,
                  states=None, states_out: Optional[list] = None):
    """:class:`Block`'s forward over the mesh on each data entry's ``xs``
    (the reference's ``_apply_block``).  Attention kinds: pre-norm
    self-attention (GQA or MLA; the encoder's tables are not causal), a
    decoder layer's pre-norm cross-attention to its data entry's
    ``enc_outs``, then, where the layer has one, the pre-norm MLP or MoE.
    Recurrent kinds: the block of ``models/ssm.py`` once a data entry on
    its weights gathered whole (:meth:`MeshPlan.whole`: the FSDP gather,
    then the blocks over ``model``; the backward reduce-scatters), from
    ``states[d]``, data entry ``d``'s block of the layer's state (``None``
    or none given: the zero state of the sequence form), each new state
    appended to ``states_out`` where given; then RG-LRU's pre-norm MLP.
    ``mixer`` and ``cross`` stand in for the self- and cross-attention
    (the serving steps' forms, called as :func:`attention_meshed` and
    :func:`cross_attention_meshed` are).  Returns ``(xs, aux)``."""
    from .layers import mlp_meshed
    from .moe import moe_meshed

    plan.clear()        # gather this layer's weights (again in a remat)
    cdt, eps, kind = cfg.cdtype, cfg.norm_eps, slot.kind

    def pre_norm(name):
        scale = plan.local(lp[name])
        return [rmsnorm_(x.to(cdt), scale, eps) for x in xs]

    def add(outs):
        return [x + o.to(x.dtype) for x, o in zip(xs, outs)]

    if kind in RECURRENT:
        w = {n: plan.whole(v) for n, v in lp.items()
             if n not in ("ln2", "ffn")}
        apply = RECURRENT[kind][0].apply_fn
        outs = [apply(w, cfg, x, None if states is None else states[di])
                for di, x in enumerate(xs)]
        xs = [o[0] for o in outs]
        if states_out is not None:
            states_out.extend(o[1] for o in outs)
    else:
        if mixer is None:
            mixer = mla_meshed if kind.startswith("mla") \
                else attention_meshed
        xs = add(mixer(plan, lp["attn"], cfg, pre_norm("ln1"), tables,
                       slot.window))
        if kind == "dec_attn_mlp":
            xs = add((cross or cross_attention_meshed)(
                plan, lp["cross"], cfg, pre_norm("ln_cross"), enc_outs))
    if "ffn" not in lp:
        return xs, None
    hs = pre_norm("ln2")
    if kind.endswith("_moe"):
        f, aux = moe_meshed(plan, lp["ffn"], cfg, hs)
    else:
        f, aux = mlp_meshed(plan, lp["ffn"], hs, cdt), None
    return add(f), aux


def _encode_meshed(plan, params, cfg: ModelConfig, enc_embeds, slots,
                   weights, flash: bool = False):
    """:func:`_encode` over the mesh: each data entry's ``enc_embeds``
    plus the sinusoid, the ``enc_attn_mlp`` layers (not causal, positions
    ``arange(S_enc)``), then ``enc_final_norm``.  ``flash`` (the serving
    prefill's): the self-attention takes the flash route on each (data,
    model) entry's heads, as :func:`_encode` takes it without explicit
    positions."""
    cdt = cfg.cdtype
    es, tables = [], []
    for e in enc_embeds:
        b, se = e.shape[:2]
        es.append(e.to(cdt) + sinusoidal_positions(
            se, cfg.d_model, e.device).to(cdt)[None])
        pos = torch.arange(se, device=e.device).expand(b, se)
        tables.append(attention_tables(cfg, pos, [-1], causal=False,
                                       flash=flash))
    for slot, lp in zip(slots, weights):
        if slot.kind == "enc_attn_mlp":
            es, _ = _checkpointed(functools.partial(
                _block_meshed, plan, cfg, slot, lp), cfg.remat, es, tables)
    plan.clear()
    scale = plan.local(params["enc_final_norm"]["scale"])
    return [rmsnorm_(e, scale, cfg.norm_eps) for e in es]


def _embed_meshed(params, cfg: ModelConfig, plan, batches):
    """Each data entry's decoder input in the compute dtype: its ``tokens``
    looked up vocab-parallel, or its ``embeds``."""
    from .layers import embed_meshed

    cdt = cfg.cdtype
    if cfg.input_kind == "tokens":
        return [x.to(cdt) for x in embed_meshed(
            plan, params["embed"]["table"], [b["tokens"] for b in batches])]
    return [b["embeds"].to(cdt) for b in batches]


def _head_meshed(params, cfg: ModelConfig, plan, xs):
    """``final_norm``, then the logits of each data entry's vocab blocks
    (:func:`~repro_torch.models.layers.unembed_meshed`)."""
    from .layers import unembed_meshed

    plan.clear()
    scale = plan.local(params["final_norm"]["scale"])
    xs = [rmsnorm_(x, scale, cfg.norm_eps) for x in xs]
    table = params["lm_head" if "lm_head" in params else "embed"]["table"]
    return unembed_meshed(plan, table, xs, cfg.cdtype)


def forward_meshed(params, cfg: ModelConfig, plan, batches):
    """The training forward over ``plan``'s mesh (a
    :class:`~repro_torch.models.layers.MeshPlan`), for every family.
    ``params`` is the reference's parameter tree, each leaf a
    :class:`~repro_torch.dist.sharding.ShardedTensor` (its group leaves
    stacked on ``repeats``); ``batches`` has one dict a data entry: its
    ``tokens`` (B_d, S), or ``embeds`` (B_d, S, d) for an embedding-input
    model (no table lookup; the tied table still gives the logits), and
    explicit ``positions`` (B_d, S); ``positions3`` (3, B_d, S) for
    M-RoPE (default: ``positions`` on all three grids); ``enc_embeds``
    (B_d, S_enc, d) for the encoder-decoder, whose encoder runs first on
    each data entry.  Each block runs under ``cfg.remat``'s activation
    checkpointing, as :func:`forward`'s.  Returns ``(logits, aux)``: for
    each data entry the float32 logits of each model entry's vocab block
    (a list), and the summed MoE router loss."""
    mesh = plan.mesh
    cdt = cfg.cdtype
    plan.clear()
    xs = _embed_meshed(params, cfg, plan, batches)
    slots = layer_slots(cfg)
    weights = _layer_weights(params, cfg, mesh)
    enc_outs = None
    if cfg.enc_dec:
        enc_outs = _encode_meshed(plan, params, cfg,
                                  [b["enc_embeds"] for b in batches], slots,
                                  weights)
        xs = [x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                       x.device).to(cdt)[None] for x in xs]
    tables = [attention_tables(cfg, b["positions"],
                               [s.window for s in slots],
                               positions3=b.get("positions3"))
              for b in batches]
    aux = torch.zeros((), dtype=torch.float32, device=plan.device())
    for slot, lp in zip(slots, weights):
        if slot.kind == "enc_attn_mlp":
            continue
        fn = functools.partial(_block_meshed, plan, cfg, slot, lp)
        xs, a = _checkpointed(fn, cfg.remat, xs, tables, enc_outs)
        if a is not None:
            aux = aux + a
    return _head_meshed(params, cfg, plan, xs), aux


# ---------------------------------------------------------------------------
# Serving over the mesh
# ---------------------------------------------------------------------------

def _batch_entry(plan):
    axes = tuple(plan.data_axes)
    return (axes[0] if len(axes) == 1 else axes) or None


# The serving steps' batch keys, split over the data entries
SERVE_BATCH_KEYS = ("tokens", "embeds", "positions", "positions3",
                    "enc_embeds")


def batch_rows(cfg: ModelConfig, batch) -> int:
    """The rows of a serving batch: its ``tokens``', or its ``embeds``'
    for an embedding-input model."""
    return int(batch["tokens" if cfg.input_kind == "tokens"
                     else "embeds"].shape[0])


def _split_serving(plan, batch):
    """Each data entry's rows of the batch's inputs (``positions3`` on
    axis 1; none split under the batch fallback)."""
    from repro_torch.train.train_step import split_micro

    return split_micro({k: batch[k] for k in SERVE_BATCH_KEYS
                        if batch.get(k) is not None}, 1, plan.dp)[0]


def _entries_tensor(plan, per_entry, b: int):
    """One ``ShardedTensor`` of a cache or logits tensor from its blocks:
    ``per_entry[d]`` holds data entry ``d``'s, one a model entry where
    they differ (split along axis 2 over ``model``: the heads, or the
    logits' vocab), else one for every model entry (whole).  The batch
    (axis 0, ``b`` rows) lies over the data axes."""
    from repro_torch.dist.sharding import P

    first = per_entry[0]
    split = len({id(t) for t in first}) > 1
    shape = [b] + list(first[0].shape[1:])
    spec = [_batch_entry(plan)] + [None] * (len(shape) - 1)
    if split:
        spec[2] = "model"
        shape[2] *= len(first)
    return plan.assemble(P(*spec), tuple(shape),
                         lambda di, m: per_entry[di][m if split else 0])


def prefill_meshed(params, cfg: ModelConfig, plan, batch):
    """The serving prefill over ``plan``'s mesh, for every family: the
    reference's ``forward`` with ``return_caches``, partitioned as its
    prefill cell is.  ``params`` is the reference's parameter tree of
    ``ShardedTensor``s (``shard_params(..., fsdp=False)``), ``batch`` the
    whole batch, as :func:`forward` takes it (``tokens`` (B, S) or
    ``embeds`` (B, S, d); optional ``positions`` (B, S), ``positions3``
    (3, B, S), ``enc_embeds`` (B, S_enc, d)), split over the plan's data
    entries (the ``batch`` rule; none under the fallback).  Without
    ``positions`` each (data, model) entry runs the flash kernel on its
    block of query heads (:func:`attention_meshed`, :func:`mla_meshed`;
    whisper's encoder too, not causal); with them ``_sdpa_masked``'s
    arithmetic.  The recurrent blocks run once a data entry from the zero
    state.

    Returns ``(logits, aux, {"layers": [...], "enc_out": enc_out})``: the
    float32 logits (B, S, V) and each layer's cache, by kind, as
    ``ShardedTensor``s with the batch over the data axes: (K, V) (B, S,
    KV, D) for ``attn`` and ``local_attn``, the aligned KV heads over
    ``model`` (misaligned ones whole: the same tensors on every model
    entry); MLA's (c_kv, k_rope) (B, S, r) and (B, S, rope), whole on
    every model entry; the post-prompt state of ``mlstm``, ``slstm`` and
    ``rglru``; (K, V, xK, xV) for ``dec_attn_mlp``, the cross K/V (B,
    S_enc, H, D) with their heads as the cross-attention split them;
    ``()`` for an encoder layer.  ``enc_out`` (B, S_enc, d) is the
    encoder's output (``None`` but for the encoder-decoder)."""
    plan.clear()
    batches = _split_serving(plan, batch)
    xs = _embed_meshed(params, cfg, plan, batches)
    b = batch_rows(cfg, batch)
    s = xs[0].shape[1]
    slots = layer_slots(cfg)
    weights = _layer_weights(params, cfg, plan.mesh)
    flash = batch.get("positions") is None
    enc_outs = None
    if cfg.enc_dec:
        enc_outs = _encode_meshed(plan, params, cfg,
                                  [part["enc_embeds"] for part in batches],
                                  slots, weights, flash=flash)
        xs = [x + sinusoidal_positions(s, cfg.d_model, x.device).to(
            cfg.cdtype)[None] for x in xs]
    tables = []
    for part, x in zip(batches, xs):
        pos = part.get("positions")
        if flash:
            pos = torch.arange(s, device=x.device).expand(x.shape[0], s)
        tables.append(attention_tables(cfg, pos, [sl.window for sl in slots],
                                       positions3=part.get("positions3"),
                                       flash=flash))
    aux = torch.zeros((), dtype=torch.float32, device=plan.device())
    caches = []
    for slot, lp in zip(slots, weights):
        if slot.kind == "enc_attn_mlp":
            caches.append(())
            continue
        kvs: list = []
        xkvs: list = []
        states: list = []
        mixer = functools.partial(
            mla_meshed if slot.kind.startswith("mla") else attention_meshed,
            kv_out=kvs)
        cross = functools.partial(cross_attention_meshed, kv_out=xkvs)
        xs, a = _block_meshed(plan, cfg, slot, lp, xs, tables, enc_outs,
                              mixer=mixer, cross=cross, states_out=states)
        if a is not None:
            aux = aux + a
        if slot.kind in RECURRENT:
            layer = _layer_cache(plan, [[st] for st in states], b)
        elif slot.kind.startswith("mla"):
            layer = _layer_cache(plan, [[kv] for kv in kvs], b)
        else:
            layer = _layer_cache(plan, kvs, b)
            if xkvs:
                layer += _layer_cache(plan, xkvs, b)
        caches.append(layer)
    enc_out = None if enc_outs is None else _entries_tensor(
        plan, [[e] for e in enc_outs], b)
    return (_entries_tensor(plan, _head_meshed(params, cfg, plan, xs), b),
            aux, {"layers": caches, "enc_out": enc_out})


def _layer_cache(plan, per, b: int) -> tuple:
    """A layer's cache tensors from ``per[d][m]``, data entry ``d``'s tuple
    of blocks of model entry ``m`` (one for all, or the same tensors on
    each, where they are whole), each slot laid out by
    :func:`_entries_tensor`."""
    n = len(per[0][0])
    return tuple(_entries_tensor(plan, [[t[j] for t in row] for row in per],
                                 b) for j in range(n))


def decode_meshed(params, cfg: ModelConfig, plan, cache, batch):
    """One-token serving step over ``plan``'s mesh, for every family: the
    reference's ``decode_step`` under its decode rules.  ``cache`` holds
    each layer's cache, by kind, as ``ShardedTensor``s laid out by
    ``cache_specs`` (``extend_cache`` of a meshed prefill's cache);
    ``batch`` the whole ``tokens`` (B, 1), or ``embeds`` (B, 1, d), and
    ``cache_pos``; optional ``positions3`` (3, B, 1), by default
    ``cache_pos`` on all three grids.  The encoder-decoder adds the
    sinusoid at ``cache_pos`` (:func:`_sinusoidal_at`).  Each layer by
    kind: self-attention by
    :func:`~repro_torch.models.attention.attention_decode_meshed` (heads
    whole, the sequence over ``model``, or over the data axes and
    ``model`` under the batch fallback, where the plan has no data axes
    and the rest of the layer runs once), MLA by
    :func:`~repro_torch.models.attention.mla_decode_meshed`, each writing
    its new entries in place; a decoder layer's cross-attention against
    its cached xK/xV (:func:`cross_attention_meshed`'s cache form); the
    recurrent blocks from each data entry's block of their state, their
    new state returned.  Returns ``(logits, cache)``, the float32 logits
    (B, 1, V) a ``ShardedTensor`` as :func:`prefill_meshed` gives
    them."""
    from .attention import _data_block

    plan.clear()
    pos = int(batch["cache_pos"])
    b = batch_rows(cfg, batch)
    batch = dict(batch)
    dev = batch["tokens" if cfg.input_kind == "tokens" else "embeds"].device
    if cfg.rope_kind == "mrope" and batch.get("positions3") is None:
        batch["positions3"] = torch.full((3, b, 1), pos, dtype=torch.int64,
                                         device=dev)
    batches = _split_serving(plan, {k: batch.get(k) for k in
                                    ("tokens", "embeds", "positions3")})
    xs = _embed_meshed(params, cfg, plan, batches)
    if cfg.enc_dec:
        xs = [x + _sinusoidal_at(pos, cfg.d_model, x.device).to(
            cfg.cdtype)[None, None] for x in xs]
    slots = layer_slots(cfg)
    weights = _layer_weights(params, cfg, plan.mesh)
    tables = [attention_tables(cfg, torch.full((x.shape[0], 1), pos,
                                               dtype=torch.int64,
                                               device=x.device), [],
                               positions3=part.get("positions3"))
              for part, x in zip(batches, xs)]
    layers = []
    for slot, lp, layer in zip(slots, weights, cache["layers"]):
        kind = slot.kind
        if kind == "enc_attn_mlp":
            layers.append(layer)
            continue
        if kind in RECURRENT:
            new: list = []
            xs, _ = _block_meshed(
                plan, cfg, slot, lp, xs, tables,
                states=[tuple(_data_block(plan, t, di) for t in layer)
                        for di in range(len(xs))], states_out=new)
            layers.append(_layer_cache(plan, [[st] for st in new], b))
            continue
        mixer = functools.partial(
            mla_decode_meshed if kind.startswith("mla")
            else attention_decode_meshed, cache=layer[:2], cache_pos=pos)
        cross = functools.partial(cross_attention_meshed, cache=layer[2:])
        xs, _ = _block_meshed(plan, cfg, slot, lp, xs, tables, mixer=mixer,
                              cross=cross)
        layers.append(layer)
    return (_entries_tensor(plan, _head_meshed(params, cfg, plan, xs), b),
            {"layers": layers, "enc_out": cache.get("enc_out")})


def _checkpointed(fn, remat: str, *args):
    """``fn(*args)`` under ``remat``'s activation checkpointing when
    autograd records: ``"full"`` keeps only the inputs and recomputes the
    rest in the backward pass, ``"dots"`` keeps the products without
    batch dimensions too (:func:`_dots_saveable`)."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_saveable)
    raise ValueError(f"unknown remat policy {remat!r}")
