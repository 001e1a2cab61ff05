"""Serving steps: prefill, cache extension, one-token decode, sampling.

Port of ``src/repro/serve/steps.py``.  PyTorch runs eagerly, so the step
builders return plain closures where the reference returns functions for
``jax.jit``.  ``extend_cache`` turns a prefill cache (KV length = prompt
length) into a fixed-capacity decode cache (KV length = ``s_max``) by
zero-padding the sequence axis of the attention-family layers
(self-attention's and ``local_attn``'s K/V, MLA's latent ``c_kv`` and
rotary key); the recurrent layers' states, and a decoder layer's
cross-attention K/V, pass through.

**Over the port's Mesh** (every family).  A step given the reference's
parameter tree of ``ShardedTensor``s (``shard_params(..., fsdp=False)``
laid out by ``shard_tree``) takes the meshed route, with the activation
rules bound around it by ``bind_activation_rules`` (``activation_rules(cfg,
mesh, decode=..., batch=B)``; unbound, those rules): the prefill
(``models/transformer.py::prefill_meshed``) runs the flash kernel on each
(data, model) entry's block of query heads (MLA's too; whisper's encoder
not causal) and returns each layer's cache by kind, the attention K/V with
the heads over ``model``, MLA's latent and rotary key whole, the recurrent
states of each data entry's rows, a decoder layer's cross K/V beside its
own; :func:`extend_cache` pads each sequence-bearing block and lays the
cache out by ``cache_specs`` (the sequence over ``model``, or over the
data axes and ``model`` under the batch fallback), one ``all_to_all``
over ``model`` a tensor where the KV heads are split, gathers the cross
K/V's heads at the encoder's length, and passes the recurrent states and
``enc_out`` through; the decode (``decode_meshed``) writes each new K/V
(MLA: latent and rotary key) into the block that owns ``cache_pos``,
combines the blocks' softmax by log-sum-exp and returns the new recurrent
states.  Both return their logits as a ``ShardedTensor``, which
:func:`sample_greedy` takes.  The engine (``serve/engine.py``) takes no
mesh, as the reference's does not.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.dist.sharding import (NamedSharding, ShardedTensor,
                                       _entry_axes, activation_rules,
                                       bound_rules, cache_specs,
                                       tree_flatten_with_path)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshPlan
from repro_torch.models.transformer import (Transformer, batch_rows,
                                            decode_meshed, decode_step,
                                            forward, is_attention,
                                            layer_slots, prefill_meshed)


def _sharded_leaf(tree):
    """The first ``ShardedTensor`` of ``tree``, or ``None``."""
    if isinstance(tree, (Transformer, torch.Tensor)):
        return None
    return next((leaf for _, leaf in tree_flatten_with_path(tree)[0]
                 if isinstance(leaf, ShardedTensor)), None)


def _serve_plan(cfg: ModelConfig, leaf: ShardedTensor, batch,
                decode: bool) -> MeshPlan:
    """The plan of a meshed serving step: its data entries are the bound
    ``batch`` rule's axes (none under the fallback)."""
    mesh = leaf.sharding.mesh
    devices = {str(d) for d in mesh.devices.flat}
    if len(devices) > 1:
        raise NotImplementedError(
            f"a mesh over {sorted(devices)}: entries on more than one "
            f"device wait for the transport between cards (ROADMAP.md §1, "
            f"item 5)")
    rules = bound_rules()
    if rules is None:
        rules = activation_rules(cfg, mesh, decode=decode,
                                 batch=batch_rows(cfg, batch))
    return MeshPlan(mesh, _entry_axes(rules["batch"]))


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill_step(model, batch) -> (logits, cache_dict); batch: tokens
    (B, S) | embeds (B, S, d), optional positions (B, S) (+ positions3 /
    enc_embeds).  ``model`` is the module, or the reference's parameter
    tree of ``ShardedTensor``s (the meshed prefill of any family)."""

    def prefill_step(model: Transformer, batch):
        leaf = _sharded_leaf(model)
        if leaf is not None:
            with torch.no_grad():
                logits, _aux, caches = prefill_meshed(
                    model, cfg, _serve_plan(cfg, leaf, batch, False), batch)
            return logits, caches
        logits, _aux, caches = forward(model, batch, return_caches=True)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """decode_fn(model, cache, batch) -> (logits, new_cache); batch: tokens
    (B, 1) | embeds (B, 1, d), cache_pos int (+ positions3 (3, B, 1)).
    ``model`` as :func:`make_prefill_step` takes it."""

    def decode_fn(model: Transformer, cache, batch):
        leaf = _sharded_leaf(model)
        if leaf is not None:
            with torch.no_grad():
                return decode_meshed(model, cfg,
                                     _serve_plan(cfg, leaf, batch, True),
                                     cache, batch)
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

    if _sharded_leaf(prefill_cache["layers"]) is not None:
        return _extend_meshed(cfg, prefill_cache, s_max)
    layers = [grown(layer, slot.kind)
              for layer, slot in zip(prefill_cache["layers"],
                                     layer_slots(cfg))]
    return {"layers": layers, "enc_out": prefill_cache.get("enc_out")}


def _extend_meshed(cfg: ModelConfig, prefill_cache, s_max: int):
    """:func:`extend_cache` of a meshed prefill's cache, each layer by its
    kind, laid out by ``cache_specs(seq_len=s_max, batch)``
    (:func:`_to_decode_layout`): the sequence-bearing tensors (K and V,
    ``local_attn``'s, MLA's latent and rotary key, a decoder layer's first
    two slots) padded to ``s_max``; a decoder layer's cross K/V at the
    encoder's length, their heads gathered where the prefill split them;
    the recurrent states, batch-only already, passed through, as is
    ``enc_out``."""
    layers = prefill_cache["layers"]
    leaf = _sharded_leaf(layers)
    specs = cache_specs(layers, leaf.sharding.mesh, seq_len=s_max,
                        batch=leaf.shape[0], cfg=cfg)
    out = []
    for layer, spec, slot in zip(layers, specs, layer_slots(cfg)):
        if not is_attention(slot.kind):
            for t, sp in zip(layer, spec):
                if tuple(t.spec) != tuple(sp):
                    raise ValueError(f"a recurrent state of spec {t.spec!r}"
                                     f", not the decode cache's {sp!r}")
            out.append(tuple(layer))
            continue
        n_self = 2 if slot.kind == "dec_attn_mlp" else len(layer)
        out.append(tuple(
            _to_decode_layout(t, sp, s_max if j < n_self else t.shape[1])
            for j, (t, sp) in enumerate(zip(layer, spec))))
    return {"layers": out, "enc_out": prefill_cache.get("enc_out")}


def _to_decode_layout(st: ShardedTensor, spec, length: int) -> ShardedTensor:
    """A prefill cache tensor (B, S, ...), (B, S, heads, D) with its heads
    over ``model`` or whole, or MLA's (B, S, r), zero-padded along the
    sequence to ``length`` (a decoder layer's cross K/V keep theirs) and
    laid out by ``spec`` (decode's: the same batch blocks, the sequence
    over its spec's axes, the heads whole).  Along each row of ``model``
    entries: split heads take one ``all_to_all`` over ``model`` (each
    entry sends its heads of every sequence chunk and gathers all heads of
    its own chunk), or an all-gather of the heads where the sequence stays
    whole; whole heads are sliced."""
    from repro_torch.launch.mesh import all_to_all, gather_blocks

    mesh = st.sharding.mesh
    src = tuple(st.spec) + (None,) * (4 - len(st.spec))
    if _entry_axes(src[0]) != _entry_axes(spec[0]):
        raise ValueError(f"prefill batch spec {src[0]!r} is not the decode "
                         f"cache's {spec[0]!r}")
    target = NamedSharding(mesh, spec)
    shape = (st.shape[0], length) + tuple(st.shape[2:])
    heads_split = "model" in _entry_axes(src[2])
    seq_model = "model" in _entry_axes(spec[1])
    padded: Dict[int, torch.Tensor] = {}

    def pad(t):
        if id(t) not in padded:
            extra = length - t.shape[1]
            padded[id(t)] = t if extra <= 0 else torch.cat(
                [t, t.new_zeros((t.shape[0], extra) + t.shape[2:])], dim=1)
        return padded[id(t)]

    dims = mesh.devices.shape
    k_model = mesh.axis_names.index("model") if "model" in mesh.shape \
        else None
    made: Dict[tuple, torch.Tensor] = {}
    blocks = [None] * mesh.devices.size
    for i in range(mesh.devices.size):
        if blocks[i] is not None:
            continue
        at = list(np.unravel_index(i, dims))
        row = [i]
        if k_model is not None:
            row = [int(np.ravel_multi_index(
                tuple(at[:k_model] + [m] + at[k_model + 1:]), dims))
                for m in range(dims[k_model])]
        keys = [target.block_index(j) for j in row]
        if all(k in made for k in keys):     # a replica of a row laid out
            for j, k in zip(row, keys):
                blocks[j] = made[k]
            continue
        srcs = [pad(st.blocks[j]) for j in row]
        seqs = [target.block_slices(shape, j)[1] for j in row]
        if heads_split and seq_model:
            got = all_to_all(mesh, "model", [
                t[:, seqs[0].start:seqs[-1].stop] for t in srcs],
                split_axis=1, concat_axis=2)
        elif heads_split:
            whole = gather_blocks(mesh, "model", srcs, dim=2)
            got = [whole[:, sl] for sl in seqs]
        else:
            got = [t[:, sl].clone(memory_format=torch.contiguous_format)
                   for t, sl in zip(srcs, seqs)]
        for j, k, g in zip(row, keys, got):
            blocks[j] = made.setdefault(k, g)
    return ShardedTensor(target, blocks, shape)


def sample_greedy(logits) -> torch.Tensor:
    """(B, S, V) -> (B, 1) int32, the last position's argmax (first index
    on ties, as ``jnp.argmax``).  A meshed step's logits (a
    ``ShardedTensor``, its vocab blocks over ``model``) are gathered at the
    last position first, on the first entry's device."""
    if isinstance(logits, ShardedTensor):
        last = ShardedTensor(logits.sharding,
                             [b[:, -1:] for b in logits.blocks],
                             (logits.shape[0], 1, logits.shape[2]))
        logits = last.unshard()
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
