"""Per-cell build: (arch × input-shape × mesh) -> the port's step, fake
inputs and shardings (port of ``src/repro/launch/specs.py``).

Shape semantics, as the reference's: ``train_*`` builds the train step;
``prefill_*`` the batched prefill; ``decode_*`` / ``long_*`` the one-token
decode step against a cache of ``seq_len``.  Whisper (enc-dec) splits
every cell's budget S into S_enc = S_dec = S/2; VLM cells feed
precomputed patch embeddings and (3, B, S) M-RoPE grids.

Where the reference builds ``jax.ShapeDtypeStruct``s and ``jax.eval_shape``
trees, the port builds fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): tensors with a shape,
a dtype and a device, and no memory.  Nothing here allocates.  Every
function that makes tensors makes them in the fake mode that is active,
or in a new one; :func:`build_cell` makes one for the cell and keeps it in
:attr:`Cell.fake_mode`, so that ``launch/dryrun.py`` runs the step in the
mode its arguments were made in.  jnp's ``int32`` is ``torch.int32`` and
``cfg.cdtype`` the port's compute dtype.

The mesh is the port's :class:`~repro_torch.launch.mesh.Mesh`, and the
cell's tensors live on its first entry's device.  A mesh of one entry
gives the unmeshed step (what one card runs); a mesh of several entries
gives the meshed train step over a state that
:func:`~repro_torch.train.train_step.shard_train_state` lays out as
``ShardedTensor``s, and the meshed prefill and decode steps of the GQA and
MoE decoders over the reference's parameter tree laid out by
``shard_params(..., fsdp=False)``; the decode cell's cache is laid out by
``cache_specs`` (the reference's ``in_shardings`` and ``out_shardings``).
A serving cell of another family on a mesh of several entries raises
``NotImplementedError``, naming ROADMAP.md item 12.

The port's decode step reads ``cache_pos`` on the host (``int()``), so
the decode cell's ``cache_pos`` is a constant fake tensor: the last slot
of the cache.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.dist.sharding import (NamedSharding, P, activation_rules,
                                       batch_specs, bind_activation_rules,
                                       cache_specs, shard_params, shard_tree,
                                       shardings_from_specs,
                                       tree_flatten_with_path, tree_path_str,
                                       tree_unflatten)
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (arrays_from_named,
                                            check_meshed_serving, init_params,
                                            make_cache)
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          shard_train_state,
                                          train_state_specs)


def _fake():
    """The active fake mode, or a new one, as a context."""
    mode = detect_fake_mode()
    return contextlib.nullcontext(mode) if mode is not None \
        else FakeTensorMode()


def sds(shape, dtype, device=None) -> torch.Tensor:
    """A fake tensor of ``shape`` and ``dtype`` (``jax.ShapeDtypeStruct``)."""
    with _fake():
        return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                           device=device)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, kind: str, seq_len: int, batch: int,
                device=None) -> Dict[str, Any]:
    """Fake stand-ins for the model's *data* inputs, on ``device`` (the
    card by default; the fake mode needs no card)."""
    i32 = torch.int32
    d = cfg.d_model

    def s(shape, dtype):
        return sds(shape, dtype, device)

    if cfg.enc_dec:
        s_enc = seq_len // 2
        s_dec = seq_len // 2
        if kind == "train":
            return {"tokens": s((batch, s_dec + 1), i32),
                    "enc_embeds": s((batch, s_enc, d), cfg.cdtype)}
        if kind == "prefill":
            return {"tokens": s((batch, s_dec), i32),
                    "enc_embeds": s((batch, s_enc, d), cfg.cdtype)}
        # decode: one decoder token; cross-attends cached encoder output
        return {"tokens": s((batch, 1), i32), "cache_pos": s((), i32)}
    if cfg.input_kind != "tokens":                    # vlm: patch embeddings
        if kind == "train":
            out = {"embeds": s((batch, seq_len, d), cfg.cdtype),
                   "labels": s((batch, seq_len), i32)}
        elif kind == "prefill":
            out = {"embeds": s((batch, seq_len, d), cfg.cdtype)}
        else:
            out = {"embeds": s((batch, 1, d), cfg.cdtype),
                   "cache_pos": s((), i32)}
        n = seq_len if kind in ("train", "prefill") else 1
        if cfg.rope_kind == "mrope":
            out["positions3"] = s((3, batch, n), i32)
        return out
    if kind == "train":
        return {"tokens": s((batch, seq_len + 1), i32)}
    if kind == "prefill":
        return {"tokens": s((batch, seq_len), i32)}
    return {"tokens": s((batch, 1), i32), "cache_pos": s((), i32)}


def cache_shapes(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """The decode cache of ``make_cache`` as fake tensors (no allocation):
    one tuple a layer in the port's layout (``init_cache``)."""
    s_cache = s_max // 2 if cfg.enc_dec else s_max
    with _fake():
        # enc-dec decode reads cached cross-K/V (computed at prefill), so
        # the raw encoder output no longer rides in the decode cache
        return make_cache(cfg, batch, s_cache, device, enc_out=None)


# ---------------------------------------------------------------------------
# parameter / FLOP accounting
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def param_shapes(cfg: ModelConfig):
    """The reference's parameter tree of ``cfg`` as zero-stride stand-ins
    (``init_params`` run in a fake mode, laid out by
    ``arrays_from_named``)."""
    with FakeTensorMode():
        model = init_params(cfg, 0, "cpu")
        return arrays_from_named(dict(model.named_parameters()), cfg,
                                 shapes_only=True)


def count_params(cfg: ModelConfig) -> Dict[str, float]:
    """total / embedding / routed-expert / active parameter counts."""
    shapes = param_shapes(cfg)
    flat = tree_flatten_with_path(shapes)[0]
    total = emb = routed = 0
    for kp, leaf in flat:
        path = tree_path_str(kp)
        n = int(np.prod(leaf.shape))
        total += n
        name = path.split("/")[-1]
        if path in ("embed/table", "lm_head/table"):
            emb += n
        elif name in ("w_gate", "w_up", "w_down") and leaf.ndim >= 4:
            routed += n          # stacked (reps, E, d, f) routed experts
    active = total
    if cfg.moe is not None and routed:
        frac = cfg.moe.top_k / cfg.moe.n_experts
        active = total - routed * (1.0 - frac)
    return {"total": float(total), "embedding": float(emb),
            "routed_expert": float(routed), "active": float(active)}


def model_flops(cfg: ModelConfig, kind: str, seq_len: int, batch: int
                ) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference), with
    N = non-embedding active params and D = processed tokens."""
    c = count_params(cfg)
    n = c["active"] - c["embedding"]
    if cfg.enc_dec:
        tokens = batch * (seq_len // 2) if kind != "decode" else batch
    elif kind == "decode":
        tokens = batch
    else:
        tokens = batch * seq_len
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# per-cell assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """The reference's cell, and the fake mode its ``args`` were made in.
    A train cell of several microbatches also carries ``micro``: the same
    step built for one microbatch and its arguments (the state, and the
    first microbatch's rows as views of the batch), which the dry-run
    traces and weights by ``n_micro``."""

    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    fn: Callable                    # the step
    args: Tuple[Any, ...]           # fake-tensor trees
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    meta: Dict[str, Any]
    static_argnums: Tuple[int, ...] = ()
    donate_argnums: Tuple[int, ...] = ()
    fake_mode: Optional[FakeTensorMode] = None
    micro: Optional[Tuple[Callable, Tuple[Any, ...]]] = None


def _dp_size(mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in ("pod", "data")
                        if a in mesh.axis_names]))


def train_micro(cfg: ModelConfig, mesh, global_batch: int) -> int:
    """Microbatch count: per-device-per-micro batch of 1 (max remat win),
    subject to (B / n_micro) % dp == 0."""
    dp = _dp_size(mesh)
    n_micro = max(1, global_batch // dp)
    while global_batch % n_micro or (global_batch // n_micro) % dp:
        n_micro -= 1
    return n_micro


def first_micro(batch: Dict[str, torch.Tensor], n_micro: int
                ) -> Dict[str, torch.Tensor]:
    """The first of ``n_micro`` microbatches of ``batch``: views of its
    first ``B / n_micro`` rows (``positions3`` has its batch on axis 1)."""
    out = {}
    for k, v in batch.items():
        ax = 1 if k == "positions3" else 0
        out[k] = v.narrow(ax, 0, v.shape[ax] // n_micro)
    return out


def _replicated(tree, mesh):
    flat, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [NamedSharding(mesh, P())
                                    for _ in flat])


def build_cell(arch: str, shape: str, mesh: Mesh,
               overrides: Optional[dict] = None) -> Cell:
    spec = SHAPES[shape]
    kind, seq_len, batch = spec["kind"], spec["seq_len"], spec["global_batch"]
    cfg = get_config(arch)
    force_n_micro = None
    if overrides:
        overrides = dict(overrides)
        force_n_micro = overrides.pop("n_micro", None)
        cfg = dataclasses.replace(cfg, **overrides)
    meta: Dict[str, Any] = dict(
        arch=arch, shape=shape, kind=kind, seq_len=seq_len,
        global_batch=batch, params=count_params(cfg),
        model_flops=model_flops(cfg, kind, seq_len, batch))
    heads = {"q": cfg.n_heads, "kv": cfg.n_kv_heads}
    act_rules = activation_rules(cfg, mesh, decode=(kind == "decode"),
                                 batch=batch)
    meta["activation_rules"] = {k: str(v) for k, v in act_rules.items()}
    device = mesh.devices.flat[0]
    meshed = mesh.devices.size > 1
    mode = FakeTensorMode()

    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=cfg.remat if cfg.remat != "none"
                                  else "full")
        n_micro = force_n_micro or train_micro(cfg, mesh, batch)
        meta["n_micro"] = n_micro
        opt = AdamW(lr=warmup_cosine(3e-4, 100, 10_000))
        dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)

        def step(n):
            return bind_activation_rules(make_train_step(
                cfg, opt, n_micro=n,
                micro_batch_axes=dp_axes if meshed else None), act_rules)

        with mode:
            state = init_train_state(cfg, opt, 0, device)
            if meshed:
                state = shard_train_state(state, mesh)
            batch_shapes = input_specs(cfg, "train", seq_len, batch, device)
            micro = None
            if n_micro > 1:
                micro = (step(1), (state, first_micro(batch_shapes,
                                                      n_micro)))
        _, report = shard_params(param_shapes(cfg), mesh, fsdp=True,
                                 heads=heads)
        meta["sharding_report"] = report
        state_sh = shardings_from_specs(train_state_specs(cfg, mesh)[0],
                                        mesh)
        batch_sh = shardings_from_specs(batch_specs(batch_shapes, mesh),
                                        mesh)
        return Cell(arch=arch, shape=shape, kind=kind, fn=step(n_micro),
                    args=(state, batch_shapes),
                    in_shardings=(state_sh, batch_sh),
                    out_shardings=(state_sh, None), meta=meta,
                    donate_argnums=(0,), fake_mode=mode, micro=micro)

    if meshed:
        check_meshed_serving(cfg)
    pspecs, report = shard_params(param_shapes(cfg), mesh, fsdp=False,
                                  heads=heads)
    meta["sharding_report"] = report
    param_sh = shardings_from_specs(pspecs, mesh)

    def served(model):
        # the meshed steps take the reference's tree of ShardedTensors
        if not meshed:
            return model
        return shard_tree(arrays_from_named(dict(model.named_parameters()),
                                            cfg, on_device=True), param_sh)

    if kind == "prefill":
        step_fn = bind_activation_rules(make_prefill_step(cfg), act_rules)
        with mode:
            params = served(init_params(cfg, 0, device))
            batch_shapes = input_specs(cfg, "prefill", seq_len, batch,
                                       device)
        batch_sh = shardings_from_specs(batch_specs(batch_shapes, mesh),
                                        mesh)
        return Cell(arch=arch, shape=shape, kind=kind, fn=step_fn,
                    args=(params, batch_shapes),
                    in_shardings=(param_sh, batch_sh),
                    out_shardings=None, meta=meta, fake_mode=mode)

    # decode / long: one token against a seq_len cache
    step_fn = bind_activation_rules(make_decode_step(cfg), act_rules)
    s_cache = seq_len // 2 if cfg.enc_dec else seq_len
    with mode:
        params = served(init_params(cfg, 0, device))
        cshapes = cache_shapes(cfg, batch, seq_len, device)
        batch_shapes = input_specs(cfg, "decode", seq_len, batch, device)
        batch_shapes["cache_pos"] = torch.tensor(s_cache - 1,
                                                 dtype=torch.int32)
        if meshed:
            layer_sh = shardings_from_specs(cache_specs(
                cshapes["layers"], mesh, seq_len=s_cache, batch=batch,
                cfg=cfg), mesh)
            cshapes = {"layers": shard_tree(cshapes["layers"], layer_sh),
                       "enc_out": None}
    if meshed:
        # enc_out is None: a P() prefix leaf, as the reference's
        cache_sh = {"layers": layer_sh, "enc_out": NamedSharding(mesh, P())}
    else:
        cache_sh = _replicated(cshapes, mesh)
    batch_sh = shardings_from_specs(batch_specs(batch_shapes, mesh), mesh)
    return Cell(arch=arch, shape=shape, kind=kind, fn=step_fn,
                args=(params, cshapes, batch_shapes),
                in_shardings=(param_sh, cache_sh, batch_sh),
                out_shardings=(None, cache_sh), meta=meta,
                donate_argnums=(1,), fake_mode=mode)
