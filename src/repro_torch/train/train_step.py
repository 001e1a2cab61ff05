"""Training step: loss, microbatch gradient accumulation, train state.

Port of ``src/repro/train/train_step.py``.  ``make_train_step`` builds the
step the launcher runs: a loop over ``n_micro`` microbatches (each
checkpointed per block as ``cfg.remat`` says), float32 gradient
accumulation as ``g / n_micro`` in the reference's order, clipping and the
AdamW update.  The state's parameters are the model itself
(``repro_torch.models.transformer.Transformer``), its gradients turned on;
the optimizer's moments are dicts keyed by the model's parameter names.
The step writes the new weights into the model and returns it in the new
state: the state passed in is consumed, as the reference's jitted step
donates it.

The training forward passes explicit positions ``arange(S)``, which take
``_sdpa_masked``, as the reference's training forward does: the flash
kernel is forward only; an encoder-decoder's encoder gets explicit
``arange(S_enc)`` with them.

**The meshed step** (``micro_batch_axes``, e.g. ``("data",)`` or
``("pod", "data")``) takes a state whose leaves are
:class:`~repro_torch.dist.sharding.ShardedTensor`s in the reference's
layout (:func:`shard_train_state`): the parameters and both moments as
``shard_params(..., fsdp=True)`` lays them out, one block per entry of the
mesh.  Each microbatch (``B / n_micro`` rows) is split again over the
microbatch axes, major-to-minor, so each data entry takes ``B / (n_micro ·
dp)`` rows of it, never the whole microbatch (the reference's docstring
names the "16x FLOP inflation" of that bug).  The forward runs each layer
once an entry over one autograd graph
(:func:`~repro_torch.models.transformer.forward_meshed`): the weights are
gathered per layer over ``data`` and the backward reduce-scatters their
gradients to the blocks; heads, MLP, vocab and experts split over
``model``.  The loss is the mean over the data entries of each one's
vocab-parallel cross-entropy (:func:`lm_loss_meshed`), the gradients of
every block accumulate in float32 over the microbatches, and AdamW updates
the blocks (``train/optimizer.py``).  The entries run one after another on
the current stream: autograd releases a saved tensor once its backward
node is queued, not once the node's stream has run it, so an entry stream
that read a tensor of another stream could see its memory reused early.
Every family trains on a mesh, its batches as the unmeshed step takes
them (``tokens``; ``embeds``, ``labels`` and ``positions3`` for qwen2-vl;
``enc_embeds`` beside ``tokens`` for whisper).  A mesh whose entries sit
on more than one device raises ``NotImplementedError`` (the transport
between cards, ROADMAP.md §1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, to_host
from repro_torch.dist.sharding import (P, ShardedTensor, shard_tree,
                                       shardings_from_specs,
                                       tree_flatten_with_path,
                                       tree_unflatten, unshard_tree)
from repro_torch.launch.mesh import all_gather, psum
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MeshPlan
from repro_torch.obs.trace import span
from repro_torch.models.transformer import (Transformer, _stand_in,
                                            arrays_from_named,
                                            forward, forward_meshed,
                                            init_params, load_arrays_,
                                            params_from_arrays)
from .optimizer import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Cross-entropy over the unpadded vocab + z-loss regularizer."""
    v_pad = logits.shape[-1]
    if v_pad > vocab_size:
        pad_mask = torch.arange(v_pad, device=logits.device) >= vocab_size
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(logz - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(logz))
    return loss


def _shift_batch(batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """inputs = tokens[:, :-1]; labels = tokens[:, 1:] (token models);
    embedding-input models carry explicit labels."""
    if cfg.input_kind != "tokens":
        return batch, batch["labels"]
    toks = batch["tokens"]
    inp = dict(batch, tokens=toks[:, :-1])
    if "positions" in batch:
        inp["positions"] = batch["positions"][:, :-1]
    return inp, toks[:, 1:]


def _step_inputs(batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """A training forward's inputs and labels: :func:`_shift_batch`, then
    explicit ``positions`` ``arange(S)`` unless given (the differentiable
    attention route; S and the rows from ``tokens``, or ``embeds`` for an
    embedding-input model), and an embedding-input model's labels cut to
    the logits' length S, as the reference's loss cuts them."""
    inp, labels = _shift_batch(batch, cfg)
    x = inp["tokens"] if cfg.input_kind == "tokens" else inp["embeds"]
    b, s = x.shape[:2]
    if "positions" not in inp:
        inp = dict(inp, positions=torch.arange(s, device=x.device).expand(
            b, s))
    if cfg.input_kind != "tokens":
        labels = labels[:, :s]
    return inp, labels


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params: Transformer, batch):
        inp, labels = _step_inputs(batch, cfg)
        logits, aux = forward(params, inp)
        loss = lm_loss(logits, labels, cfg.vocab_size, cfg.z_loss)
        return loss + aux, (loss, aux)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, n_micro: int = 1,
                    micro_batch_axes=None):
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves have leading dim = global_batch; they are split into
    ``n_micro`` microbatches run one after another with float32
    accumulation, each inside a ``train/micro`` span (``i``: its index),
    which the dry-run's trace reads to weight one microbatch by
    ``n_micro``.  ``micro_batch_axes`` (a mesh axis name or tuple) makes
    it the meshed step (module docstring), which takes a sharded state
    (:func:`shard_train_state`) and splits each microbatch over those
    axes.
    """
    if micro_batch_axes is not None:
        return _make_meshed_step(cfg, opt, n_micro, micro_batch_axes)
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, batch):
        model = state.params
        named = dict(model.named_parameters())
        params = list(named.values())
        micro = {}
        for k, v in batch.items():
            # positions3 (3, B, S) has the batch on axis 1
            ax = 1 if k == "positions3" else 0
            b = v.shape[ax]
            if b % n_micro:
                raise ValueError(f"batch {b} does not split into {n_micro} "
                                 f"microbatches")
            m = v.reshape(v.shape[:ax] + (n_micro, b // n_micro)
                          + v.shape[ax + 1:])
            micro[k] = m.movedim(ax, 0)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        loss_acc, aux_acc = zero, zero
        for i in range(n_micro):
            with span("train/micro", i=i):
                mb = {k: v[i] for k, v in micro.items()}
                tot, (loss, aux) = loss_fn(model, mb)
                g = torch.autograd.grad(tot, params)
                with torch.no_grad():
                    g = [t.float() for t in g]
                    torch._foreach_div_(g, n_micro)
                    torch._foreach_add_(grads, g)
                del g, tot
                loss_acc = loss_acc + loss.detach() / n_micro
                aux_acc = aux_acc + aux.detach() / n_micro
        names = list(named)
        new_params, new_opt, gnorm = opt.update(
            dict(zip(names, grads)), state.opt,
            {n: p.detach() for n, p in named.items()})
        del grads
        with torch.no_grad():
            torch._foreach_copy_(params, [new_params[n] for n in names])
        metrics = {"loss": loss_acc, "aux_loss": aux_acc, "grad_norm": gnorm,
                   "lr": opt.lr(new_opt.step)}
        return TrainState(params=model, opt=new_opt), metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt: AdamW, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """Seeded init (``init_params``'s generator; the reference takes a jax
    key) on the card, or where ``device`` says, with gradients on."""
    model = init_params(cfg, seed, device).requires_grad_(True)
    return TrainState(params=model,
                      opt=opt.init(dict(model.named_parameters())))


def train_state_to_arrays(state: TrainState,
                          shapes_only: bool = False) -> TrainState:
    """The state in the reference's layout, as numpy arrays on the host:
    ``params`` and the moments as the reference's parameter tree
    (each layer's weights in its plan group, stacked on ``repeats``) and
    ``opt.step`` a 0-d int32 array, so a checkpoint of it is the
    reference's leaf for leaf.  With ``shapes_only`` every leaf is a zero-stride stand-in of its
    shape and dtype: a restore template that copies nothing off the
    device.  A meshed state (:func:`shard_train_state`) is the reference's
    layout already: its leaves are gathered whole."""
    if not isinstance(state.params, Transformer):
        # a meshed state: the reference's layout already, sharded
        flat, treedef = tree_flatten_with_path(state)
        return tree_unflatten(treedef, [
            _stand_in(st.blocks[0].new_empty(st.shape, device="meta"))
            if shapes_only else to_host(st.unshard()) for _, st in flat])
    opt, cfg = state.opt, state.params.cfg
    step = np.zeros((), dtype=np.int32) if shapes_only \
        else np.asarray(int(opt.step), dtype=np.int32)
    return TrainState(
        params=arrays_from_named(dict(state.params.named_parameters()), cfg,
                                 shapes_only),
        opt=AdamWState(step=step,
                       m=arrays_from_named(opt.m, cfg, shapes_only),
                       v=arrays_from_named(opt.v, cfg, shapes_only)))


def load_train_state_(state: TrainState, tree) -> TrainState:
    """Copy a state in the reference's layout (a restored checkpoint of
    either package) into ``state``'s tensors in place; returns ``state``."""
    cfg = state.params.cfg
    load_arrays_(dict(state.params.named_parameters()), tree.params, cfg)
    _load_opt_(state.opt, tree.opt, cfg)
    return state


def _load_opt_(opt: AdamWState, tree: AdamWState, cfg: ModelConfig) -> None:
    load_arrays_(opt.m, tree.m, cfg)
    load_arrays_(opt.v, tree.v, cfg)
    opt.step.fill_(int(np.asarray(tree.step)))


def train_state_from_arrays(cfg: ModelConfig, tree,
                            device: DeviceLike = None) -> TrainState:
    """The inverse of :func:`train_state_to_arrays`: a trainable model and
    its AdamW state on ``device`` from the reference's layout."""
    model = params_from_arrays(cfg, tree.params, device).requires_grad_(True)
    named = dict(model.named_parameters())
    state = TrainState(params=model, opt=AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=model.device),
        m={n: torch.empty(p.shape, dtype=torch.float32, device=p.device)
           for n, p in named.items()},
        v={n: torch.empty(p.shape, dtype=torch.float32, device=p.device)
           for n, p in named.items()}))
    _load_opt_(state.opt, tree.opt, cfg)
    return state


# ---------------------------------------------------------------------------
# The meshed step
# ---------------------------------------------------------------------------

def lm_loss_meshed(plan: MeshPlan, logits, labels, vocab_size: int,
                   z_loss: float = 1e-4) -> torch.Tensor:
    """:func:`lm_loss` over the mesh: ``logits`` has, for each data entry,
    the float32 logits of each model entry's vocab block; ``labels`` one
    (B_d, S) tensor a data entry.  Each model entry masks its padded
    columns, takes its block's log-sum-exp and its labels' logits (0 for
    a label outside the block); the log-sum-exps are gathered over
    ``model`` and the label logits ``psum``-ed.  The loss is the mean over
    the data entries of their losses (equal counts: the microbatch's
    mean)."""
    losses = []
    for blocks, lab in zip(logits, labels):
        v_m = blocks[0].shape[-1]
        lses, lls = [], []
        for j, lg in enumerate(blocks):
            lo = j * v_m
            if lo + v_m > vocab_size:
                col = torch.arange(lo, lo + v_m, device=lg.device)
                lg = torch.where((col >= vocab_size)[None, None, :], -1e30,
                                 lg)
            lses.append(torch.logsumexp(lg, dim=-1))
            local = lab.long() - lo
            inside = (local >= 0) & (local < v_m)
            got = torch.gather(lg, -1, local.clamp(0, v_m - 1)[..., None])
            lls.append(torch.where(inside, got[..., 0], 0.0))
        if len(blocks) > 1:
            logz = torch.logsumexp(all_gather(plan.mesh, "model", lses),
                                   dim=0)
            ll = psum(plan.mesh, "model", lls)
        else:
            logz, ll = lses[0], lls[0]
        loss = torch.mean(logz - ll)
        if z_loss:
            loss = loss + z_loss * torch.mean(torch.square(logz))
        losses.append(loss)
    return plan.psum_data(losses) / plan.dp


def split_micro(batch: Dict[str, torch.Tensor], n_micro: int, dp: int):
    """``batch`` as ``n_micro`` microbatches of ``dp`` data entries each:
    microbatch ``i`` is rows ``[i·B/n_micro, (i+1)·B/n_micro)`` (the
    reference's reshape), and data entry ``d`` of it its ``d``-th block of
    ``B / (n_micro · dp)`` rows.  ``positions3`` has its batch on axis 1."""
    out = [[{} for _ in range(dp)] for _ in range(n_micro)]
    for k, v in batch.items():
        ax = 1 if k == "positions3" else 0
        b = v.shape[ax]
        if b % (n_micro * dp):
            raise ValueError(f"batch {b} does not split into {n_micro} "
                             f"microbatches of {dp} data entries")
        rows = b // (n_micro * dp)
        for i in range(n_micro):
            for d in range(dp):
                out[i][d][k] = v.narrow(ax, (i * dp + d) * rows, rows)
    return out


def _make_meshed_step(cfg: ModelConfig, opt: AdamW, n_micro: int,
                      micro_batch_axes):
    def train_step(state: TrainState, batch):
        params = state.params
        leaves = [leaf for _, leaf in tree_flatten_with_path(params)[0]]
        if not leaves or not all(isinstance(x, ShardedTensor)
                                 for x in leaves):
            raise ValueError(
                "the meshed train step (micro_batch_axes) takes a state "
                "sharded over a mesh (shard_train_state)")
        mesh = leaves[0].sharding.mesh
        devices = {str(d) for d in mesh.devices.flat}
        if len(devices) > 1:
            raise NotImplementedError(
                f"a mesh over {sorted(devices)}: entries on more than one "
                f"device wait for the transport between cards (ROADMAP.md "
                f"§1, item 5)")
        plan = MeshPlan(mesh, micro_batch_axes)
        blocks = [b for st in leaves for b in st.distinct()]
        for b in blocks:
            b.requires_grad_(True)
        grads = [torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                 for b in blocks]
        dev = plan.device()
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        aux_acc = loss_acc
        for i, parts in enumerate(split_micro(batch, n_micro, plan.dp)):
            with span("train/micro", i=i):
                inputs, labels = zip(*(_step_inputs(part, cfg)
                                       for part in parts))
                logits, aux = forward_meshed(params, cfg, plan, inputs)
                loss = lm_loss_meshed(plan, logits, labels, cfg.vocab_size,
                                      cfg.z_loss)
                del logits
                g = torch.autograd.grad(loss + aux, blocks,
                                        allow_unused=True)
                with torch.no_grad():
                    for acc, t in zip(grads, g):
                        if t is not None:
                            acc.add_(t.float() / n_micro)
                del g
                loss_acc = loss_acc + loss.detach() / n_micro
                aux_acc = aux_acc + aux.detach() / n_micro
        for b in blocks:
            b.requires_grad_(False)
        it = iter(grads)
        gtree = tree_unflatten(tree_flatten_with_path(params)[1], [
            st.with_blocks([next(it) for _ in st.distinct()])
            for st in leaves])
        new_params, new_opt, gnorm = opt.update(gtree, state.opt, params)
        metrics = {"loss": loss_acc, "aux_loss": aux_acc, "grad_norm": gnorm,
                   "lr": opt.lr(new_opt.step.blocks[0])}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def train_state_specs(cfg: ModelConfig, mesh):
    """The meshed state's specs in the reference's layout (its launcher's
    ``sspecs``): the parameters' and both moments' ``shard_params(...,
    fsdp=True)`` specs, the step replicated; and ``shard_params``'s
    report."""
    from repro_torch.dist.sharding import shard_params

    pspecs, report = shard_params(train_state_template(cfg).params, mesh,
                                  fsdp=True,
                                  heads={"q": cfg.n_heads,
                                         "kv": cfg.n_kv_heads})
    return TrainState(params=pspecs, opt=AdamWState(step=P(), m=pspecs,
                                                    v=pspecs)), report


def train_state_template(cfg: ModelConfig) -> TrainState:
    """The state of ``cfg`` in the reference's layout as zero-stride
    stand-ins (the parameters in ``param_dtype``, the moments float32, the
    step int32): a restore template that allocates nothing."""
    from repro_torch.models.transformer import _param_tree

    model = Transformer(cfg, _param_tree(cfg, None, torch.device("meta")))
    shapes = arrays_from_named(dict(model.named_parameters()), cfg,
                               shapes_only=True)
    flat, treedef = tree_flatten_with_path(shapes)
    moments = tree_unflatten(treedef, [
        np.broadcast_to(np.zeros((), np.float32), a.shape) for _, a in flat])
    return TrainState(params=shapes, opt=AdamWState(
        step=np.zeros((), dtype=np.int32), m=moments, v=moments))


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """The one-device ``state`` of :func:`init_train_state` laid out on
    ``mesh`` by :func:`train_state_specs` (``jax.device_put(state, ssh)``
    of the reference's launcher): the state in the reference's layout,
    each leaf sharded from the tensors on their device."""
    cfg = state.params.cfg
    specs, _ = train_state_specs(cfg, mesh)
    sh = shardings_from_specs(specs, mesh)
    opt = state.opt

    def part(named, shardings):
        # one tree at a time: its stacked copy is freed before the next
        return shard_tree(arrays_from_named(named, cfg, on_device=True),
                          shardings)

    return TrainState(
        params=part(dict(state.params.named_parameters()), sh.params),
        opt=AdamWState(step=sh.opt.step.shard(opt.step),
                       m=part(opt.m, sh.opt.m), v=part(opt.v, sh.opt.v)))


def gathered_model(cfg: ModelConfig, state: TrainState) -> Transformer:
    """The whole model of ``cfg`` from a meshed state (its parameters
    gathered), on its first entry's device, gradients off: what the TDA
    monitor reads."""
    tree = unshard_tree(state.params)
    return params_from_arrays(cfg, tree, tree["embed"]["table"].device)
