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
``arange(S_enc)`` with them.  The sharded step (``micro_batch_axes``)
raises ``NotImplementedError`` (ROADMAP.md §1, item 10).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Transformer, arrays_from_named,
                                            forward, init_params,
                                            load_arrays_,
                                            params_from_arrays)
from .optimizer import AdamW, AdamWState

_NOT_PORTED = "not ported yet (ROADMAP.md §1, item 10, LM substrate)"


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


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params: Transformer, batch):
        inp, labels = _shift_batch(batch, cfg)
        if "positions" not in inp:
            # explicit arange positions: the differentiable attention route
            x = inp["tokens"] if cfg.input_kind == "tokens" else inp["embeds"]
            b, s = x.shape[:2]
            inp = dict(inp, positions=torch.arange(
                s, device=x.device).expand(b, s))
        logits, aux = forward(params, inp)
        if cfg.input_kind != "tokens":
            labels = labels[:, :logits.shape[1]]
        loss = lm_loss(logits, labels, cfg.vocab_size, cfg.z_loss)
        return loss + aux, (loss, aux)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, n_micro: int = 1,
                    micro_batch_axes=None):
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves have leading dim = global_batch; they are split into
    ``n_micro`` microbatches run one after another with float32
    accumulation.  ``micro_batch_axes`` pins the microbatch dim to mesh
    axes in the reference's sharded step; the port's step runs on one
    device, so any value but ``None`` raises ``NotImplementedError``.
    """
    if micro_batch_axes is not None:
        raise NotImplementedError(
            f"make_train_step(micro_batch_axes={micro_batch_axes!r}): the "
            f"sharded train step is {_NOT_PORTED}")
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
    device."""
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
