"""Native AdamW + warmup-cosine schedule + global-norm clipping.

Port of ``src/repro/train/optimizer.py``.  The optimizer state is a tree of
float32 tensors that mirrors the parameter tree (the trainer's is a dict
keyed by the model's parameter names), and the update is functional, as
the reference's: ``update`` returns new parameters and a new state and
leaves its arguments as they were.  The arithmetic is the reference's,
step for step in float32, over ``torch._foreach_*`` lists: clipping,
bias correction, decoupled weight decay, and the schedule evaluated on the
0-d int32 step.

Over a mesh the trees' leaves are
:class:`~repro_torch.dist.sharding.ShardedTensor`s (the parameters, their
gradients and both moments laid out alike, ``shard_params(...,
fsdp=True)``'s specs) and the update runs on the local blocks, each
distinct block once.  The clip's global norm is built as a mesh builds
it: each entry sums the squares of the gradient blocks it owns (a block
that several entries hold is owned by the first, so a replicated leaf
counts once), and the entries' sums are ``psum``-ed over every mesh axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.dist.sharding import (ShardedTensor, tree_flatten_with_path,
                                       tree_unflatten)


# The most elements :meth:`AdamW._adamw` updates together (1 GiB of
# float32).
_CHUNK = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _leaves(tree):
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        flat, treedef = tree_flatten_with_path(params)
        leaves = [p for _, p in flat]
        dev = leaves[0].device if leaves else None

        def zeros():
            return tree_unflatten(treedef, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves])

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=zeros(), v=zeros())

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        flat, treedef = tree_flatten_with_path(params)
        p = [leaf for _, leaf in flat]
        g, m, v = _leaves(grads), _leaves(state.m), _leaves(state.v)
        if p and isinstance(p[0], ShardedTensor):
            gnorm = sharded_global_norm(g)
            step = state.step.blocks[0] + 1
            blocks = [[b for st in tree for b in st.distinct()]
                      for tree in (g, m, v, p)]
            new_p, m2, v2 = self._adamw(*blocks, gnorm, step)

            def back(leaves, new):
                it, out = iter(new), []
                for st in leaves:
                    out.append(st.with_blocks([next(it) for _ in
                                               st.distinct()]))
                return tree_unflatten(treedef, out)

            return (back(p, new_p),
                    AdamWState(step=state.step.with_blocks([step]),
                               m=back(m, m2), v=back(v, v2)),
                    gnorm)
        g = [t.float() for t in g]
        gnorm = global_norm(g)
        step = state.step + 1
        new_p, m, v = self._adamw(g, m, v, p, gnorm, step)
        return (tree_unflatten(treedef, new_p),
                AdamWState(step=step, m=tree_unflatten(treedef, m),
                           v=tree_unflatten(treedef, v)),
                gnorm)

    def _adamw(self, g, m, v, p, gnorm, step):
        """The update on flat lists: clipping by ``gnorm``, bias correction
        at ``step`` (the new step), decoupled weight decay.  Returns new
        lists ``(p, m, v)``.  It runs on runs of tensors of at most
        ``_CHUNK`` elements together (a larger tensor alone), so that its
        float32 temporaries stay a chunk's, not the state's; the
        arithmetic is elementwise, the same in any grouping."""
        out = ([], [], [])
        lo = 0
        while lo < len(p):
            hi, n = lo + 1, p[lo].numel()
            while hi < len(p) and n + p[hi].numel() <= _CHUNK:
                n += p[hi].numel()
                hi += 1
            for acc, got in zip(out, self._adamw_lists(
                    g[lo:hi], m[lo:hi], v[lo:hi], p[lo:hi], gnorm, step)):
                acc.extend(got)
            lo = hi
        return out

    def _adamw_lists(self, g, m, v, p, gnorm, step):
        g = [t.float() for t in g]
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            g = torch._foreach_mul(g, scale)
        sf = step.float()
        b1c = 1.0 - torch.pow(self.b1, sf)
        b2c = 1.0 - torch.pow(self.b2, sf)
        lr = self.lr(step)

        p32 = [t.float() for t in p]
        m = torch._foreach_mul(m, self.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - self.b1))
        gg = torch._foreach_mul(g, 1 - self.b2)
        torch._foreach_mul_(gg, g)
        v = torch._foreach_mul(v, self.b2)
        torch._foreach_add_(v, gg)
        del gg, g
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        delta = torch._foreach_div(m, b1c)
        torch._foreach_div_(delta, den)
        del den
        torch._foreach_add_(delta, torch._foreach_mul(p32, self.weight_decay))
        torch._foreach_mul_(delta, lr)
        new_p = [(a - d).to(t.dtype) for a, d, t in zip(p32, delta, p)]
        return new_p, m, v


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def sharded_global_norm(leaves) -> torch.Tensor:
    """The global norm of a list of sharded gradient leaves: each mesh
    entry's sum of squares over the blocks it owns (the first entry that
    holds a block owns it), ``psum``-ed over every mesh axis, innermost
    first."""
    from repro_torch.launch.mesh import psum

    mesh = leaves[0].sharding.mesh
    dev = leaves[0].blocks[0].device
    local = [torch.zeros((), dtype=torch.float32, device=dev)
             for _ in range(mesh.devices.size)]
    for st in leaves:
        owned = set()
        for i, b in enumerate(st.blocks):
            key = st.sharding.block_index(i)
            if key not in owned:
                owned.add(key)
                local[i] = local[i] + torch.sum(torch.square(b.float()))
    for axis in reversed(mesh.axis_names):
        n = mesh.shape[axis]
        local = [psum(mesh, axis, local[i:i + n])
                 for i in range(0, len(local), n)]
    return torch.sqrt(local[0])


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
