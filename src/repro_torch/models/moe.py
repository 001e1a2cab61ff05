"""Mixture-of-Experts FFN: top-k routing + capacity-grouped expert GEMMs.

Port of ``src/repro/models/moe.py``, its single-device path.  Dispatch is
sort-based: each (token, expert) routing is ranked within its expert by a
stable sort in token order, routings ranked at or past the capacity ``C``
are dropped, the kept tokens are gathered into a dense (E, C, d) buffer,
run through three batched expert products (``torch.bmm``, SiLU-gated) and
combined back weighted by their renormalised router probabilities.  A
Switch-style load-balancing loss comes back beside the output, and shared
experts (always on) are added when ``n_shared > 0``.

Capacity drops depend on the whole batch, as in the reference: every
token of the call competes for ``C = (T·k·capacity_factor) // E`` slots an
expert, the left-padding of a prefill batch included, and a decode step of
8 slots has a capacity of 1 or 2.  The port keeps that semantics.

Which routings are dropped is exact: the rank comes from a stable
``torch.argsort`` and its inverse permutation.  Kept routings have
distinct slots in the slot-to-token map; the dropped ones all scatter to
one sentinel slot past the end, which is sliced off, so the order in
which a device writes repeated indices changes nothing.  ``torch.topk``'s
order on tied probabilities is unspecified, where ``jax.lax.top_k`` takes
the lower index first; tests compare with routers that have no ties.

The reference's expert-parallel dispatch (``_moe_a2a``, taken only under a
bound production mesh) waits for the sharded trainer (ROADMAP.md §1, item
10.7): the port binds no mesh, so :func:`moe_apply` never needs it.  Its
per-shard capacity ``max(4, ceil(...))`` would drop tokens differently
from this path.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _param, dense_init


def moe_params(cfg: ModelConfig, gen: Optional[torch.Generator],
               device=None) -> dict:
    """Seeded init in the reference's layout: ``router`` (d, E) in float32
    whatever ``param_dtype`` says, the expert stacks ``w_gate``/``w_up``
    (E, d, f) and ``w_down`` (E, f, d), and with shared experts
    ``shared_gate``/``shared_up`` (d, n_shared·f) and ``shared_down``."""
    m = cfg.moe
    d = cfg.d_model
    kw = dict(dtype=cfg.pdtype, device=device)
    p = {
        "router": dense_init(gen, (d, m.n_experts), dtype=torch.float32,
                             device=device),
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_expert), fan_in=d,
                             **kw),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_expert), fan_in=d,
                           **kw),
        "w_down": dense_init(gen, (m.n_experts, m.d_expert, d),
                             fan_in=m.d_expert, **kw),
    }
    if m.n_shared:
        f = m.n_shared * m.d_expert
        p["shared_gate"] = dense_init(gen, (d, f), **kw)
        p["shared_up"] = dense_init(gen, (d, f), **kw)
        p["shared_down"] = dense_init(gen, (f, d), fan_in=f, **kw)
    return p


def moe_capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert for ``t`` tokens, in Python floats as the
    reference computes it."""
    m = cfg.moe
    return int(max(1, (t * m.top_k * m.capacity_factor) // m.n_experts))


def moe_apply(p: Mapping[str, torch.Tensor], cfg: ModelConfig,
              x: torch.Tensor):
    """x: (B, S, d) -> ((B, S, d) in the compute dtype, the router's
    auxiliary loss, a float32 scalar)."""
    m = cfg.moe
    cdt = cfg.cdtype
    b, s, d = x.shape
    t, k, n_e = b * s, m.top_k, m.n_experts
    xf = x.reshape(t, d).to(cdt)

    logits = xf.float() @ p["router"].float()                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                 # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balancing aux loss (Switch-style); adding one float32 value
    # per routing rounds the same in any order
    me = probs.mean(dim=0)
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    ce = torch.zeros(n_e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                              device=x.device))
    aux = n_e * torch.sum(me * ce) * m.router_aux_weight

    capacity = moe_capacity(cfg, t)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)

    # rank within expert via sorted segments
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.zeros(n_e, dtype=flat_e.dtype, device=x.device)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))  # no host sync
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=x.device) - starts[e_sorted]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                   # a permutation: no repeats

    keep = rank < capacity
    n_slots = n_e * capacity
    slot = torch.where(keep, flat_e * capacity + rank, n_slots)
    # dispatch = int32 scatter of token ids + a payload gather.  Kept
    # routings have distinct slots; every dropped one lands on the
    # sentinel slot n_slots, whose (unordered) value is sliced off
    slot_tok = torch.full((n_slots + 1,), t, dtype=torch.int32,
                          device=x.device)
    slot_tok[slot] = flat_tok.to(torch.int32)
    # index_select, not advanced indexing: its backward is an index_add_,
    # where advanced indexing's sort-based accumulate took two thirds of a
    # full-width granite-moe train step's device time on an H100 (PERF.md).
    # On CUDA that index_add_ sums a token's k gradients with atomics in
    # the compute dtype, so a step is not bitwise reproducible run to run;
    # torch.use_deterministic_algorithms(True) makes it so again
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    buf = xf_pad.index_select(0, slot_tok[:-1]).reshape(n_e, capacity, d)

    gate = F.silu(torch.bmm(buf, p["w_gate"].to(cdt)))
    up = torch.bmm(buf, p["w_up"].to(cdt))
    out_flat = torch.bmm(gate * up, p["w_down"].to(cdt)).reshape(n_slots, d)
    gathered = out_flat.index_select(0, slot.clamp(0, n_slots - 1))
    gathered = torch.where(keep[:, None], gathered, gathered.new_zeros(()))
    # entry (t_i, j) of the (t, k, d) view is token t_i's j-th routing
    combined = (gathered.reshape(t, k, d)
                * flat_p.reshape(t, k, 1).to(cdt)).sum(dim=1).to(cdt)

    if m.n_shared:
        g = F.silu(xf @ p["shared_gate"].to(cdt))
        u = xf @ p["shared_up"].to(cdt)
        combined = combined + (g * u) @ p["shared_down"].to(cdt)
    return combined.reshape(b, s, d), aux


class MoE(nn.Module):
    """Holds one layer's expert weights (the :func:`moe_params` layout)
    and applies :func:`moe_apply`; returns ``(out, aux)``."""

    def __init__(self, cfg: ModelConfig, p: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({name: _param(t) for name, t in p.items()})

    def forward(self, x: torch.Tensor):
        return moe_apply(self.p, self.cfg, x)
