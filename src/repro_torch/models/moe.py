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

Over a mesh (the meshed train step, ``models/transformer.py``'s
:func:`~repro_torch.models.transformer.forward_meshed`) the layer is
:func:`moe_meshed`.  With ``expert`` bound to ``model`` it takes the
reference's explicit expert-parallel dispatch, :func:`_moe_a2a`, under the
reference's condition (more than one data entry, the tokens splitting over
them): each shard groups its own tokens at the per-shard capacity
``max(4, ceil(...))``, which drops other routings than this path's global
capacity, exactly as the reference's does (ROADMAP.md §3).  Otherwise it
runs this path's dispatch over the whole microbatch.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
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
    probs, top_p, top_e = _route(cfg, p["router"], xf)          # (T, k)

    # load-balancing aux loss (Switch-style); adding one float32 value
    # per routing rounds the same in any order
    me = probs.mean(dim=0)
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    ce = torch.zeros(n_e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e, torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32,
                              device=x.device))
    aux = n_e * torch.sum(me * ce) * m.router_aux_weight

    # rank within expert via sorted segments; dispatch = int32 scatter of
    # token ids + a payload gather (_dispatch)
    capacity = moe_capacity(cfg, t)
    keep, slot, slot_tok = _dispatch(cfg, top_e, capacity)
    # index_select, not advanced indexing: its backward is an index_add_,
    # where advanced indexing's sort-based accumulate took two thirds of a
    # full-width granite-moe train step's device time on an H100 (PERF.md).
    # On CUDA that index_add_ sums a token's k gradients with atomics in
    # the compute dtype, so a step is not bitwise reproducible run to run;
    # torch.use_deterministic_algorithms(True) makes it so again
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    buf = xf_pad.index_select(0, slot_tok).reshape(n_e, capacity, d)
    out_flat = _experts(buf, p["w_gate"].to(cdt), p["w_up"].to(cdt),
                        p["w_down"].to(cdt)).reshape(n_e * capacity, d)
    # entry (t_i, j) of the (t, k, d) view is token t_i's j-th routing
    combined = _combine(out_flat, keep, slot, top_p, cdt)

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


def _route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor):
    """The router of :func:`moe_apply`: (probs, top_p renormalised,
    top_e)."""
    m = cfg.moe
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _dispatch(cfg: ModelConfig, te: torch.Tensor, capacity: int):
    """Capacity grouping of the (T, k) routings ``te``: each routing is
    ranked within its expert by a stable sort in token order, and those
    ranked at or past ``capacity`` are dropped.  Returns ``(keep, slot,
    slot_tok)``: the kept mask and each routing's slot (a kept one's
    ``expert·capacity + rank``, the dropped ones a sentinel slot past the
    end, whose unordered writes are sliced off) and each slot's token
    (``T`` for an empty slot, the zero row of a padded input)."""
    n_e = cfg.moe.n_experts
    t, k = te.shape
    dev = te.device
    flat_e = te.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.zeros(n_e, dtype=flat_e.dtype, device=dev)
    counts.index_add_(0, flat_e, torch.ones_like(flat_e))  # no host sync
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(t * k, device=dev) - starts[e_sorted]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted                   # a permutation: no repeats
    keep = rank < capacity
    n_slots = n_e * capacity
    slot = torch.where(keep, flat_e * capacity + rank, n_slots)
    slot_tok = torch.full((n_slots + 1,), t, dtype=torch.int32, device=dev)
    slot_tok[slot] = flat_tok.to(torch.int32)
    return keep, slot, slot_tok[:-1]


def _experts(buf, wg, wu, wd):
    """The SiLU-gated expert products over an (e, c, d) buffer."""
    gate = F.silu(torch.bmm(buf, wg))
    return torch.bmm(gate * torch.bmm(buf, wu), wd)


def _combine(out_flat, keep, slot, top_p, cdt):
    t, k = top_p.shape
    n_slots, d = out_flat.shape
    got = out_flat.index_select(0, slot.clamp(0, n_slots - 1))
    got = torch.where(keep[:, None], got, got.new_zeros(()))
    return (got.reshape(t, k, d)
            * top_p.reshape(t, k, 1).to(cdt)).sum(dim=1).to(cdt)


def moe_capacity_a2a(cfg: ModelConfig, t_loc: int) -> int:
    """Slots an expert for ``t_loc`` local tokens in :func:`_moe_a2a`:
    ``max(4, ceil(t_loc·k·capacity_factor / E))``, the reference's."""
    m = cfg.moe
    return int(max(4, np.ceil(t_loc * m.top_k * m.capacity_factor
                              / m.n_experts)))


def _moe_a2a(plan, xfs, top_es, top_ps, p, cfg: ModelConfig):
    """The reference's explicit expert-parallel dispatch.

    ``xfs``, ``top_es``, ``top_ps`` hold each data entry's tokens and
    routings.  The tokens split over (data entries, ``model``) when their
    count divides it, else over the data entries alone (each model entry
    then dispatches the same tokens, as the reference's do, and the data
    entry keeps model entry 0's output).  Each (data, model) entry groups
    its own tokens by expert at the local capacity ``c_src``
    (:func:`moe_capacity_a2a`) into a destination-major (tp, E/tp, c_src,
    d) buffer; an ``all_to_all`` over ``model`` hands each model entry the
    slots of its ``E/tp`` experts from every source; it runs them; a
    second ``all_to_all`` brings the results back and each entry combines
    its own tokens.  The local capacity drops other routings than the
    single-device path's global one: they are the reference's drops.
    Returns each data entry's combined (T_d, d) output."""
    from repro_torch.launch.mesh import all_gather, all_to_all

    m_cfg = cfg.moe
    cdt = cfg.cdtype
    tp, dp = plan.tp, plan.dp
    e_loc = m_cfg.n_experts // tp
    t = sum(x.shape[0] for x in xfs)
    split = t % (dp * tp) == 0
    t_loc = t // (dp * tp) if split else t // dp
    c_src = moe_capacity_a2a(cfg, t_loc)
    n_slots = m_cfg.n_experts * c_src
    w = {name: [plan.local(p[name], j).to(cdt) for j in range(tp)]
         for name in ("w_gate", "w_up", "w_down")}
    outs = []
    for xf, te, tpr in zip(xfs, top_es, top_ps):
        d = xf.shape[1]
        if split:
            xf_l, te_l, tp_l = (torch.chunk(a, tp) for a in (xf, te, tpr))
        else:
            xf_l, te_l, tp_l = ([a] * tp for a in (xf, te, tpr))
        sent, plans = [], []
        for j in range(tp):
            keep, slot, slot_tok = _dispatch(cfg, te_l[j], c_src)
            xf_pad = torch.cat([xf_l[j], xf_l[j].new_zeros((1, d))])
            sbuf = xf_pad.index_select(0, slot_tok)
            sent.append(sbuf.reshape(tp, e_loc, c_src, d))
            plans.append((keep, slot))
        got = all_to_all(plan.mesh, "model", sent)     # (src, e_loc, c, d)
        back = []
        for j in range(tp):
            rb = got[j].movedim(0, 1).reshape(e_loc, tp * c_src, d)
            oe = _experts(rb, w["w_gate"][j], w["w_up"][j], w["w_down"][j])
            back.append(oe.reshape(e_loc, tp, c_src, d).movedim(1, 0))
        back = all_to_all(plan.mesh, "model", back)
        combined = [_combine(back[j].reshape(n_slots, d), *plans[j],
                             tp_l[j], cdt) for j in range(tp)]
        if split:
            outs.append(all_gather(plan.mesh, "model",
                                   combined).reshape(-1, d))
        else:
            outs.append(combined[0])
    return outs


def moe_meshed(plan, p, cfg: ModelConfig, xs):
    """:func:`moe_apply` over ``plan``'s mesh: ``xs`` has one (B_d, S, d)
    tensor a data entry.  The router loss is the whole microbatch's: the
    mean router probabilities and the routing shares are ``psum``-ed over
    the data entries before their product.  With ``expert`` bound to
    ``model``, more than one data entry and the tokens splitting over
    them, the dispatch is :func:`_moe_a2a`, as the reference's; otherwise
    the single-device dispatch at the global capacity over the whole
    microbatch, its tokens gathered over the data entries and its output
    split back; so under the decode fallback (the batch rule ``None``,
    the reference's GSPMD path).  Returns (each data entry's output,
    aux)."""
    from repro_torch.dist.sharding import bound_axis

    from .layers import mlp_meshed

    m = cfg.moe
    cdt = cfg.cdtype
    n_e, k = m.n_experts, m.top_k
    router = plan.local(p["router"])
    xfs, routed = [], []
    for x in xs:
        xf = x.reshape(-1, x.shape[-1]).to(cdt)
        xfs.append(xf)
        routed.append(_route(cfg, router, xf))
    t = sum(xf.shape[0] for xf in xfs)
    me = plan.psum_data([pr.sum(dim=0) for pr, _, _ in routed]) / t
    ce = plan.psum_data([
        torch.zeros(n_e, dtype=torch.float32, device=te.device).index_add_(
            0, te.reshape(-1), torch.full((te.numel(),), 1.0 / (t * k),
                                          dtype=torch.float32,
                                          device=te.device))
        for _, _, te in routed])
    aux = n_e * torch.sum(me * ce) * m.router_aux_weight

    batch_axes = bound_axis("batch") or ()
    dp_axes = (batch_axes,) if isinstance(batch_axes, str) \
        else tuple(batch_axes)
    # the reference's condition, over the bound batch axes: under the
    # decode fallback (batch rule None) its dp is 1 and it takes the
    # GSPMD path, _moe_global here
    dp = int(np.prod([plan.mesh.shape[a] for a in dp_axes])) \
        if dp_axes else 1
    if bound_axis("expert") == "model" and dp > 1 and t % dp == 0:
        if dp_axes != plan.data_axes:
            raise NotImplementedError(
                f"the expert-parallel dispatch runs over the bound batch "
                f"axes {dp_axes}, which differ from the microbatch axes "
                f"{plan.data_axes}")
        combined = _moe_a2a(plan, xfs, [te for _, _, te in routed],
                            [tp for _, tp, _ in routed], p, cfg)
    else:
        combined = _moe_global(plan, xfs, routed, p, cfg)
    if m.n_shared:
        shared = mlp_meshed(plan, p, xfs, cdt, names=(
            "shared_up", "shared_down", "shared_gate"))
        combined = [c + s for c, s in zip(combined, shared)]
    return [c.reshape(x.shape[:-1] + (c.shape[-1],))
            for c, x in zip(combined, xs)], aux


def _moe_global(plan, xfs, routed, p, cfg: ModelConfig):
    """The single-device dispatch of :func:`moe_apply` over the whole
    microbatch: every data entry's tokens and routings gathered (one
    ``all_gather`` an axis), the experts run once at the global capacity
    with their whole weights, and each data entry's rows handed back."""
    cdt = cfg.cdtype
    sizes = [xf.shape[0] for xf in xfs]
    t = sum(sizes)
    dev = xfs[0].device

    def gather(rows):
        from repro_torch.launch.mesh import all_gather

        rows = list(rows)
        for a in reversed(plan.data_axes):
            n = plan.mesh.shape[a]
            rows = [all_gather(plan.mesh, a, rows[i:i + n]).flatten(0, 1)
                    for i in range(0, len(rows), n)]
        return rows[0]

    if plan.dp > 1 and len(set(sizes)) == 1:
        xf, top_p, top_e = (gather(r) for r in (
            xfs, [tp for _, tp, _ in routed], [te for _, _, te in routed]))
    else:
        xf = torch.cat([a.to(dev) for a in xfs])
        top_p = torch.cat([tp.to(dev) for _, tp, _ in routed])
        top_e = torch.cat([te.to(dev) for _, _, te in routed])
    capacity = moe_capacity(cfg, t)
    keep, slot, slot_tok = _dispatch(cfg, top_e, capacity)
    d = xf.shape[1]
    xf_pad = torch.cat([xf, xf.new_zeros((1, d))])
    buf = xf_pad.index_select(0, slot_tok).reshape(cfg.moe.n_experts,
                                                   capacity, d)
    out = _experts(buf, *(plan.whole(p[n]).to(cdt)
                          for n in ("w_gate", "w_up", "w_down")))
    combined = _combine(out.reshape(-1, d), keep, slot, top_p, cdt)
    return list(torch.split(combined, sizes))
