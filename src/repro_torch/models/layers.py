"""Shared neural layers: norms, MLPs, embeddings, rotary position encodings.

Port of ``src/repro/models/layers.py``.  Weights keep the reference's
``(in, out)`` layout and every product is ``x @ w``, so carrying a JAX
parameter tree across is a copy, not a transpose.  The functions take
plain tensors; :class:`RMSNorm` and :class:`MLP` are the ``nn.Module``
holders the transformer is built from.  ``constrain`` is dropped: the
meshed forward lays its activations out itself.

The meshed forward's layers (the sharded trainer's, and the meshed
serving steps', under ``torch.no_grad()``) sit at the end:
:class:`MeshPlan` (which entries run what, and the per-layer FSDP gather
of a model entry's weights), :func:`mlp_meshed` (column-parallel
``w_up``/``w_gate``, row-parallel ``w_down``), :func:`embed_meshed` and
:func:`unembed_meshed` (the vocab over ``model``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def dense_init(gen: torch.Generator, shape: Sequence[int],
               fan_in: Optional[int] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 1/fan_in) (fan_in defaults to ``shape[0]``), from ``gen``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        w_gate: Optional[torch.Tensor] = None,
        cdtype=torch.bfloat16) -> torch.Tensor:
    """SiLU-gated when ``w_gate`` is given, else GELU (tanh form, as
    ``jax.nn.gelu``'s default)."""
    x = x.to(cdtype)
    up = x @ w_up.to(cdtype)
    if w_gate is not None:
        h = torch.nn.functional.silu(x @ w_gate.to(cdtype)) * up
    else:
        h = torch.nn.functional.gelu(up, approximate="tanh")
    return h @ w_down.to(cdtype)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor,
            cdtype=torch.bfloat16) -> torch.Tensor:
    # 1/sqrt(d) keeps initial logits O(1) under tied N(0,1) embeddings
    d = x.shape[-1]
    logits = x.to(cdtype) @ table.to(cdtype).T
    return logits * (1.0 / d ** 0.5)


# ---------------------------------------------------------------------------
# Rotary position encodings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 1e6):
    """The (B, S, 1, D/2) float32 cosines and sines :func:`apply_rope`
    rotates by."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    ang = positions[..., None].float() * freqs              # (B, S, D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Rotates in float32 and
    casts back to x's dtype."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x rotated by :func:`rope_tables`' ``cos`` and ``sin``."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 1e6) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): x (B, S, H, D); positions3 (3, B, S).

    The D/2 frequency lanes are split into (temporal, height, width)
    sections; lane ``l`` rotates by ``positions3[sec[l]]``.  With the three
    grids equal it is :func:`apply_rope`.
    """
    return rotate(x, *mrope_tables(positions3, x.shape[-1], sections, theta))


def mrope_tables(positions3: torch.Tensor, head_dim: int,
                 sections: Tuple[int, int, int], theta: float = 1e6):
    """The (B, S, 1, D/2) float32 cosines and sines :func:`apply_mrope`
    rotates by: lane ``l`` at ``positions3[sec[l]]``."""
    dev = positions3.device
    freqs = rope_freqs(head_dim, theta, device=dev)         # (D/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=dev)
                     for i, s in enumerate(sections)])
    assert sec.shape[0] == head_dim // 2, (sections, head_dim)
    lane_pos = positions3.float()[sec]                      # (D/2, B, S)
    ang = torch.movedim(lane_pos, 0, -1) * freqs            # (B, S, D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def sinusoidal_positions(seq: int, d_model: int,
                         device=None) -> torch.Tensor:
    """(seq, d_model) float32: sin at the even columns, cos at the odd,
    of ``pos · exp(-2i·ln(10000)/d_model)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * neg_log_10000_over(d_model, device))
    pe = torch.zeros((seq, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def neg_log_10000_over(d_model: int, device=None) -> torch.Tensor:
    """``-ln(10000) / d_model`` as a 0-d float32 tensor, each step
    rounded to float32 as the reference's ``-jnp.log(10000.0) / d_model``:
    the frequencies it scales are then the reference's to the last bit
    before ``exp``."""
    return -torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                   device=device)) / d_model


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    # Frozen: serving and the PH monitor only read the weights, and a frozen
    # weight keeps autograd from recording every forward.  The trainer turns
    # gradients on for its own model (``requires_grad_(True)``).
    return nn.Parameter(t, requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor, eps: float):
        super().__init__()
        self.scale = _param(scale)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


class MLP(nn.Module):
    """From the reference's ``mlp`` params: ``w_up``, ``w_down`` and, for
    the SiLU-gated form, ``w_gate``."""

    def __init__(self, p: Mapping[str, torch.Tensor], cdtype: torch.dtype):
        super().__init__()
        self.w_up = _param(p["w_up"])
        self.w_down = _param(p["w_down"])
        self.w_gate = _param(p["w_gate"]) if "w_gate" in p else None
        self.cdtype = cdtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.w_up, self.w_down, self.w_gate, self.cdtype)


# ---------------------------------------------------------------------------
# The meshed forward: per-entry blocks over the port's Mesh
# ---------------------------------------------------------------------------

class MeshPlan:
    """How a meshed forward runs over ``mesh``: the data entries are the
    entries of ``data_axes`` (the microbatch axes, split major-to-minor),
    the model entries those of ``model`` (``tp`` = 1 without it).  Every
    other axis sees the work replicated and is not run twice.

    A parameter is a :class:`~repro_torch.dist.sharding.ShardedTensor`
    (one block per mesh entry); :meth:`local` gathers a model entry's
    block of it over ``data`` (the FSDP gather), once per model entry and
    parameter, and :meth:`whole` over ``model`` too.  An activation that
    the model axis holds alike (a ``psum``'s result) is one tensor per
    data entry."""

    def __init__(self, mesh, data_axes):
        from repro_torch.launch.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"expected a repro_torch.launch.mesh.Mesh, got "
                            f"{type(mesh).__module__}."
                            f"{type(mesh).__qualname__}")
        data_axes = (data_axes,) if isinstance(data_axes, str) \
            else tuple(data_axes or ())
        for a in data_axes:
            if a not in mesh.shape:
                raise ValueError(f"microbatch axis {a!r} is not an axis of "
                                 f"the mesh {mesh.axis_names}")
        self.mesh = mesh
        self.data_axes = data_axes
        self.dp = int(np.prod([mesh.shape[a] for a in data_axes])) \
            if data_axes else 1
        self.tp = int(mesh.shape.get("model", 1))
        self._cache: dict = {}

    def entry(self, di: int = 0, m: int = 0, data: int = None) -> int:
        """The flat index (``mesh.devices.flat``) of data entry ``di``,
        model entry ``m``; ``data`` overrides the ``data`` coordinate (the
        FSDP gather walks it); every other axis at 0."""
        mesh = self.mesh
        coords = dict.fromkeys(mesh.axis_names, 0)
        rest = di
        for a in reversed(self.data_axes):
            coords[a] = rest % mesh.shape[a]
            rest //= mesh.shape[a]
        if "model" in coords:
            coords["model"] = m
        if data is not None:
            coords["data"] = data
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in mesh.axis_names), mesh.devices.shape))

    def device(self, di: int = 0) -> torch.device:
        return self.mesh.devices.flat[self.entry(di)]

    def coords(self, entry: int) -> Tuple[int, int]:
        """``(data entry, model entry)`` of the flat index ``entry``; every
        other axis (one the batch is not split over) maps to data entry
        0's work."""
        mesh = self.mesh
        at = dict(zip(mesh.axis_names,
                      np.unravel_index(entry, mesh.devices.shape)))
        di = 0
        for a in self.data_axes:
            di = di * mesh.shape[a] + int(at[a])
        return di, int(at.get("model", 0))

    def assemble(self, spec, shape, block):
        """A :class:`~repro_torch.dist.sharding.ShardedTensor` of ``shape``
        laid out by ``spec``, each entry's block ``block(di, m)`` for its
        :meth:`coords` (entries of one ``(di, m)`` share the tensor)."""
        from repro_torch.dist.sharding import NamedSharding, ShardedTensor

        made: dict = {}
        blocks = []
        for i in range(self.mesh.devices.size):
            key = self.coords(i)
            if key not in made:
                made[key] = block(*key)
            blocks.append(made[key])
        return ShardedTensor(NamedSharding(self.mesh, spec), blocks, shape)

    def split_model(self, st) -> Optional[int]:
        """The dimension of ``st`` split over ``model``, or ``None``."""
        spec = tuple(st.spec)
        return spec.index("model") if "model" in spec else None

    def local(self, st, m: int = 0, dtype=None) -> torch.Tensor:
        """Model entry ``m``'s block of ``st``, whole along ``data`` (cast
        to ``dtype`` when given: once, whatever the data entries using
        it)."""
        from repro_torch.launch.mesh import gather_blocks

        spec = tuple(st.spec)
        m = m if "model" in spec else 0
        if dtype is not None and dtype != st.dtype:
            key = (id(st), m, dtype)
            if key not in self._cache:
                self._cache[key] = (self.local(st, m).to(dtype), st)
            return self._cache[key][0]
        key = (id(st), m)
        if key not in self._cache:
            if "data" in spec:
                got = gather_blocks(
                    self.mesh, "data",
                    [st.blocks[self.entry(m=m, data=d)]
                     for d in range(self.mesh.shape["data"])],
                    spec.index("data"))
            else:
                got = st.blocks[self.entry(m=m)]
            # st is kept beside its block, so that its id names it alone
            self._cache[key] = (got, st)
        return self._cache[key][0]

    def whole(self, st, dtype=None) -> torch.Tensor:
        """``st`` whole: :meth:`local` of every model entry, gathered."""
        from repro_torch.launch.mesh import gather_blocks

        dim = self.split_model(st)
        if dim is None:
            return self.local(st, 0, dtype)
        return gather_blocks(self.mesh, "model", [
            self.local(st, m, dtype) for m in range(self.tp)], dim)

    def psum_data(self, parts):
        """The sum over the data entries of ``parts`` (one a data entry):
        a ``psum`` over each data axis in turn, innermost first."""
        from repro_torch.launch.mesh import psum

        parts = list(parts)
        for a in reversed(self.data_axes):
            n = self.mesh.shape[a]
            parts = [psum(self.mesh, a, parts[i:i + n])
                     for i in range(0, len(parts), n)]
        return parts[0]

    def clear(self) -> None:
        """Forget the gathered weights (a new microbatch re-gathers)."""
        self._cache.clear()


def model_psum(plan: MeshPlan, parts):
    from repro_torch.launch.mesh import psum

    return psum(plan.mesh, "model", parts)


def mlp_meshed(plan: MeshPlan, p, xs, cdtype=torch.bfloat16,
               names=("w_up", "w_down", "w_gate")):
    """:func:`mlp` on each data entry's ``xs[di]`` with ``p``'s sharded
    weights: column-parallel ``w_up`` / ``w_gate`` and row-parallel
    ``w_down`` over ``model``, the partial outputs ``psum``-ed; once with
    whole weights where the hidden width does not split."""
    up, down, gate = names
    split = plan.split_model(p[up]) is not None
    outs = []
    for x in xs:
        def part(m):
            return mlp(x, plan.local(p[up], m, cdtype),
                       plan.local(p[down], m, cdtype),
                       plan.local(p[gate], m, cdtype) if gate in p else None,
                       cdtype)
        outs.append(model_psum(plan, [part(m) for m in range(plan.tp)])
                    if split else part(0))
    return outs


def _vocab_block(plan: MeshPlan, table, m: int):
    """(first row, rows) of model entry ``m``'s vocab block of ``table``."""
    v = table.shape[0]
    if plan.split_model(table) != 0:
        return 0, v
    return m * (v // plan.tp), v // plan.tp


def embed_meshed(plan: MeshPlan, table, ids_list):
    """The vocab-parallel lookup: model entry ``m`` looks up the ids in its
    vocab block (zeros elsewhere) and the partial rows are ``psum``-ed, so
    each row has one nonzero term; one lookup where the vocab does not
    split."""
    outs = []
    for ids in ids_list:
        if plan.split_model(table) != 0:
            outs.append(embed(plan.local(table), ids))
            continue
        parts = []
        for m in range(plan.tp):
            lo, n = _vocab_block(plan, table, m)
            local = ids.long() - lo
            inside = (local >= 0) & (local < n)
            rows = embed(plan.local(table, m), local.clamp(0, n - 1))
            parts.append(torch.where(inside[..., None], rows,
                                     rows.new_zeros(())))
        outs.append(model_psum(plan, parts))
    return outs


def unembed_meshed(plan: MeshPlan, table, xs, cdtype=torch.bfloat16):
    """:func:`unembed` with the vocab over ``model``: for each data entry
    the float32 logits of each model entry's vocab block, a list."""
    split = plan.split_model(table) == 0
    return [[unembed(plan.local(table, m, cdtype), x, cdtype).float()
             for m in range(plan.tp if split else 1)] for x in xs]
