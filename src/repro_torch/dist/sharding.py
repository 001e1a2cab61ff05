"""Parameter / activation sharding rules over the port's mesh (port of
``src/repro/dist/sharding.py``).

Physical axes (by convention across the repo):

* ``model`` — tensor parallelism (TP): attention heads, FFN hidden, vocab,
  MoE experts;
* ``data`` — data parallelism + FSDP parameter sharding;
* ``pod``  — the cross-pod data axis (gradients cross it compressed, see
  ``dist.compression``).

Two rule families live here, each the reference's function for function:

* **parameter rules** (:func:`spec_for_param` / :func:`shard_params`):
  role-based column/row parallelism keyed on the leaf name and head
  alignment — a projection whose head count does not divide the TP axis
  falls back to row-parallelism on its d_model dim rather than sharding
  heads unevenly; parameters that cannot be sharded at all are recorded in
  the caller's ``rep`` list so the launcher can report them.
* **activation rules** (:func:`activation_rules`): logical-axis -> mesh-axis
  mapping bound around a step function with :func:`bind_activation_rules`
  and read back with :func:`bound_axis` / :func:`bound_mesh`.

The spec functions read only ``mesh.shape`` and ``mesh.axis_names``, as the
reference's do, so a duck-typed test mesh works too.  :class:`PartitionSpec`
(``P``) is a tuple with the reference's repr; :class:`NamedSharding` lays a
whole tensor out as one local block per entry of ``mesh.devices.flat``,
each exactly jax's ``addressable_shards`` block for the same spec (a spec
entry that is a tuple of axes splits its dimension major-to-minor), and
:class:`ShardedTensor` holds those blocks.  Entries that hold the same
block on the same device share one tensor, so a replicated leaf is one
leaf.  The meshed forward (``repro_torch.models``) places its activations
per entry as the bound rules say, so :func:`constrain` has nothing to
move and returns its input, bound or not.

The PH paths read one choice of the mesh: :func:`data_axis`, the innermost
data axis present (the reference's ``tile_specs`` and ``reduce_specs``
return jax specs around it; the port keeps the choice and the two
``ValueError`` messages).  Only the port's own
:class:`~repro_torch.launch.mesh.Mesh` is taken there: any other object, a
jax mesh among them, raises ``TypeError`` instead of being read as a shard
count.

The tree paths come along for the checkpointer: :func:`tree_path_str` is
the reference's, and :func:`tree_flatten_with_path` flattens a tree in the
order ``jax.tree_util.tree_flatten_with_path`` does (dict keys sorted, list
and tuple entries by index, NamedTuple fields by name in their declared
order, ``None`` an empty subtree with no leaf), so a checkpoint's leaf
names are the reference's.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import Mesh

__all__ = [
    "NamedSharding", "P", "PartitionSpec", "Rules", "ShardedTensor",
    "activation_rules", "batch_specs", "bind_activation_rules", "bound_axis",
    "bound_mesh", "bound_rules", "cache_specs", "constrain", "data_axis",
    "shard_params", "shard_tree", "shardings_from_specs", "spec_for_param",
    "tree_flatten_with_path", "tree_path_str", "tree_unflatten",
    "unshard_tree",
]

# What each caller does over the axis, as the reference's messages say it:
# the harvest's ``tile_specs`` and the reduction's ``reduce_specs``.
_PURPOSES = {"tile": "shard the tile grid",
             "reduce": "exchange reduction pivots"}


def data_axis(mesh, purpose: str) -> str:
    """The mesh axis that ``purpose`` (``"tile"``: the sharded harvest deals
    one tile per entry a round; ``"reduce"``: the pivot exchange gathers
    row ``k`` of the ``(P, L)`` payload buffer from entry ``k``) runs over.
    Every other axis sees the work replicated."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__module__}.{type(mesh).__qualname__}")
    names = tuple(mesh.axis_names)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    if not data_axes:
        raise ValueError(f"mesh axes {names} have no data axis to "
                         f"{_PURPOSES[purpose]} over")
    return data_axes[-1]          # 'data' when present, else 'pod'


# ---------------------------------------------------------------------------
# tree paths
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_path_str(kp) -> str:
    """'groups/0/attn/wq'-style path from a key path."""
    parts = []
    for k in kp:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        else:
            parts.append(str(k).strip("[].'\""))
    return "/".join(parts)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def tree_flatten_with_path(tree, is_leaf: Optional[Callable[[Any], bool]]
                           = None) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``([(key_path, leaf), ...], treedef)`` in jax's order; a leaf is
    anything but a dict, list, tuple or ``None``, or whatever ``is_leaf``
    says is one.  ``treedef`` is what :func:`tree_unflatten` rebuilds the
    tree from."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if is_leaf is not None and is_leaf(node):
            out.append((path, node))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (DictKey(k),))
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + (GetAttrKey(f),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (SequenceKey(i),))
        else:
            out.append((path, node))

    walk(tree, ())
    return out, _TreeDef(tree, is_leaf)


@dataclasses.dataclass(frozen=True)
class _TreeDef:
    tree: Any
    is_leaf: Optional[Callable[[Any], bool]]


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` (from :func:`tree_flatten_with_path`, or a
    tree of the same structure) with ``leaves`` in flatten order."""
    tree, is_leaf = (treedef.tree, treedef.is_leaf) \
        if isinstance(treedef, _TreeDef) else (treedef, None)
    it = iter(leaves)

    def fill(node):
        if node is None:
            return None
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            got = {k: fill(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(fill(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return next(it)

    tree = fill(tree)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return tree


_END = object()


def _tree_map(fn, tree, is_leaf=None):
    flat, treedef = tree_flatten_with_path(tree, is_leaf)
    return tree_unflatten(treedef, [fn(leaf) for _, leaf in flat])


# ---------------------------------------------------------------------------
# specs, shardings and sharded tensors
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (unsharded), an axis name, or a tuple
    of axis names (split major-to-minor).  A tuple, printed as jax prints
    its ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """``spec`` on ``mesh``: which block of a whole tensor each mesh entry
    holds (jax's ``NamedSharding``, its blocks in ``addressable_shards``
    order, one per entry of ``mesh.devices.flat``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"expected a repro_torch.launch.mesh.Mesh, got "
                            f"{type(mesh).__module__}."
                            f"{type(mesh).__qualname__}")
        spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for entry in spec:
            for a in _entry_axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"{spec!r} names axis {a!r}, absent "
                                     f"from the mesh axes {mesh.axis_names}")
        self.mesh = mesh
        self.spec = spec

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"

    def parts(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is split into."""
        if dim >= len(self.spec):
            return 1
        return int(np.prod([self.mesh.shape[a]
                            for a in _entry_axes(self.spec[dim])]))

    def block_index(self, entry: int) -> Tuple[int, ...]:
        """Entry ``entry`` of ``mesh.devices.flat``: its block's index
        along each dimension the spec names."""
        coords = dict(zip(self.mesh.axis_names,
                          np.unravel_index(entry, self.mesh.devices.shape)))
        out = []
        for e in self.spec:
            idx = 0
            for a in _entry_axes(e):
                idx = idx * self.mesh.shape[a] + int(coords[a])
            out.append(idx)
        return tuple(out)

    def block_slices(self, shape, entry: int) -> Tuple[slice, ...]:
        sl = []
        for dim, size in enumerate(shape):
            n = self.parts(dim)
            if size % n:
                raise ValueError(f"dimension {dim} of shape {tuple(shape)} "
                                 f"does not split into {n} blocks "
                                 f"({self.spec!r})")
            k = self.block_index(entry)[dim] if dim < len(self.spec) else 0
            sl.append(slice(k * (size // n), (k + 1) * (size // n)))
        return tuple(sl)

    def shard(self, x) -> "ShardedTensor":
        """``x`` (a tensor or array, whole) laid out on the mesh: each
        entry's block copied to its device, one tensor for the entries
        that hold the same block on the same device."""
        # np.asarray, not ascontiguousarray: that one makes a 0-d array 1-d
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        t = t.detach()
        if len(self.spec) > t.dim():
            raise ValueError(f"{self.spec!r} has more entries than the "
                             f"{t.dim()} dimensions of its tensor")
        made: Dict[tuple, torch.Tensor] = {}
        blocks = []
        for i, dev in enumerate(self.mesh.devices.flat):
            key = (self.block_index(i), str(dev))
            if key not in made:
                made[key] = t[self.block_slices(t.shape, i)].to(
                    dev, copy=True).contiguous()
            blocks.append(made[key])
        return ShardedTensor(self, blocks, tuple(t.shape))


class ShardedTensor:
    """A whole tensor of ``shape`` as one block per entry of
    ``sharding.mesh.devices.flat`` (``blocks``; entries holding the same
    block on one device share a tensor)."""

    def __init__(self, sharding: NamedSharding, blocks, shape):
        self.sharding = sharding
        self.blocks = list(blocks)
        self.shape = tuple(int(s) for s in shape)
        if len(self.blocks) != sharding.mesh.devices.size:
            raise ValueError(f"{len(self.blocks)} blocks for a mesh of "
                             f"{sharding.mesh.devices.size} entries")

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec!r})")

    def distinct(self) -> List[torch.Tensor]:
        """Each block tensor once, in entry order."""
        seen, out = set(), []
        for b in self.blocks:
            if id(b) not in seen:
                seen.add(id(b))
                out.append(b)
        return out

    def with_blocks(self, distinct) -> "ShardedTensor":
        """The same layout over new tensors, one a :meth:`distinct` block in
        its order."""
        new = dict(zip((id(b) for b in self.distinct()), distinct))
        return ShardedTensor(self.sharding, [new[id(b)] for b in self.blocks],
                             self.shape)

    def unshard(self, device=None) -> torch.Tensor:
        """The whole tensor, assembled from the blocks on ``device`` (the
        first entry's by default)."""
        dev = torch.device(device) if device is not None \
            else self.blocks[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for i, b in enumerate(self.blocks):
            key = self.sharding.block_index(i)
            if key not in done:
                done.add(key)
                out[self.sharding.block_slices(self.shape, i)] = \
                    b.detach().to(dev)
        return out


def shard_tree(tree, shardings):
    """``jax.device_put(tree, shardings)``: each leaf of ``tree`` laid out
    by the :class:`NamedSharding` at its place in ``shardings`` (a tree of
    the same structure)."""
    flat, treedef = tree_flatten_with_path(tree)
    sh = [s for _, s in tree_flatten_with_path(
        shardings, lambda x: isinstance(x, NamedSharding))[0]]
    if len(sh) != len(flat):
        raise ValueError(f"{len(sh)} shardings for {len(flat)} leaves")
    return tree_unflatten(treedef, [s.shard(leaf)
                                    for (_, leaf), s in zip(flat, sh)])


def unshard_tree(tree):
    """Every :class:`ShardedTensor` of ``tree`` as its whole tensor."""
    return _tree_map(lambda x: x.unshard() if isinstance(x, ShardedTensor)
                     else x, tree)


# ---------------------------------------------------------------------------
# mesh introspection (the port's Mesh and duck-typed test meshes)
# ---------------------------------------------------------------------------

def _axis_size(mesh, name: Optional[str]) -> int:
    if not name:
        return 1
    try:
        return int(mesh.shape[name])
    except (KeyError, TypeError):
        return 1


def _mesh_axes(mesh) -> Tuple[Optional[str], Tuple[str, ...]]:
    """(tp axis, data axes) present on the mesh."""
    names = tuple(getattr(mesh, "axis_names", ()))
    tp = "model" if "model" in names else None
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    return tp, data_axes


def _dp_size(mesh, data_axes: Tuple[str, ...]) -> int:
    n = 1
    for a in data_axes:
        n *= _axis_size(mesh, a)
    return n


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

_COLUMN_NAMES = ("w_up", "w_gate", "shared_up", "shared_gate", "w_uk", "w_uv")
_ROW_NAMES = ("w_down", "shared_down")
_EXPERT_NAMES = ("w_up", "w_gate", "w_down")


def spec_for_param(path: str, shape: Tuple[int, ...], mesh,
                   rep: List[str], heads: Optional[Dict[str, int]] = None,
                   fsdp: bool = True) -> PartitionSpec:
    """PartitionSpec for one parameter leaf.

    ``path`` is the '/'-joined tree path; params under ``groups/`` carry a
    leading stacked-repeats dim that always stays unsharded.  ``heads``
    (``{"q": n_heads, "kv": n_kv_heads}``) drives head alignment: an aligned
    projection is column-parallel (out dim over ``model``); a misaligned one
    is row-parallel (d_model over ``model``) so no head is ever split.
    ``fsdp=False`` (serving) keeps params replicated over the data axis.
    Leaves with no shardable dim are appended to ``rep``.
    """
    tp, data_axes = _mesh_axes(mesh)
    tp_n = _axis_size(mesh, tp)
    dp = "data" if (fsdp and "data" in data_axes) else None
    dp_n = _axis_size(mesh, dp)

    name = path.split("/")[-1]
    nd = len(shape)
    lead = 1 if (path.startswith("groups") or "/groups/" in path) \
        and nd >= 2 else 0
    core = shape[lead:]
    cn = len(core)
    spec: List[Any] = [None] * nd

    def fit(dim: int, ax: Optional[str], n: int) -> Optional[str]:
        return ax if ax is not None and n > 1 and dim % n == 0 else None

    def put(i: int, ax: Optional[str]) -> None:
        spec[lead + i] = ax

    q_aligned = bool(heads and heads.get("q") and tp
                     and heads["q"] % tp_n == 0)
    kv_aligned = bool(heads and heads.get("kv") and tp
                      and heads["kv"] % tp_n == 0)

    if cn == 2 and name in ("wq", "wk", "wv") and heads:
        # in-projections: column-parallel when the head count divides the TP
        # axis, else row-parallel on d_model (never split a head)
        aligned = q_aligned if name == "wq" else kv_aligned
        if aligned:
            put(0, fit(core[0], dp, dp_n))
            put(1, fit(core[1], tp, tp_n))
        else:
            put(0, fit(core[0], tp, tp_n))
            put(1, fit(core[1], dp, dp_n))
    elif cn == 2 and name == "wo" and heads:
        # out-projection: row-parallel on the h*hd contraction when heads
        # are aligned (pairs with the column-parallel wq)
        if q_aligned:
            put(0, fit(core[0], tp, tp_n))
            put(1, fit(core[1], dp, dp_n))
        else:
            put(0, fit(core[0], dp, dp_n))
            put(1, fit(core[1], tp, tp_n))
    elif cn == 3 and name in _EXPERT_NAMES:
        # stacked routed experts (E, a, b): expert dim over model (EP)
        put(0, fit(core[0], tp, tp_n))
        big = 1 if core[1] >= core[2] else 2
        other = 3 - big
        if fit(core[big], dp, dp_n):
            put(big, dp)
        elif fit(core[other], dp, dp_n):
            put(other, dp)
    elif cn == 2 and name in _COLUMN_NAMES:
        put(0, fit(core[0], dp, dp_n))
        put(1, fit(core[1], tp, tp_n))
    elif cn == 2 and name in _ROW_NAMES:
        put(0, fit(core[0], tp, tp_n))
        put(1, fit(core[1], dp, dp_n))
    elif cn == 2 and name == "table":
        # embedding / lm_head: vocab over model (padded_vocab guarantees
        # divisibility), d_model over data
        put(0, fit(core[0], tp, tp_n))
        put(1, fit(core[1], dp, dp_n))
    elif cn == 2 and name == "router":
        put(0, fit(core[0], dp, dp_n))      # router is tiny: FSDP only
    elif cn >= 2:
        # generic 2D+: biggest dim over model, next shardable over data
        order = sorted(range(cn), key=lambda i: -core[i])
        put(order[0], fit(core[order[0]], tp, tp_n))
        for i in order[1:]:
            if fit(core[i], dp, dp_n):
                put(i, dp)
                break
    # cn <= 1 (norm scales, biases): replicated by design, not a fallback

    if cn >= 2 and all(s is None for s in spec):
        rep.append(path)
    return P(*spec)


def shard_params(params, mesh, fsdp: bool = True,
                 heads: Optional[Dict[str, int]] = None):
    """PartitionSpecs for every leaf of ``params`` (anything with a
    ``shape``).

    Returns ``(spec_tree, report)`` where report is JSON-serializable:
    leaf/sharded counts and the replicated-fallback paths.
    """
    flat, treedef = tree_flatten_with_path(params)
    rep: List[str] = []
    specs = []
    n_sharded = 0
    for kp, leaf in flat:
        path = tree_path_str(kp)
        s = spec_for_param(path, tuple(leaf.shape), mesh, rep, heads=heads,
                           fsdp=fsdp)
        specs.append(s)
        if any(a is not None for a in s):
            n_sharded += 1
    report = {"n_leaves": len(flat), "n_sharded": n_sharded,
              "replicated": rep, "fsdp": bool(fsdp)}
    return tree_unflatten(treedef, specs), report


def shardings_from_specs(specs, mesh):
    """PartitionSpec tree -> NamedSharding tree on ``mesh``."""
    return _tree_map(lambda s: NamedSharding(mesh, s), specs, _is_spec)


def batch_specs(shapes: Dict[str, Any], mesh) -> Dict[str, PartitionSpec]:
    """Specs for host data inputs: batch dim over the data axes (when it
    covers them); ``positions3`` carries batch on axis 1; scalars replicate."""
    _, data_axes = _mesh_axes(mesh)
    dp_n = _dp_size(mesh, data_axes)
    dp = data_axes[0] if len(data_axes) == 1 else (data_axes or None)

    def one(key: str, leaf) -> PartitionSpec:
        shape = tuple(leaf.shape)
        if not shape:
            return P()
        b_ax = 1 if key == "positions3" else 0
        spec: List[Any] = [None] * len(shape)
        if dp is not None and dp_n > 1 and shape[b_ax] % dp_n == 0:
            spec[b_ax] = dp
        return P(*spec)

    return {k: one(k, v) for k, v in shapes.items()}


def cache_specs(layers, mesh, seq_len: int, batch: int, cfg):
    """Specs for the port's per-layer decode cache (``init_cache``: one
    tuple a layer of ``cfg``), each tensor's batch on axis 0: the batch over
    the data axes, the sequence (axis 1) over ``model`` (the decode
    ``kv_seq`` rule).

    The reference's stacked cache carries its batch on axis 1 and finds
    the sequence axis as the first one of length ``seq_len``; here the
    layers are chosen by their kind (``layer_slots``), never by shape, as
    ``serve/steps.py::extend_cache`` chooses them.  The sequence-bearing
    tensors are self-attention's K and V, ``local_attn``'s and MLA's
    latent and rotary key, and a decoder layer's first two slots; its
    cross-attention K/V (the encoder's length) and the recurrent states
    shard their batch only, so a state dimension equal to ``seq_len`` by
    chance stays whole.

    The reference's decode fallback holds: when ``batch`` cannot cover the
    data axes the batch stays unsharded and the sequence goes fully
    seq-parallel over (data..., model), so the stored sharding matches the
    in-step ``kv_seq`` rule; a length that does not divide that falls back
    to ``model`` alone, or to no split."""
    from repro_torch.models.transformer import is_attention, layer_slots

    tp, data_axes = _mesh_axes(mesh)
    tp_n = _axis_size(mesh, tp)
    dp_n = _dp_size(mesh, data_axes)
    dp = data_axes[0] if len(data_axes) == 1 else (data_axes or None)

    batch_ok = dp is not None and dp_n > 1 and batch and batch % dp_n == 0
    seq_axes = ((data_axes if not batch_ok else ())
                + ((tp,) if tp and tp_n > 1 else ()))
    seq_n = 1
    for a in seq_axes:
        seq_n *= _axis_size(mesh, a)
    if seq_axes and seq_len % seq_n != 0:       # uneven: TP-only, or nothing
        seq_axes = (tp,) if tp and tp_n > 1 and seq_len % tp_n == 0 else ()
    seq_entry = (seq_axes[0] if len(seq_axes) == 1 else seq_axes) or None

    def one(leaf, seq: bool) -> PartitionSpec:
        spec: List[Any] = [None] * len(tuple(leaf.shape))
        if batch_ok:
            spec[0] = dp
        if seq:
            spec[1] = seq_entry
        return P(*spec)

    slots = layer_slots(cfg)
    layers = list(layers)
    if len(layers) != len(slots):
        raise ValueError(f"{len(layers)} cache layers for the "
                         f"{len(slots)} layers of {cfg.name}")
    out = []
    for layer, slot in zip(layers, slots):
        n_seq = 0
        if is_attention(slot.kind):
            n_seq = 2 if slot.kind == "dec_attn_mlp" else len(layer)
        out.append(tuple(one(t, i < n_seq) for i, t in enumerate(layer)))
    return out


# ---------------------------------------------------------------------------
# activation rules
# ---------------------------------------------------------------------------

class Rules(dict):
    """Logical-axis -> mesh-axis mapping plus the mesh it was built for."""

    def __init__(self, *args, mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh


def activation_rules(cfg, mesh, decode: bool = False,
                     batch: Optional[int] = None) -> Rules:
    """Build the logical-axis map for ``cfg`` on ``mesh``.

    Train: heads/kv_heads shard over ``model`` when aligned; activations
    batch-shard over the data axes; no sequence sharding.  Decode: heads stay
    unsharded and the KV cache seq-shards over ``model``; if ``batch`` cannot
    cover the data axes the batch rule drops to None and the cache goes fully
    seq-parallel over (data..., model).
    """
    tp, data_axes = _mesh_axes(mesh)
    tp_n = _axis_size(mesh, tp)
    dp_n = _dp_size(mesh, data_axes)

    def tp_fit(n: Optional[int]) -> Optional[str]:
        return tp if tp and tp_n > 1 and n and n % tp_n == 0 else None

    batch_axes: Optional[Tuple[str, ...]] = data_axes or None
    if batch is not None and dp_n > 1 and batch % dp_n != 0:
        batch_axes = None               # batch-size-aware seq-parallel fall.

    rules = Rules(mesh=mesh)
    if decode:
        rules["heads"] = None           # one-token Q is tiny; cache rules win
        rules["kv_heads"] = None
        seq_axes = (data_axes if batch_axes is None else ()) \
            + ((tp,) if tp else ())
        rules["kv_seq"] = tuple(a for a in seq_axes if a) or None
    else:
        rules["heads"] = tp_fit(getattr(cfg, "n_heads", None))
        rules["kv_heads"] = tp_fit(getattr(cfg, "n_kv_heads", None))
        rules["kv_seq"] = None
    if batch_axes is None:
        rules["batch"] = None
    else:
        rules["batch"] = batch_axes[0] if len(batch_axes) == 1 else batch_axes
    rules["mlp"] = tp_fit(getattr(cfg, "d_ff", None))
    rules["vocab"] = tp_fit(getattr(cfg, "padded_vocab", None))
    moe = getattr(cfg, "moe", None)
    rules["expert"] = tp_fit(moe.n_experts) if moe is not None else None
    rules["capacity"] = None
    rules["tokens"] = rules["batch"]
    return rules


_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_dist_activation_rules", default=None)


def bind_activation_rules(fn, rules: Rules):
    """Wrap ``fn`` so ``constrain``/``bound_*`` see ``rules`` while it
    runs."""

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        token = _ACTIVE.set(rules)
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)

    return bound


def bound_rules() -> Optional[Rules]:
    return _ACTIVE.get()


def bound_axis(name: str):
    """Mesh axis (or axes tuple) the logical ``name`` maps to, if bound."""
    rules = _ACTIVE.get()
    return None if rules is None else rules.get(name)


def bound_mesh() -> Optional[Mesh]:
    """The bound mesh, only if it is a port :class:`Mesh` (not a test
    double)."""
    rules = _ACTIVE.get()
    mesh = None if rules is None else getattr(rules, "mesh", None)
    return mesh if isinstance(mesh, Mesh) else None


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` by logical axis names.

    Unbound it is a no-op, as the reference's.  Bound, the port's meshed
    forward already holds every activation as per-entry blocks laid out by
    the rules, so there is nothing to move either: ``x`` comes back as it
    is."""
    return x
