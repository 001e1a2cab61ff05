"""Mesh-axis choice of the PH paths (port of the part of
``src/repro/dist/sharding.py`` that the mesh path reads).

The reference's ``tile_specs`` and ``reduce_specs`` return jax
``PartitionSpec``s around one choice: the innermost data axis present,
``"data"`` when the mesh has it, else ``"pod"``.  The tile harvest shards
its rounds over that axis and the packed reduction gathers its
pivot-exchange payloads over it.  The port keeps that choice and the two
``ValueError`` messages; the parameter and activation rules come with the
rest of the LM substrate (ROADMAP.md §1 item 10).

Only the port's own :class:`~repro_torch.launch.mesh.Mesh` is taken: any
other object, a jax mesh among them, raises ``TypeError`` instead of being
read as a shard count.

The tree paths come along for the checkpointer: :func:`tree_path_str` is
the reference's, and :func:`tree_flatten_with_path` flattens a tree in the
order ``jax.tree_util.tree_flatten_with_path`` does (dict keys sorted, list
and tuple entries by index, NamedTuple fields by name in their declared
order, ``None`` an empty subtree with no leaf), so a checkpoint's leaf
names are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

from ..launch.mesh import Mesh

__all__ = ["data_axis", "tree_flatten_with_path", "tree_path_str",
           "tree_unflatten"]

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


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``([(key_path, leaf), ...], treedef)`` in jax's order; a leaf is
    anything but a dict, list, tuple or ``None``.  ``treedef`` is what
    :func:`tree_unflatten` rebuilds the tree from."""
    out: List[Tuple[tuple, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
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
    return out, tree


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` (a tree of the same structure) with
    ``leaves`` in flatten order."""
    it = iter(leaves)

    def fill(node):
        if node is None:
            return None
        if isinstance(node, dict):
            got = {k: fill(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(fill(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return next(it)

    tree = fill(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return tree


_END = object()
