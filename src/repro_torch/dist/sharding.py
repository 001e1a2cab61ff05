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
"""
from __future__ import annotations

from ..launch.mesh import Mesh

__all__ = ["data_axis"]

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
