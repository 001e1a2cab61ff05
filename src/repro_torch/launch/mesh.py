"""Device meshes of the port (port of ``src/repro/launch/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` over jax devices; the
port's :class:`Mesh` is the same idea over torch devices in one process:
an array of ``torch.device``s, its ``axis_names`` and its ``shape`` as a
name -> size mapping, so ``mesh.shape[axis]`` and ``mesh.axis_names`` read
as they do on a jax mesh.  A device may repeat: a machine with one card
builds a 4-entry data mesh as ``["cuda:0"] * 4``, and the CPU tests build
``["cpu"] * P``.  Each entry of a CUDA mesh gets its own CUDA stream
(created at first use), so the entries of one round run at once on one
card: the kernels launch on the current stream.

The collectives the port's mesh programs run are the two functions
below, :func:`all_gather` and :func:`ppermute` (``jax.lax``'s over a
``shard_map`` axis): each calls the hook that :func:`recording` arms
first, which is how ``repro_torch.analyze.collectives`` records a
program's ordered schedule.

``make_production_mesh`` (the reference's TPU pod shapes) has no
counterpart on one card and refuses; a ``torch.distributed`` transport
across cards waits for a machine with more than one.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceSpec = Union[str, torch.device]

__all__ = ["Mesh", "all_gather", "make_data_mesh", "make_mesh",
           "make_production_mesh", "mesh_device", "ppermute", "recording"]

CollectiveHook = Callable[[str, "Mesh", str, list], None]

# The hook :func:`recording` arms; only it sets this.
_hook: Optional[CollectiveHook] = None


@contextlib.contextmanager
def recording(hook: CollectiveHook):
    """Context: each collective below calls ``hook(name, mesh, axis,
    rows)`` before it moves anything (``rows`` holds one tensor an entry
    of ``axis``).  The hook that was armed before is restored on exit,
    also when the body raises."""
    global _hook
    previous, _hook = _hook, hook
    try:
        yield
    finally:
        _hook = previous


def _normalize(device: DeviceSpec) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev} requested but no CUDA "
                               "device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}; use 'cpu' or "
                         "'cuda[:k]'")
    return dev


class Mesh:
    """An n-D array of torch devices with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names`` and ``shape``).

    Every entry is of one device type: a mesh that mixes CPU and CUDA
    devices raises ``ValueError``.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in given.reshape(-1)]
        if len({d.type for d in flat}) > 1:
            raise ValueError("a mesh may not mix CPU and CUDA devices, got "
                             f"{[str(d) for d in flat]}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = [_normalize(d) for d in flat]
        self.devices = arr.reshape(given.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"axis_names {self.axis_names} do not match a "
                             f"device array of shape {self.devices.shape}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self._streams: Dict[tuple, torch.cuda.Stream] = {}

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at its entry 0: the
        devices one row of a collective over ``axis`` lands on."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[k] = slice(None)
        return list(self.devices[tuple(index)])

    def on(self, axis: str, k: int):
        """Context: work of entry ``k`` along ``axis`` runs on that entry's
        CUDA stream (created at first use, after the work already queued on
        the device's current stream); nothing on a CPU mesh."""
        dev = self.axis_devices(axis)[k]
        if dev.type != "cuda":
            return contextlib.nullcontext()
        stream = self._streams.get((axis, k))
        if stream is None:
            stream = torch.cuda.Stream(device=dev)
            self._streams[(axis, k)] = stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        return torch.cuda.stream(stream)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def _devices(n: int, devices: Optional[Sequence[DeviceSpec]],
             what: str) -> List[DeviceSpec]:
    """The first ``n`` of ``devices``, or of the CUDA devices when none are
    given; never the CPU in their stead."""
    if devices is None:
        devices = [f"cuda:{k}" for k in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n:
        raise RuntimeError(f"need {n} devices for {what}, have "
                           f"{len(devices)}")
    return devices[:n]


def make_mesh(shape, axes, devices: Optional[Sequence[DeviceSpec]] = None
              ) -> Mesh:
    """Arbitrary mesh over the first ``prod(shape)`` devices (the CUDA
    devices, or the ``devices`` given; an entry may repeat)."""
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    n = int(np.prod(shape))
    picked = _devices(n, devices, f"mesh {dict(zip(axes, shape))}")
    arr = np.empty(n, dtype=object)
    arr[:] = picked
    return Mesh(arr.reshape(shape), axes)


def make_data_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence[DeviceSpec]] = None) -> Mesh:
    """1-D ``(data,)`` mesh over the first ``n_devices`` (default: all).

    The mesh shape ``repro_torch.scale.shard`` and ``compute_ph(...,
    backend="tiled", mesh=...)`` expect for sharding the tile harvest and
    the packed reduction's pivot exchange.  With no ``devices`` it takes
    the CUDA devices and raises ``RuntimeError`` when there are too few
    (or none); on one card, or on the CPU, pass them: ``devices=["cuda:0"]
    * 4`` or ``["cpu"] * 4``.
    """
    avail = (torch.cuda.device_count() if devices is None
             else len(list(devices)))
    n = avail if n_devices is None else int(n_devices)
    if n < 1 or avail < n:
        raise RuntimeError(f"need {max(n, 1)} devices for a "
                           f"(data={max(n, 1)},) mesh, have {avail}")
    picked = _devices(n, devices, f"a (data={n},) mesh")
    arr = np.empty(n, dtype=object)
    arr[:] = picked
    return Mesh(arr, ("data",))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's TPU pod meshes, (data=16, model=16) or (pod=2,
    data=16, model=16): no counterpart on one card."""
    raise NotImplementedError(
        "make_production_mesh builds TPU pod shapes (256 or 512 chips); the "
        "port has no counterpart on one card, and a torch.distributed "
        "transport across cards waits for a machine with more than one "
        "(ROADMAP.md §1, the note under item 5)")


def mesh_device(mesh: Mesh, device=None) -> torch.device:
    """The device a mesh-driven call runs its single-device work on: the
    mesh's first entry, or ``device`` when it is of the mesh's type; a
    device of another type raises ``ValueError``."""
    first = mesh.devices.flat[0]
    if device is None:
        return first
    if torch.device(device).type != first.type:
        raise ValueError(f"device={device!r} is not of the mesh's device "
                         f"type {first.type!r}; pass device=None or a "
                         f"{first.type} device")
    return _normalize(device)


def all_gather(mesh: Mesh, axis: str, rows: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """``jax.lax.all_gather`` over ``axis`` as its first entry holds it:
    ``rows`` has one tensor an entry of the axis (row ``k`` where entry
    ``k`` put it), stacked in entry order onto row 0's device, a ``(size,
    ...)`` tensor.  Only that entry's copy is made: the replicas on the
    other entries wait for a transport between cards."""
    rows = list(rows)
    if _hook is not None:
        _hook("all_gather", mesh, axis, rows)
    if len(rows) != mesh.shape[axis]:
        raise ValueError(f"all_gather over {axis!r} takes one row an entry "
                         f"({mesh.shape[axis]}), got {len(rows)}")
    return torch.stack([row.to(rows[0].device) for row in rows])


def ppermute(mesh: Mesh, axis: str, xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute`` over ``axis`` under a permutation of its
    entries: ``xs`` has one tensor an entry, and for each ``(src, dst)`` of
    ``perm`` entry ``dst`` receives a copy of entry ``src``'s tensor on its
    own device (``xs[dst]``'s)."""
    xs = list(xs)
    if _hook is not None:
        _hook("ppermute", mesh, axis, xs)
    size = mesh.shape[axis]
    if len(xs) != size:
        raise ValueError(f"ppermute over {axis!r} takes one tensor an entry "
                         f"({size}), got {len(xs)}")
    entries = list(range(size))
    if sorted(s for s, _ in perm) != entries or \
            sorted(d for _, d in perm) != entries:
        raise ValueError(f"ppermute perm {list(perm)} is not a permutation "
                         f"of {size} entries")
    out = list(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device)
    return out
