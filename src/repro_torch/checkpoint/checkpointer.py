"""Checkpointing: atomic, async, verified on restore.

Port of ``src/repro/checkpoint/checkpointer.py``, with the same layout::

    <dir>/step_<N>/manifest.json     # paths, shapes, dtypes, sha256s, metadata
    <dir>/step_<N>/<leaf-path>.npy   # one file per tree leaf

Leaf names come from :func:`repro_torch.dist.sharding.tree_flatten_with_path`
and ``tree_path_str``, in jax's flatten order, so a tree in the reference's
layout (``repro_torch.train.train_state_to_arrays``) gives the reference's
files, manifest and digests, and a checkpoint written by either package
restores in the other.  A tree's leaves may be torch tensors (copied to
the host) or numpy arrays.

Writes go to ``step_<N>.tmp`` then atomically rename — a crashed save never
corrupts the latest checkpoint.  ``save_async`` copies the tree to the host,
then runs the write on a thread so the train loop overlaps I/O with compute.
``restore`` gives each leaf the template leaf's type, dtype and, for a
tensor, device.  With ``shardings`` (a tree of
:class:`~repro_torch.dist.sharding.NamedSharding` congruent with the
template) each leaf is restored to the host, then laid out on its
placement: a :class:`~repro_torch.dist.sharding.ShardedTensor`.  A tree
holding sharded tensors is saved whole, so the files on disk are whole
arrays under the reference's leaf names whatever the mesh, and a
checkpoint written on one mesh shape restores onto another, or onto none.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import to_host
from repro_torch.dist.sharding import (NamedSharding, ShardedTensor,
                                       tree_flatten_with_path, tree_path_str,
                                       tree_unflatten)
from repro_torch.resilience.faults import CheckpointCorruption


def _leaf_digest(arr: np.ndarray) -> str:
    """sha256 of the array's bytes in C order (the reference's
    ``tobytes()``), hashed in place rather than from a copy."""
    return hashlib.sha256(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


def _leaf_files(tree) -> Dict[str, Any]:
    flat = tree_flatten_with_path(tree)[0]
    return {tree_path_str(kp).replace("/", "__"): leaf for kp, leaf in flat}


def _host_tree(tree):
    flat, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [
        to_host(leaf.unshard() if isinstance(leaf, ShardedTensor) else leaf)
        for _, leaf in flat])


def _like(arr: np.ndarray, leaf):
    """``arr`` as the template's leaf type: a tensor of its dtype on its
    device, a numpy array of its dtype, else as loaded."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return np.asarray(arr, dtype=leaf.dtype)
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ----
    def save(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        host_tree = _host_tree(tree)       # device->host sync here
        self._write(step, host_tree, metadata or {})

    def save_async(self, step: int, tree, metadata: Optional[dict] = None):
        self.wait()
        host_tree = _host_tree(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, metadata or {}))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_tree, metadata: dict):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = _leaf_files(host_tree)
        manifest = {"step": step, "metadata": metadata, "leaves": {}}
        for name, leaf in leaves.items():
            np.save(os.path.join(tmp, name + ".npy"), leaf)
            manifest["leaves"][name] = {
                "shape": list(leaf.shape), "dtype": str(leaf.dtype),
                "sha256": _leaf_digest(leaf)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- restore ----
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                shardings=None, verify: bool = True):
        """Restore into the structure of ``template``: each leaf a tensor
        of the template leaf's dtype on its device, or a numpy array of its
        dtype.  ``shardings`` (a congruent tree of ``NamedSharding``s, the
        reference's target placements on a mesh) lays each restored leaf
        out on its placement (the reshard-on-restore of an elastic
        re-mesh).

        With ``verify`` (the default) every leaf whose manifest entry
        carries a ``sha256`` is re-hashed after load; a mismatch — bit rot,
        a torn write that beat the atomic rename, a truncated .npy — raises
        :class:`~repro_torch.resilience.faults.CheckpointCorruption` instead
        of silently restoring wrong weights.  Pre-hash checkpoints (no
        ``sha256`` field) restore unverified for compatibility."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruption(
                f"unreadable manifest in {d!r}: {e}") from e

        flat, treedef = tree_flatten_with_path(template)
        shard_flat = None
        if shardings is not None:
            shard_flat = [s for _, s in tree_flatten_with_path(
                shardings, lambda x: isinstance(x, NamedSharding))[0]]
            if len(shard_flat) != len(flat) or not all(
                    isinstance(s, NamedSharding) for s in shard_flat):
                raise ValueError(
                    f"shardings: {len(shard_flat)} leaves for a template of "
                    f"{len(flat)}; pass one NamedSharding a leaf")
        leaves = []
        for i, (kp, leaf) in enumerate(flat):
            name = tree_path_str(kp).replace("/", "__")
            try:
                arr = np.load(os.path.join(d, name + ".npy"))
                expect = manifest["leaves"][name]
            except (OSError, ValueError, KeyError) as e:
                raise CheckpointCorruption(
                    f"unreadable leaf {name!r} in {d!r}: {e}") from e
            if list(arr.shape) != expect["shape"]:
                raise CheckpointCorruption(
                    f"leaf {name!r} shape {list(arr.shape)} != manifest "
                    f"{expect['shape']} in {d!r}")
            if verify and expect.get("sha256") is not None \
                    and _leaf_digest(arr) != expect["sha256"]:
                raise CheckpointCorruption(
                    f"leaf {name!r} failed sha256 verification in {d!r}")
            arr = _like(arr, leaf)
            leaves.append(arr if shard_flat is None
                          else shard_flat[i].shard(arr))
        return tree_unflatten(treedef, leaves), manifest["metadata"]

    def restore_latest_valid(self, template, shardings=None):
        """Walk checkpoints newest-first, restoring the first one that
        passes verification — the fall-back-to-older-step recovery line
        when the latest save is corrupt.  Returns ``(tree, metadata,
        step)``; raises :class:`CheckpointCorruption` when every step is
        bad and ``FileNotFoundError`` when there are none."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Optional[Exception] = None
        for step in reversed(steps):
            try:
                tree, meta = self.restore(template, step=step,
                                          shardings=shardings)
                return tree, meta, step
            except CheckpointCorruption as e:
                last_err = e
        raise CheckpointCorruption(
            f"every checkpoint in {self.dir!r} is corrupt; "
            f"last error: {last_err}")
