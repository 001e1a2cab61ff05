"""Device engine for Dory: padded column algebra, the distributed round and
Borůvka H0 as torch programs (port of ``src/repro/core/jax_engine.py``).

The reference writes these as jnp programs that lower under ``shard_map``
on a TPU mesh; here they are torch ops on the device their inputs live on
(``device=None`` with host inputs is the card, as everywhere in the
port):

* columns are fixed-width sorted ``int64`` paired-index key arrays
  (``EMPTY`` padded);
* GF(2) column addition is :func:`merge_cancel_padded` (concatenate, sort,
  cancel equal pairs);
* the **parallel phase** (:func:`parallel_reduce`) reduces every batch
  column against a committed pivot table (binary-searched lookups,
  gathered addends);
* the **serial phase** becomes a log-depth *tournament* over the mesh's
  data axis (:func:`make_distributed_round`): partner ``i ^ step``, the
  later-ranked entry absorbs the earlier one's colliding columns;
* **H0** is a Borůvka minimum spanning forest (:func:`h0_msf_mask`:
  segment-min + pointer jumping), identical persistence pairs to
  union-find because edge orders are unique.

The reference's loops map as follows: ``fori_loop`` to a Python loop of
the same trip count, ``while_loop`` to a host loop whose test runs on the
device and reads back one flag a trip, ``.at[...].min`` to
``scatter_reduce(..., "amin")`` (``mode="drop"`` through an overflow slot
that is cut off afterwards), ``ppermute`` to a copy between mesh entries
and ``all_gather`` to a concatenation onto the mesh's first entry.  Every
function is bit-exact against the reference's on the same inputs.  The
reference's two jit wrappers (``merge_cancel_jax``, ``parallel_reduce_jit``)
have no counterpart: call the plain functions.  No entry point of the port
calls this module yet, as none of the reference's does.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["EMPTY", "merge_cancel_padded", "truncate_width",
           "parallel_reduce", "tournament_merge_local",
           "make_distributed_round", "h0_msf_mask", "connected_labels"]

EMPTY = np.int64(np.iinfo(np.int64).max)


def _as_tensor(x, device: DeviceLike = None,
               dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: on ``device`` when one is given, else
    where a tensor already lives, else on the card."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


# ---------------------------------------------------------------------------
# Column algebra (padded, fixed width)
# ---------------------------------------------------------------------------

def merge_cancel_padded(a, b, device: DeviceLike = None) -> torch.Tensor:
    """GF(2) sum of batched sorted key columns.

    a: (..., Wa), b: (..., Wb) int64 ascending with EMPTY padding; each key
    appears at most once per operand.  Returns (..., Wa+Wb) ascending EMPTY
    padded (callers truncate/track overflow).
    """
    a = _as_tensor(a, device)
    b = _as_tensor(b, a.device)
    m = torch.sort(torch.cat([a, b], dim=-1), dim=-1).values
    same = m[..., 1:] == m[..., :-1]
    edge = torch.zeros_like(m[..., :1], dtype=torch.bool)
    eq_prev = torch.cat([edge, same], dim=-1)
    eq_next = torch.cat([same, edge], dim=-1)
    cancel = (eq_prev | eq_next) & (m != int(EMPTY))
    m = torch.where(cancel, torch.full_like(m, int(EMPTY)), m)
    return torch.sort(m, dim=-1).values


def truncate_width(cols, width: int, device: DeviceLike = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip columns back to ``width`` keys, flagging overflow per row."""
    cols = _as_tensor(cols, device)
    if cols.shape[-1] <= width:
        pad = torch.full(cols.shape[:-1] + (width - cols.shape[-1],),
                         int(EMPTY), dtype=cols.dtype, device=cols.device)
        return torch.cat([cols, pad], dim=-1), \
            torch.zeros(cols.shape[:-1], dtype=torch.bool,
                        device=cols.device)
    overflow = (cols[..., width:] != int(EMPTY)).any(dim=-1)
    return cols[..., :width], overflow


# ---------------------------------------------------------------------------
# Parallel phase: reduce batch columns against the committed pivot table
# ---------------------------------------------------------------------------

def _lookup(keys_sorted: torch.Tensor, low: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of each ``low`` in ``keys_sorted`` (left search, clipped) and
    whether it is really there."""
    idx = torch.searchsorted(keys_sorted, low.contiguous())
    idx = idx.clamp(0, keys_sorted.shape[0] - 1)
    hit = (keys_sorted[idx] == low) & (low != int(EMPTY))
    return idx, hit


def parallel_reduce(cols, pivot_keys, pivot_cols, n_iters: int = 8,
                    device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iters`` rounds of: look up each column's low in the pivot table,
    XOR in the owning reduced column.  cols: (B, W); pivot_keys: (P,)
    sorted ascending (EMPTY padded); pivot_cols: (P, W).

    Returns (cols', hit_last) — a row whose low still matches a pivot after
    the budget is finished by the next round / host orchestration."""
    cols = _as_tensor(cols, device)
    pivot_keys = _as_tensor(pivot_keys, cols.device)
    pivot_cols = _as_tensor(pivot_cols, cols.device)
    W = cols.shape[-1]
    hit = torch.zeros(cols.shape[0], dtype=torch.bool, device=cols.device)
    for _ in range(n_iters):
        idx, hit = _lookup(pivot_keys, cols[:, 0])
        addend = torch.where(hit[:, None], pivot_cols[idx],
                             torch.full_like(pivot_cols[idx], int(EMPTY)))
        cols = merge_cancel_padded(cols, addend)[:, :W]
    return cols, hit


# ---------------------------------------------------------------------------
# Serial phase as a log-depth tournament over the data axis
# ---------------------------------------------------------------------------

def tournament_merge_local(cols, other, device: DeviceLike = None
                           ) -> torch.Tensor:
    """Absorb colliding partner columns: every row of ``cols`` whose low
    appears among ``other``'s lows gets that column XOR-ed in (GF(2)).
    Among partner rows with equal lows the first in row order wins, as
    under the reference's stable ``argsort``."""
    cols = _as_tensor(cols, device)
    other = _as_tensor(other, cols.device)
    W = cols.shape[-1]
    olow_s, order = torch.sort(other[:, 0], stable=True)
    oc_s = other[order]
    idx, hit = _lookup(olow_s, cols[:, 0])
    addend = torch.where(hit[:, None], oc_s[idx],
                         torch.full_like(oc_s[idx], int(EMPTY)))
    return merge_cancel_padded(cols, addend)[:, :W]


def _round_devices(mesh) -> Tuple[List[List[torch.device]], int]:
    """The mesh's entries as ``[pod][data]`` (one pod without a ``pod``
    axis; every other axis at its entry 0, where the reference's program
    is replicated) and the data-axis size."""
    from ..launch.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__module__}.{type(mesh).__qualname__}")
    names = tuple(mesh.axis_names)
    if "data" not in names:
        raise ValueError(f"mesh axes {names} have no 'data' axis")
    n_pod = mesh.shape["pod"] if "pod" in names else 1
    grid = []
    for p in range(n_pod):
        row = []
        for d in range(mesh.shape["data"]):
            index = [0] * len(names)
            index[names.index("data")] = d
            if "pod" in names:
                index[names.index("pod")] = p
            row.append(mesh.devices[tuple(index)])
        grid.append(row)
    return grid, mesh.shape["data"]


def make_distributed_round(mesh, n_parallel_iters: int = 8,
                           n_serial_rounds: Optional[int] = None
                           ) -> Callable:
    """Build the sharded serial-parallel round over the port's
    :class:`~repro_torch.launch.mesh.Mesh` (``("data",)`` or
    ``("pod", "data")``).

    Layout: batch columns split by rows over the ``(pod, data)`` entries in
    that order; pivot table replicated.  One round, per entry =
      parallel phase (no transfers)
      -> tournament serial phase over ``data`` (``n_serial_rounds``, default
         log2 of its size: entry ``i`` receives a copy of entry ``i ^ step``'s
         columns, and the later-ranked entry absorbs the collisions)
      -> the lows of every entry concatenated onto the mesh's first entry.

    Returns ``round_fn(cols, pivot_keys, pivot_cols) -> (cols, lows)``,
    both on the mesh's first entry, the rows of ``cols`` back in their
    input order.  A data axis whose partner map ``i ^ step`` leaves it (a
    size that is not a power of two, or more rounds than its log2) raises
    ``ValueError``, where the reference's permutation is malformed.
    """
    grid, data = _round_devices(mesh)
    n_rounds = n_serial_rounds if n_serial_rounds is not None else \
        max(1, int(np.log2(data)))
    steps = [1 << r for r in range(n_rounds)]
    for step in steps:
        if any(i ^ step >= data for i in range(data)):
            raise ValueError(
                f"tournament step {step} pairs entries outside a data axis "
                f"of size {data} (partner i ^ step): the data axis must be "
                "a power of two with at most log2(size) serial rounds")

    def round_fn(cols, pivot_keys, pivot_cols):
        first = grid[0][0]
        cols = _as_tensor(cols, first)
        n_entries = len(grid) * data
        if cols.shape[0] % n_entries:
            raise ValueError(f"{cols.shape[0]} columns do not split evenly "
                             f"over {n_entries} mesh entries")
        rows = cols.shape[0] // n_entries
        keys_np = _as_tensor(pivot_keys, first)
        table_np = _as_tensor(pivot_cols, first)
        out_cols, out_lows = [], []
        for p, row in enumerate(grid):
            keys = [keys_np.to(dev) for dev in row]
            table = [table_np.to(dev) for dev in row]
            local = []
            for d, dev in enumerate(row):
                k = p * data + d
                c = cols[k * rows:(k + 1) * rows].to(dev)
                local.append(parallel_reduce(c, keys[d], table[d],
                                             n_iters=n_parallel_iters)[0])
            for step in steps:
                # ppermute: every entry reads its partner's columns as they
                # stood before this round
                other = [local[d ^ step].to(dev)
                         for d, dev in enumerate(row)]
                nxt = []
                for d in range(data):
                    c = local[d]
                    if d & step:               # partner ranked earlier
                        c = tournament_merge_local(c, other[d])
                    nxt.append(parallel_reduce(c, keys[d], table[d],
                                               n_iters=2)[0])
                local = nxt
            out_cols.extend(c.to(first) for c in local)
            out_lows.extend(c[:, 0].to(first) for c in local)
        return torch.cat(out_cols), torch.cat(out_lows)

    return round_fn


# ---------------------------------------------------------------------------
# H0 via Borůvka MSF (log-depth, exact persistence pairs)
# ---------------------------------------------------------------------------

def _boruvka(edges, n: int, device: DeviceLike = None
             ) -> Tuple[torch.Tensor, int]:
    """:func:`h0_msf_mask` and the number of Borůvka rounds it ran."""
    edges = _as_tensor(edges, device)
    dev = edges.device
    n_e = edges.shape[0]
    eo = torch.arange(n_e, dtype=torch.int64, device=dev)
    inf = torch.full((n,), n_e, dtype=torch.int64, device=dev)
    ident = torch.arange(n + 1, dtype=torch.int64, device=dev)
    label = torch.arange(n, dtype=torch.int64, device=dev)
    in_msf = torch.zeros(n_e, dtype=torch.bool, device=dev)
    rounds = 0
    go = n_e > 0
    while go:
        rounds += 1
        la = label[edges[:, 0]]
        lb = label[edges[:, 1]]
        cross = la != lb
        w = torch.where(cross, eo, torch.full_like(eo, n_e))
        best = inf.scatter_reduce(0, la, w, "amin")
        best = best.scatter_reduce(0, lb, w, "amin")
        chosen = ((best[la] == eo) | (best[lb] == eo)) & cross
        in_msf |= chosen
        lo = torch.minimum(la, lb)
        hi = torch.maximum(la, lb)
        # ``.at[where(chosen, hi, n)].min(..., mode="drop")``: slot n takes
        # the unchosen edges and is cut off
        parent = ident.scatter_reduce(
            0, torch.where(chosen, hi, torch.full_like(hi, n)),
            torch.where(chosen, lo, torch.full_like(lo, n)), "amin")[:n]
        while bool((parent[parent] != parent).any()):
            parent = parent[parent]
        label = parent[label]
        go = bool(chosen.any())
    return in_msf, rounds


def h0_msf_mask(edges, n: int, device: DeviceLike = None) -> torch.Tensor:
    """Minimum-spanning-forest mask over edges sorted by filtration order.

    edges: (n_e, 2) integer, row index = filtration order (unique ⇒ unique
    MSF ⇒ identical H0 persistence pairs to Kruskal/union-find).
    Returns bool (n_e,) — True exactly for H0 death edges (clearing input).
    """
    return _boruvka(edges, n, device)[0]


def connected_labels(edges, n: int, rounds: int = 16,
                     device: DeviceLike = None) -> torch.Tensor:
    """Component labels by hook + pointer-jumping (betti_0 at a scale)."""
    edges = _as_tensor(edges, device)
    parent = torch.arange(n, dtype=torch.int64, device=edges.device)
    for _ in range(rounds):
        pa = parent[edges[:, 0]]
        pb = parent[edges[:, 1]]
        lo = torch.minimum(pa, pb)
        hi = torch.maximum(pa, pb)
        parent = parent.scatter_reduce(0, hi, lo, "amin")
        parent = parent[parent]
        parent = parent[parent]
    return parent
