"""Dry-run every (architecture x input-shape x mesh) cell on fake tensors
(port of ``src/repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 256- and 512-chip
TPU meshes and reads the compiled module.  PyTorch runs eagerly and has no
compiled module, so the port builds each cell on fake tensors
(``launch/specs.py``) and runs its step once inside :func:`trace_step`, a
dispatch mode that sees every operation the step dispatches, as the card
would run it, and allocates nothing.  It records, per cell:

* FLOPs, by ``torch.utils.flop_counter``'s formulas and its rule (an
  operation that decomposes counts as its parts), as ``FlopCounterMode``
  counts them, split by the operands' dtype; the flash kernel's custom
  operator has its own formula (``kernels/flash_attention.py``).
  ``FlopCounterMode`` itself is not used: its module tracker holds each
  microbatch's checkpointed tensors past their end, which would
  overstate the peak;
* HBM traffic: Σ (input + output bytes) over every dispatched operation
  that is not a view.  Eager PyTorch runs each operation as its own launch,
  so this is the counterpart of the reference's "one buffer per top-level
  post-fusion op"; views, ``detach`` and allocations that write nothing
  are free, as ``parameter``/``bitcast`` are in ``launch/hlo.py``.  An
  expanded (stride-0) dimension is read once;
* memory: the arguments', the outputs' and the aliased bytes (outputs
  that are argument storages updated in place), and the peak: the largest
  sum of live storages' bytes after any operation, each storage kept by a
  weak reference (``StorageWeakRef``), so it leaves the sum when the step
  drops it;
* collectives: count and bytes by kind, from the hook that
  ``launch/mesh.py::recording`` arms (``psum`` and ``pmax`` are
  all-reduces,
  ``all_gather`` and the FSDP ``gather_blocks`` all-gathers, ``all_to_all``
  an all-to-all, ``ppermute`` a collective-permute); a collective's bytes
  are those of the rows it is handed.

**Trip weighting.**  A train cell has ``n_micro`` microbatches (256 for
``train_4k`` on one card).  The trace runs the cell's step built for one
microbatch on the first microbatch's rows: what it dispatches inside the
step's ``train/micro`` span is weighted by ``n_micro``, the rest (the
accumulators, AdamW) counted once, as ``launch/hlo.py`` weights a
``while`` body by its trip count.  The unweighted counts stand where the
reference puts XLA's unweighted ones (``cost.xla_unweighted_*``).

**Roofline** (one NVIDIA H100 SXM, NVIDIA's data sheet, 700 W): 989e12
FLOP/s for bfloat16 (and float16) and 67e12 FLOP/s for float32 outside the
tensor cores (TF32 is off), each dtype's FLOPs charged at its own peak
(any other dtype at float32's); 3.35e12 B/s of HBM.  The mesh's entries
all sit on one card, so a collective is a copy inside it: ``collective_s``
is its bytes over the HBM bandwidth, and the ICI and DCN terms are 0.

**Meshes** (``mesh_kind``): ``"card"``, the unmeshed step on one device
(a mesh of one entry), which is what the H100 runs; ``"entries"``, the
meshed step on ``(data 4, model 2)`` entries of one card: the train step,
as ``chip_smoke.py``'s ``train_mesh`` runs it, and the prefill and decode
steps of every family, as its ``serve_mesh`` runs them (their parameters
laid out by ``shard_params(..., fsdp=False)``, the decode cache by
``cache_specs``); ``long_500k`` runs for the sub-quadratic families
(xlstm, recurrentgemma) and stays a skip for the others, as the reference
marks it.  The port's ``Mesh`` dispatches its entries
one after another, so a trace of the reference's 256-chip meshes would
cost 256x the host work and describe no machine the port runs on:
``"single"`` and ``"multi"`` refuse, as
``launch/mesh.py::make_production_mesh`` does.

A record keeps the reference's keys: ``compile_s`` is 0.0 (eager has no
compile step), ``lower_s`` the seconds of building and tracing the cell,
``chips`` the number of cards.  The shapes are the reference's and are not
cut, so a record may show a peak far over the card's 80 GB.  Artifacts go
to ``artifacts_torch/dryrun/<mesh>/<arch>__<shape>.json`` at the root of
the repository; ``--save-hlo`` writes the trace's operation table beside
the record (the port has no HLO).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh card --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.sharding import ShardedTensor
from repro_torch.obs.trace import Tracer, stopwatch, tracing

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12           # bytes/s
ENTRIES = (4, 2)           # the "entries" mesh: (data, model) of one card
PH_ENTRIES = 4             # run_ph_cell's "entries" mesh: (data,)
MESH_KINDS = ("card", "entries")

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "artifacts_torch", "dryrun")

# The port's collectives (launch/mesh.py) by the HLO kind they stand for
_KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
          "all_gather": "all-gather",
          "all_to_all": "all-to-all", "ppermute": "collective-permute"}
# Dispatched operations that move no bytes: allocations that write
# nothing, and metadata (views are found by their schema)
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size",
         "_local_scalar_dense", "resize_", "set_"}
_MICRO_SPAN = "train/micro"
# Operations seen not to decompose (``OpOverload.decompose`` gave
# NotImplemented), so that the trace tries each once
_WHOLE = set()
_DEVICE = torch.ops.prim.device.default


def roofline_terms(per_dev_flops: Union[float, Mapping[str, float]],
                   per_dev_bytes: float,
                   coll: Dict[str, float]) -> Dict[str, float]:
    """The three terms on one H100.  ``per_dev_flops`` is a mapping of
    dtype name -> FLOPs, each charged at its dtype's peak, or one number,
    charged at bfloat16's."""
    if not isinstance(per_dev_flops, Mapping):
        per_dev_flops = {"bfloat16": float(per_dev_flops)}
    return {
        "compute_s": sum(f / PEAK_FLOPS.get(d, PEAK_FLOPS["float32"])
                         for d, f in per_dev_flops.items()),
        "memory_s": per_dev_bytes / HBM_BW,
        "collective_s": coll.get("total", 0.0) / HBM_BW,
        "collective_ici_s": 0.0,
        "collective_dcn_s": 0.0,
    }


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements, an expanded (stride-0) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= int(size)
    return n * t.element_size()


def _tensors(obj, out=None) -> list:
    """Every tensor of a tree of arguments or results: tensors, modules'
    parameters and buffers, ``ShardedTensor`` blocks, and the entries of
    lists, tuples and dicts."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _tensors(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _tensors(v, out)
    elif isinstance(obj, torch.nn.Module):
        out.extend(obj.parameters())
        out.extend(obj.buffers())
    elif isinstance(obj, ShardedTensor):
        out.extend(obj.blocks)
    return out


def _storages(obj) -> Dict[int, int]:
    """The distinct storages of ``obj``'s tensors: key -> bytes."""
    from torch.multiprocessing.reductions import StorageWeakRef

    out = {}
    for t in _tensors(obj):
        st = t.untyped_storage()
        out[StorageWeakRef(st).cdata] = st.nbytes()
    return out


class LiveBytes:
    """The bytes of the storages alive, and their peak.  :meth:`add`
    registers a tensor's storage once; a storage leaves when nothing holds
    it any more.  ``upper`` counts every storage registered and not yet
    seen dead, so the live storages are swept only when ``upper`` passes
    the peak: the peak is exact at each call of :meth:`add`."""

    def __init__(self):
        self.live: Dict[int, Any] = {}
        self.upper = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        if ref.cdata in self.live:
            return
        n = st.nbytes()
        self.live[ref.cdata] = (ref, n)
        self.upper += n
        if self.upper > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.upper)

    def sweep(self) -> None:
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.upper -= self.live.pop(k)[1]


@dataclasses.dataclass
class _Counts:
    """What one phase of a trace dispatched."""

    flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    traffic_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    ops: Dict[str, list] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0.0, 0.0]))


@dataclasses.dataclass
class StepTrace:
    """A traced step's counts: ``flops`` by dtype, ``traffic_bytes`` and
    ``collectives`` (bytes by kind, ``count_<kind>``, ``total``, ``ici``,
    ``dcn``) weighted by ``n_micro``, FLOPs and bytes also unweighted
    (``*_once``); the memory in bytes; the operation table (name ->
    [count, FLOPs, bytes], weighted); the trace's seconds and the step's
    result (fake tensors)."""

    flops: Dict[str, float]
    flops_once: Dict[str, float]
    traffic_bytes: float
    traffic_bytes_once: float
    collectives: Dict[str, float]
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int
    ops: Dict[str, list]
    seconds: float
    out: Any = None

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def temp_bytes(self) -> int:
        return (self.peak_bytes - self.argument_bytes - self.output_bytes
                + self.alias_bytes)


class _TraceMode(TorchDispatchMode):
    """Counts each dispatched operation into the phase it runs in (inside
    a ``train/micro`` span or not) and keeps the live storages."""

    def __init__(self):
        super().__init__()
        self.outside, self.inside = _Counts(), _Counts()
        self.depth = 0                  # open train/micro spans
        self.live = LiveBytes()

    @property
    def phase(self) -> _Counts:
        return self.inside if self.depth else self.outside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # FlopCounterMode's rule: an operation that decomposes is counted
        # as its parts, any other by its formula in the registry
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if func is _DEVICE:             # a fake tensor's ``.device``
            return func(*args, **kwargs)
        if func not in _WHOLE:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            _WHOLE.add(func)
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) \
            if formula is not None else 0.0
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        name = func.__name__.split(".")[0]
        moved = 0
        if not (func.is_view or name in _FREE):
            moved = sum(map(_tensor_bytes, ins)) + sum(map(_tensor_bytes,
                                                           outs))
        counts = self.phase
        if flops:
            dtype = next((t.dtype for t in ins if t.is_floating_point()),
                         ins[0].dtype if ins else torch.float32)
            counts.flops[str(dtype).replace("torch.", "")] += flops
        counts.traffic_bytes += moved
        row = counts.ops[name]
        row[0] += 1
        row[1] += flops
        row[2] += moved
        for t in outs:
            self.live.add(t)
        return out

    def collective(self, name, mesh, axis, rows) -> None:
        kind = _KINDS[name]
        n = float(sum(_tensor_bytes(r) for r in rows))
        c = self.phase.collectives
        c[kind] += n
        c["total"] += n
        c[f"count_{kind}"] += 1


class _MicroSpans(Tracer):
    """A tracer that tells the trace when a ``train/micro`` span opens and
    closes."""

    def __init__(self, mode: _TraceMode):
        super().__init__()
        self.mode = mode

    def _open_enter(self, ctx) -> None:
        super()._open_enter(ctx)
        if ctx.name == _MICRO_SPAN:
            self.mode.depth += 1

    def _open_exit(self, ctx) -> None:
        super()._open_exit(ctx)
        if ctx.name == _MICRO_SPAN:
            self.mode.depth -= 1


def _weighted(once: Dict[str, float], inside: Dict[str, float],
              n: int) -> Dict[str, float]:
    keys = set(once) | set(inside)
    return {k: once.get(k, 0.0) + n * inside.get(k, 0.0) for k in keys}


def _collectives(c: Dict[str, float]) -> Dict[str, float]:
    out = dict(c)
    for k in ("total", "ici", "dcn"):
        out.setdefault(k, 0.0)
    return out


def trace_step(fn, args, fake_mode, n_micro: int = 1) -> StepTrace:
    """Run ``fn(*args)`` once in ``fake_mode`` (the mode ``args`` were
    made in) and count what it dispatches.  What runs inside a
    ``train/micro`` span is weighted by ``n_micro``: pass the microbatch
    count when ``fn`` is the step built for one microbatch."""
    from repro_torch.launch.mesh import recording

    with fake_mode:
        argument = _storages(args)
        mode = _TraceMode()
        for t in _tensors(args):
            mode.live.add(t)
        with stopwatch("dryrun/trace") as sw, mode, \
                tracing(_MicroSpans(mode)), recording(mode.collective):
            out = fn(*args)
        output = _storages(out)
    outside, inside = mode.outside, mode.inside
    ops = defaultdict(lambda: [0, 0.0, 0.0])
    for counts, w in ((outside, 1), (inside, n_micro)):
        for k, (n, f, b) in counts.ops.items():
            row = ops[k]
            row[0] += w * n
            row[1] += w * f
            row[2] += w * b
    return StepTrace(
        flops=_weighted(outside.flops, inside.flops, n_micro),
        flops_once=_weighted(outside.flops, inside.flops, 1),
        traffic_bytes=outside.traffic_bytes
        + n_micro * inside.traffic_bytes,
        traffic_bytes_once=outside.traffic_bytes + inside.traffic_bytes,
        collectives=_collectives(_weighted(
            outside.collectives, inside.collectives, n_micro)),
        argument_bytes=sum(argument.values()),
        output_bytes=sum(output.values()),
        alias_bytes=sum(n for k, n in output.items() if k in argument),
        peak_bytes=mode.live.peak, ops=dict(ops), seconds=sw.elapsed,
        out=out)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _mesh(mesh_kind: str, device, shape, axes):
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    if mesh_kind in ("single", "multi"):
        make_production_mesh(multi_pod=(mesh_kind == "multi"))
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh_kind {mesh_kind!r}: expected one of "
                         f"{MESH_KINDS}")
    dev = resolve_device(device)
    if mesh_kind == "card":
        shape = (1,) * len(axes)
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes, devices=[dev] * n)


def _memory(tr: StepTrace) -> Dict[str, int]:
    return dict(argument_bytes=tr.argument_bytes,
                output_bytes=tr.output_bytes, temp_bytes=tr.temp_bytes,
                alias_bytes=tr.alias_bytes, code_bytes=0,
                peak_bytes=tr.peak_bytes)


def _roofline(tr: StepTrace, model_flops: float, chips: int) -> dict:
    terms = roofline_terms(tr.flops, tr.traffic_bytes, tr.collectives)
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=lambda k: terms[k])
    total = tr.total_flops * chips
    bound_s = max(terms["compute_s"], terms["memory_s"],
                  terms["collective_s"])
    mfu_bound = (model_flops / PEAK_FLOPS["bfloat16"] / chips) / bound_s \
        if bound_s > 0 else 0.0
    return dict(terms, dominant=dominant, model_flops=model_flops,
                useful_flop_ratio=(model_flops / total if total else 0.0),
                mfu_upper_bound=mfu_bound)


def _collectives_record(tr: StepTrace) -> Dict[str, float]:
    """The collectives, and the weighted count of each operation that
    carries FLOPs (``count_mm``, ``count_flash_attention``, ...), as the
    reference's record counts its ``dot``s beside its collectives."""
    out = dict(tr.collectives)
    out.update({f"count_{k}": float(n) for k, (n, f, _) in tr.ops.items()
                if f})
    return out


def _chips(mesh) -> int:
    return len({str(d) for d in mesh.devices.flat})


def _save_ops(rec: Dict[str, Any], tr: StepTrace) -> None:
    """The trace's operation table beside the record (``--save-hlo``)."""
    rec["hlo_path"] = _artifact_path(rec["arch"], rec["shape"], rec["mesh"],
                                     suffix=".ops.txt")
    os.makedirs(os.path.dirname(rec["hlo_path"]), exist_ok=True)
    rows = sorted(tr.ops.items(), key=lambda kv: -kv[1][2])
    with open(rec["hlo_path"], "w") as f:
        f.write("op\tcount\tflops\tbytes\n")
        for name, (n, fl, b) in rows:
            f.write(f"{name}\t{n:.0f}\t{fl:.0f}\t{b:.0f}\n")


def run_cell(arch: str, shape: str, mesh_kind: str,
             overrides: Optional[dict] = None,
             save_hlo: bool = False, device=None) -> Dict[str, Any]:
    """Build and trace one cell on fake tensors of ``device`` (the card by
    default); return the roofline record."""
    from repro_torch.configs import canonical, cells
    from repro_torch.launch.specs import build_cell

    arch = canonical(arch)
    cell_specs = cells(arch)
    spec = cell_specs[shape]
    rec: Dict[str, Any] = dict(arch=arch, shape=shape, mesh=mesh_kind,
                               overrides=overrides or {})
    if spec["skip"]:
        rec.update(status="skip", skip_reason=spec["skip_reason"])
        return rec

    mesh = _mesh(mesh_kind, device, ENTRIES, ("data", "model"))
    chips = _chips(mesh)
    with stopwatch("dryrun/lower") as sw_lower:
        cell = build_cell(arch, shape, mesh, overrides=overrides)
        fn, args = cell.micro or (cell.fn, cell.args)
        n_micro = cell.meta["n_micro"] if cell.micro else 1
        tr = trace_step(fn, args, cell.fake_mode, n_micro=n_micro)
    model_flops = cell.meta["model_flops"]
    rec.update(
        status="ok",
        kind=cell.kind,
        chips=chips,
        lower_s=round(sw_lower.elapsed, 2),
        compile_s=0.0,
        memory=_memory(tr),
        cost=dict(per_device_flops=tr.total_flops,
                  per_device_bytes=tr.traffic_bytes,
                  total_flops=tr.total_flops * chips,
                  xla_unweighted_flops=float(sum(tr.flops_once.values())),
                  xla_unweighted_bytes=tr.traffic_bytes_once,
                  flops_by_dtype=dict(tr.flops)),
        collectives=_collectives_record(tr),
        roofline=_roofline(tr, model_flops, chips),
        meta=dict(params=cell.meta["params"],
                  n_micro=cell.meta.get("n_micro"),
                  seq_len=cell.meta["seq_len"],
                  global_batch=cell.meta["global_batch"],
                  sharding_report=_report(cell.meta["sharding_report"]),
                  entries=int(mesh.devices.size),
                  device=str(mesh.devices.flat[0])),
    )
    if save_hlo:
        _save_ops(rec, tr)
    return rec


def _report(report: Dict[str, Any]) -> Dict[str, Any]:
    """``shard_params``'s report with its replicated paths cut at 40 (the
    reference slices the report itself, a dict, and raises there)."""
    return dict(report, replicated=list(report["replicated"])[:40])


PH_SHAPES = {
    # (columns per device, column width in keys, pivot-table entries)
    "ph_round_64k": dict(b_per_dev=256, width=64, n_pivots=2**20),
    "ph_round_wide": dict(b_per_dev=1024, width=128, n_pivots=2**22),
}


def run_ph_cell(shape: str, mesh_kind: str,
                overrides: Optional[dict] = None,
                save_hlo: bool = False, device=None) -> Dict[str, Any]:
    """Trace the paper's distributed serial-parallel reduction round
    (``core/device_engine.py::make_distributed_round``) on fake tensors:
    ``b_per_dev`` columns an entry of a ``(data,)`` mesh of 1 entry
    (``card``: no tournament round, there is no partner) or 4 entries of
    one card (``entries``), the pivot table replicated."""
    from repro_torch.core import device_engine as de
    from torch._subclasses.fake_tensor import FakeTensorMode

    p = dict(PH_SHAPES[shape])
    if overrides:
        p.update(overrides)
    mesh = _mesh(mesh_kind, device, (PH_ENTRIES,), ("data",))
    entries = int(mesh.devices.size)
    chips = _chips(mesh)
    b_total = p["b_per_dev"] * entries
    w, n_piv = p["width"], p["n_pivots"]
    first = mesh.devices.flat[0]
    with stopwatch("dryrun/lower") as sw_lower:
        round_fn = de.make_distributed_round(
            mesh, n_parallel_iters=p.get("n_parallel_iters", 8),
            n_serial_rounds=None if entries > 1 else 0)
        mode = FakeTensorMode()
        with mode:
            args = tuple(torch.empty(s, dtype=torch.int64, device=first)
                         for s in ((b_total, w), (n_piv,), (n_piv, w)))
        tr = trace_step(round_fn, args, mode)
    rec = dict(
        arch="dory_ph", shape=shape, mesh=mesh_kind, status="ok",
        kind="ph_round", chips=chips,
        lower_s=round(sw_lower.elapsed, 2), compile_s=0.0,
        memory=_memory(tr),
        cost=dict(per_device_flops=tr.total_flops,
                  per_device_bytes=tr.traffic_bytes),
        collectives=_collectives_record(tr),
        roofline=dict(_roofline(tr, 0.0, chips), model_flops=0.0,
                      useful_flop_ratio=0.0, mfu_upper_bound=0.0),
        meta=dict(b_per_dev=p["b_per_dev"], width=w, n_pivots=n_piv,
                  seq_len=0, global_batch=b_total, params={},
                  sharding_report=[], entries=entries, device=str(first)),
        overrides=overrides or {},
    )
    if save_hlo:
        _save_ops(rec, tr)
    return rec


def _artifact_path(arch: str, shape: str, mesh_kind: str,
                   suffix: str = ".json") -> str:
    return os.path.join(ARTIFACT_DIR, mesh_kind, f"{arch}__{shape}{suffix}")


def save_record(rec: Dict[str, Any]) -> str:
    path = _artifact_path(rec["arch"], rec["shape"], rec["mesh"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def print_summary(rec: Dict[str, Any]) -> None:
    if rec["status"] == "skip":
        print(f"[SKIP] {rec['arch']} x {rec['shape']} ({rec['mesh']}): "
              f"{rec['skip_reason']}")
        return
    if rec["status"] != "ok":
        print(f"[FAIL] {rec['arch']} x {rec['shape']} ({rec['mesh']}): "
              f"{rec.get('error', '?')}")
        return
    m = rec["memory"]
    r = rec["roofline"]
    print(f"[ OK ] {rec['arch']} x {rec['shape']} ({rec['mesh']}, "
          f"{rec['chips']} chips) "
          f"trace {rec['lower_s']}s | "
          f"per-dev peak {m['peak_bytes'] / 2**30:.2f} GiB | "
          f"compute {r['compute_s'] * 1e3:.2f} ms "
          f"memory {r['memory_s'] * 1e3:.2f} ms "
          f"collective {r['collective_s'] * 1e3:.2f} ms "
          f"-> {r['dominant'].replace('_s', '')}-bound | "
          f"useful-FLOP {r['useful_flop_ratio']:.2f} "
          f"MFU<= {r['mfu_upper_bound']:.2f}")


def _sweep(mesh_kinds, archs, shapes, jobs: int, device=None) -> int:
    """Run every cell in a subprocess (isolation: one crash cannot take
    down the sweep)."""
    tasks = [(a, s, m) for m in mesh_kinds for a in archs for s in shapes]
    failures = 0
    running: list = []

    def reap(block: bool) -> int:
        nonlocal failures
        done = []
        for p, desc in running:
            if p.poll() is not None or block:
                p.wait()
                if p.returncode != 0:
                    failures += 1
                    print(f"[FAIL] {desc} (exit {p.returncode})")
                done.append((p, desc))
        for item in done:
            running.remove(item)
        return len(done)

    for arch, shape, mesh_kind in tasks:
        while len(running) >= jobs:
            if not reap(block=False):
                time.sleep(2)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh_kind]
        if device is not None:
            cmd += ["--device", device]
        running.append((subprocess.Popen(cmd), f"{arch} x {shape} "
                        f"({mesh_kind})"))
    while running:
        if not reap(block=False):
            time.sleep(2)
    return failures


def main() -> None:
    from repro_torch.configs import ARCHS, SHAPES

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh",
                    choices=MESH_KINDS + ("single", "multi", "both"),
                    default="card")
    ap.add_argument("--sweep", action="store_true",
                    help="all (arch x shape) cells, one subprocess each")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the trace's operation table beside the "
                         "record")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (perf experiments)")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device: the card by default, "
                         "or cpu")
    args = ap.parse_args()

    mesh_kinds = MESH_KINDS if args.mesh == "both" else (args.mesh,)
    if args.sweep:
        archs = [args.arch] if args.arch else list(ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        failures = _sweep(mesh_kinds, archs, shapes, args.jobs, args.device)
        print(f"sweep done, {failures} failures")
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --sweep")
    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    rc = 0
    for mesh_kind in mesh_kinds:
        try:
            if args.arch == "dory_ph":
                rec = run_ph_cell(args.shape, mesh_kind,
                                  overrides=overrides or None,
                                  save_hlo=args.save_hlo, device=args.device)
            else:
                rec = run_cell(args.arch, args.shape, mesh_kind,
                               overrides=overrides or None,
                               save_hlo=args.save_hlo, device=args.device)
        except Exception as e:  # noqa: BLE001 — record, report, nonzero exit
            rec = dict(arch=args.arch, shape=args.shape, mesh=mesh_kind,
                       status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            rc = 1
        if not overrides:
            save_record(rec)
        print_summary(rec)
    sys.exit(rc)


if __name__ == "__main__":
    main()
