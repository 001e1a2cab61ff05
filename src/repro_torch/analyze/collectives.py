"""Collective-schedule extraction and deadlock detection over the port's
mesh (port of ``src/repro/analyze/collectives.py``).

Every mesh program of the port must satisfy the property the reference
checks for its ``shard_map`` programs: **all entries execute the identical
ordered sequence of collectives**.  A collective reached by only some
entries (a shard that took the other branch), or one whose count depends
on the data (the reference's data-dependent ``while`` trip count), hangs
a real mesh — and only at scale, never under a one-process mesh.

The reference traces a jaxpr; the port has none.  Its collectives are the
functions of :mod:`repro_torch.launch.mesh` (``all_gather``,
``ppermute``, ``psum``, ``all_to_all`` and the FSDP ``gather_blocks``,
recorded as an ``all_gather``), and each calls the hook that
:func:`~repro_torch.launch.mesh.recording` arms first.  So:

* :func:`collective_schedule` runs ``fn(*args)`` on a port ``Mesh`` with
  that hook armed and records the ordered :class:`CollectiveOp` list.  The
  reference's violation kinds take the port's meaning:
  ``divergent-cond`` is a collective whose rows lack an entry of the axis
  or disagree in shape or dtype (the run stops there, as the mesh would);
  ``while-collective`` is a schedule that differs between ``args`` and
  ``alt_args``, two inputs of the same shapes with uneven data.
* :func:`check_repo` runs the registered round functions of
  ``scale/shard.py``, ``core/packed_reduce.py`` and
  ``dist/compression.py`` on a 4-entry data mesh
  (``make_data_mesh(4, devices=[device] * 4)``; ``device`` defaults to
  the card and raises without one, as every entry point of the port does,
  so a CPU run passes ``device="cpu"``),
  verifies their axes (``unknown-axis``), pins each schedule against the
  registry (``schedule-mismatch``; ``trace-error`` where a program fails)
  and exercises the pivot-exchange wire's replica consistency
  (``wire-shape``, ``wire-roundtrip``) on uneven per-shard payloads.

The registry holds ``dist.compression.compressed_psum_grads`` too, the
int8 gradient exchange of the sharded trainer, pinned to the reference's
two ``all_gather``s a leaf.  :func:`collective_schedule_from_hlo` is the
reference's post-XLA cross-check over compiled HLO text, through the
port's copy of the ``launch/hlo.py`` parser.

The modules under test are imported inside functions, so importing this
module stays cheap.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

__all__ = [
    "CollectiveOp",
    "Violation",
    "Schedule",
    "collective_schedule",
    "collective_schedule_from_hlo",
    "schedule_signature",
    "verify_axes",
    "Program",
    "repo_programs",
    "check_exchange_consistency",
    "check_repo",
]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in program order: its name, axes, the shapes of its
    rows (one an entry) and the number of rows."""

    name: str
    axes: Tuple[str, ...] = ()
    shapes: Tuple[Tuple[int, ...], ...] = ()
    group_size: int = 0

    def __str__(self) -> str:
        axes = ",".join(self.axes) if self.axes else "?"
        return f"{self.name}[{axes}]"


@dataclasses.dataclass(frozen=True)
class Violation:
    """A shard-uniformity / axis problem found by running a program."""

    kind: str  # divergent-cond | while-collective | unknown-axis | ...
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.where}: {self.detail}"


@dataclasses.dataclass
class Schedule:
    """Ordered collective schedule of one program run."""

    where: str
    ops: List[CollectiveOp]
    violations: List[Violation]

    def signature(self) -> Tuple[Tuple[str, Tuple[str, ...]], ...]:
        return schedule_signature(self.ops)


def schedule_signature(
        ops: Sequence[CollectiveOp]) -> Tuple[Tuple[str, Tuple[str, ...]], ...]:
    """The order-sensitive (primitive, axes) fingerprint of a schedule."""
    return tuple((op.name, op.axes) for op in ops)


class _Halt(BaseException):
    """Raised by the recorder where a real mesh would hang: the run stops
    at that collective.  A ``BaseException``, so that a program's own
    ``except Exception`` cannot swallow it and record past the fault."""


def _record(fn: Callable[..., Any], args: Sequence[Any], where: str
            ) -> Tuple[List[CollectiveOp], List[Violation]]:
    """Run ``fn(*args)`` with the mesh's collective hook armed."""
    from ..launch import mesh as mesh_mod

    ops: List[CollectiveOp] = []
    violations: List[Violation] = []

    def hook(name: str, mesh: Any, axis: str, rows: list) -> None:
        shapes = tuple(() if r is None else tuple(int(d) for d in r.shape)
                       for r in rows)
        op = CollectiveOp(name, (str(axis),), shapes, len(rows))
        ops.append(op)
        if axis not in mesh.shape:
            raise _Halt     # verify_axes names the axis
        size = mesh.shape[axis]
        kinds = {(tuple(r.shape), r.dtype) for r in rows if r is not None}
        if len(rows) != size or any(r is None for r in rows):
            have = sum(r is not None for r in rows)
            detail = (f"{op} has rows from {have} of the {size} entries of "
                      f"{axis!r}; an entry that took the other branch "
                      "never arrives and the mesh deadlocks")
        elif len(kinds) > 1:
            detail = (f"{op} rows disagree in shape or dtype "
                      f"({sorted(str(k) for k in kinds)}); the entries "
                      "took different branches and the mesh deadlocks")
        else:
            return
        violations.append(Violation("divergent-cond", where, detail))
        raise _Halt

    try:
        with mesh_mod.recording(hook):
            fn(*args)
    except _Halt:
        pass
    return ops, violations


def collective_schedule(fn: Callable[..., Any], args: Sequence[Any],
                        mesh: Any, where: Optional[str] = None,
                        alt_args: Optional[Sequence[Any]] = None
                        ) -> Schedule:
    """Run ``fn(*args)`` on ``mesh`` (a port ``Mesh``, which ``fn`` closes
    over) and extract its schedule.

    With ``alt_args`` (inputs of the same shapes as ``args``, uneven data)
    ``fn`` runs again, and a schedule that differs is a
    ``while-collective``: its collective count or order depends on the
    data, as a ``while_loop``'s trip count does in the reference.
    """
    from ..launch.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__module__}.{type(mesh).__qualname__}")
    label = where or getattr(fn, "__name__", repr(fn))
    ops, violations = _record(fn, args, label)
    if alt_args is not None:
        alt_ops, alt_violations = _record(fn, alt_args, label)
        violations.extend(alt_violations)
        if schedule_signature(alt_ops) != schedule_signature(ops):
            pretty = ["(" + ", ".join(map(str, run)) + ")"
                      for run in (ops, alt_ops)]
            violations.append(Violation(
                "while-collective", label,
                f"the collective schedule depends on the data: "
                f"{' vs '.join(pretty)}; entries whose data give another "
                "count deadlock — hoist the collective or fix its count"))
    return Schedule(label, ops, violations)


def verify_axes(schedule: Schedule,
                mesh_axes: Sequence[str]) -> List[Violation]:
    """Every collective axis must exist on the mesh it runs under."""
    known = set(mesh_axes)
    violations: List[Violation] = []
    for op in schedule.ops:
        missing = [a for a in op.axes if a not in known]
        if missing:
            violations.append(Violation(
                "unknown-axis", schedule.where,
                f"{op} names axis(es) {missing} absent from the mesh axes "
                f"{sorted(known)}"))
    return violations


def collective_schedule_from_hlo(hlo_text: str, where: str = "<hlo>",
                                 pod_size: int = 256) -> Schedule:
    """Extract the collective schedule from compiled HLO text (the
    reference's, over ``repro_torch.launch.hlo``'s parser).

    Walks the entry computation in program order, inlining called and
    fusion-called computations and while bodies.  A collective reached
    through a while loop whose trip count the parser cannot prove is
    flagged ``while-collective``: the same deadlock class as
    :func:`collective_schedule`'s, after XLA had its say."""
    import re

    from ..launch.hlo import (COLLECTIVES, _group_info, _parse_computation,
                              _split_computations)

    raw = _split_computations(hlo_text)
    parsed = {name: _parse_computation(name, lines, pod_size)
              for name, lines in raw.items()}
    entry: Optional[str] = None
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            match = re.search(r"ENTRY\s+%?([\w.\-]+)", line)
            if match:
                entry = match.group(1)
            break
    if entry is None and parsed:
        entry = next(iter(parsed))

    ops: List[CollectiveOp] = []
    violations: List[Violation] = []

    def visit(name: str, in_unproven_while: bool,
              stack: Tuple[str, ...]) -> None:
        comp = parsed.get(name)
        if comp is None or name in stack:
            return
        stack = stack + (name,)
        for op in comp.ops:
            base = op.opcode[:-len("-start")] \
                if op.opcode.endswith("-start") else op.opcode
            if base in COLLECTIVES:
                group_size, _ = _group_info(op.line, pod_size)
                ops.append(CollectiveOp(base, (), (), group_size))
                if in_unproven_while:
                    violations.append(Violation(
                        "while-collective", where,
                        f"HLO {base} executes under a while loop with an "
                        "unproven trip count; shards that disagree on the "
                        "trip count deadlock"))
        for callee in comp.calls:
            visit(callee, in_unproven_while, stack)
        for callee in comp.fusion_calls:
            visit(callee, in_unproven_while, stack)
        for cond, body, trip in comp.whiles:
            risky = in_unproven_while or trip <= 0
            visit(cond, risky, stack)
            visit(body, risky, stack)

    if entry is not None:
        visit(entry, False, ())
    return Schedule(where, ops, violations)


# ---------------------------------------------------------------------------
# The repo registry: every mesh round function the port ships, with its
# pinned schedule (the reference's, program for program).  A mismatch is a
# violation — update the registry only together with the code change
# that alters the schedule.
# ---------------------------------------------------------------------------

REGISTRY_ENTRIES = 4
_POINTS, _TILE = 32, 8


@dataclasses.dataclass
class Program:
    """A registered mesh round function and its pinned schedule.

    ``build()`` returns ``(fn, args, alt_args, mesh)``: ``fn`` closed over
    ``mesh``, and two inputs of the same shapes with uneven data."""

    name: str
    build: Callable[[], Tuple[Callable[..., Any], Tuple[Any, ...],
                              Tuple[Any, ...], Any]]
    mesh_axes: Tuple[str, ...]
    expect: Tuple[Tuple[str, Tuple[str, ...]], ...]


def _first_round(n: int, tile: int, entries: int):
    """The first harvest round of an ``n``-point grid of ``tile`` x
    ``tile`` tiles over ``entries`` shards: one live tile an entry."""
    from ..scale.shard import _live_tiles, partition_tiles

    return _live_tiles(partition_tiles(n, tile, tile, entries), 0, n,
                       tile, tile)


def repo_programs(device: Any = None) -> List[Program]:
    """Build closures for every mesh round function in the port, over
    ``make_data_mesh(4, devices=[device] * 4)``.  ``device=None`` is the
    card, and raises ``RuntimeError`` without one; a CPU run passes
    ``device="cpu"``."""
    import functools

    import numpy as np

    from ..device import resolve_device

    dev = resolve_device(device)

    def data_mesh():
        from ..launch.mesh import make_data_mesh

        return make_data_mesh(REGISTRY_ENTRIES,
                              devices=[dev] * REGISTRY_ENTRIES)

    def candidate_round():
        import torch

        from ..scale.shard import _candidate_round_fn
        from ..scale.tiles import _f32_threshold

        mesh = data_mesh()
        live = _first_round(_POINTS, _TILE, REGISTRY_ENTRIES)
        rng = np.random.default_rng(0)

        def inputs(points):
            sq = np.sum(points * points, axis=1)
            xs = [torch.as_tensor(points, dtype=torch.float32, device=d)
                  for d in mesh.axis_devices("data")]
            return xs, live, _f32_threshold(points, sq, 0.5)

        spread = rng.random((_POINTS, 3))
        fn = functools.partial(_candidate_round_fn, mesh, "data")
        # uneven: every pair of the collapsed cloud is a candidate
        return (fn, inputs(spread), inputs(np.zeros_like(spread)), mesh)

    def dists_round():
        from ..scale.shard import _dists_round_fn
        from ..scale.tiles import _f32_dists_threshold

        mesh = data_mesh()
        live = _first_round(_POINTS, _TILE, REGISTRY_ENTRIES)
        rng = np.random.default_rng(1)
        d = rng.random((_POINTS, _POINTS))
        dists = np.minimum(d, d.T)
        thr32 = float(_f32_dists_threshold(0.5))
        fn = functools.partial(_dists_round_fn, mesh, "data")
        return (fn, (dists, live, thr32),
                (np.zeros_like(dists), live, thr32), mesh)

    def exchange_round():
        from ..core.packed_reduce import _exchange_round_fn
        from ..kernels.gf2 import stack_wire_payloads

        mesh = data_mesh()
        fn = functools.partial(_exchange_round_fn, mesh, "data")
        # uneven: the shards' loads of check_exchange_consistency, padded
        # to the same power-of-two width
        buf, _ = stack_wire_payloads(
            [np.arange(s, dtype=np.uint32) % 97 for s in (0, 1, 7, 1000)])
        return (fn, (np.zeros_like(buf),), (buf,), mesh)

    def psum_grads():
        import torch

        from ..dist.compression import compressed_psum_grads

        mesh = data_mesh()

        def fn(grads, errs):
            return compressed_psum_grads(grads, errs, "data", mesh)

        def trees(scale):
            rng = np.random.default_rng(2)
            return [{"w": torch.as_tensor(
                rng.normal(size=(4, 4)) * scale ** k, dtype=torch.float32,
                device=dev)} for k in range(REGISTRY_ENTRIES)]

        zeros = [{"w": torch.zeros((4, 4), device=dev)}
                 for _ in range(REGISTRY_ENTRIES)]
        # uneven: one entry's gradient zero, the others' scales 1e-3 apart
        return (fn, (trees(1.0), zeros), (trees(1e-3), trees(0.0)), mesh)

    return [
        Program("scale.shard._candidate_round_fn", candidate_round,
                ("data",), expect=()),
        Program("scale.shard._dists_round_fn", dists_round,
                ("data",), expect=()),
        Program("core.packed_reduce._exchange_round_fn", exchange_round,
                ("data",), expect=(("all_gather", ("data",)),)),
        Program("dist.compression.compressed_psum_grads", psum_grads,
                ("data",),
                expect=(("all_gather", ("data",)),
                        ("all_gather", ("data",)))),
    ]


def check_exchange_consistency() -> List[Violation]:
    """Replica-consistency of the pivot-exchange wire, on the host.

    Every shard enters the ``all_gather`` with the *same* padded payload
    length, whatever its local commit count — that is the job of
    ``stack_wire_payloads``.  And a replica applies exactly the records
    the owner committed — that is the job of the Elias–Fano delta codec.
    Both are pure host code, so we can verify them here on deliberately
    uneven per-shard loads without any devices.
    """
    import numpy as np

    from ..core.pivot_cache import decode_commit_delta, encode_commit_delta
    from ..kernels.gf2 import stack_wire_payloads, unstack_wire_payloads

    violations: List[Violation] = []
    where = "pivot-exchange wire"

    for sizes in [(0, 0, 0, 0), (0, 1, 7, 1000), (5, 5, 5, 5),
                  (1023, 1025, 1, 64)]:
        payloads = [np.arange(s, dtype=np.uint32) % 97 for s in sizes]
        stacked, lengths = stack_wire_payloads(payloads)
        if stacked.ndim != 2 or stacked.shape[0] != len(sizes):
            violations.append(Violation(
                "wire-shape", where,
                f"stack_wire_payloads({sizes}) produced shape "
                f"{stacked.shape}; shards would all_gather unequal blocks"))
            continue
        width = int(stacked.shape[1])
        if width < max(sizes) or (width & (width - 1)) != 0:
            violations.append(Violation(
                "wire-shape", where,
                f"padded wire width {width} for shard loads {sizes} is not "
                "a power-of-two cover; shards would disagree on the "
                "all_gather element count"))
        back = unstack_wire_payloads(stacked, lengths)
        if not all(np.array_equal(a, b) for a, b in zip(payloads, back)):
            violations.append(Violation(
                "wire-roundtrip", where,
                f"stack/unstack round-trip corrupted a payload ({sizes})"))

    lows = np.array([3, 11, 12, 40], dtype=np.int64)
    records = [
        {"low": int(lows[0]), "col_id": 7, "mode": "explicit",
         "column": np.array([3, 5, 9], dtype=np.int64),
         "gens": np.array([1], dtype=np.int64)},
        {"low": int(lows[1]), "col_id": 8, "mode": "implicit",
         "column": None, "gens": np.array([2, 4], dtype=np.int64)},
        {"low": int(lows[2]), "col_id": 9, "mode": "explicit",
         "column": np.array([12], dtype=np.int64), "gens": None},
        {"low": int(lows[3]), "col_id": 13, "mode": "implicit",
         "column": None, "gens": None},
    ]
    for count in (0, 1, len(records)):
        subset = records[:count]
        decoded = decode_commit_delta(encode_commit_delta(subset))
        same = len(decoded) == len(subset) and all(
            int(a["low"]) == int(b["low"])
            and int(a["col_id"]) == int(b["col_id"])
            and str(a["mode"]) == str(b["mode"])
            for a, b in zip(subset, decoded))
        if not same:
            violations.append(Violation(
                "wire-roundtrip", where,
                f"Elias–Fano commit-delta codec failed the {count}-record "
                "round-trip; replicas would apply a different pivot set "
                "than the owner committed"))
    return violations


def check_repo(device: Any = None) -> Tuple[List[Schedule], List[Violation]]:
    """Run every registered program on a 4-entry mesh of ``device`` (the
    card when ``None``, raising ``RuntimeError`` without one; ``"cpu"`` for
    a host run), with its uneven second input; collect all violations."""
    schedules: List[Schedule] = []
    violations: List[Violation] = []
    for program in repo_programs(device):
        try:
            fn, args, alt_args, mesh = program.build()
            schedule = collective_schedule(fn, args, mesh, program.name,
                                           alt_args=alt_args)
        except Exception as exc:  # noqa: BLE001 - reported, not raised
            violations.append(Violation(
                "trace-error", program.name,
                f"failed to run the registered program: {exc!r}"))
            continue
        schedules.append(schedule)
        violations.extend(schedule.violations)
        violations.extend(verify_axes(schedule, program.mesh_axes))
        signature = schedule.signature()
        if signature != program.expect:
            violations.append(Violation(
                "schedule-mismatch", program.name,
                f"recorded collective schedule {signature} != registered "
                f"{program.expect}; update the registry only together with "
                "the code change that re-orders the schedule"))
    violations.extend(check_exchange_consistency())
    return schedules, violations
