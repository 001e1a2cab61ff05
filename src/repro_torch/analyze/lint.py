"""AST lint pass with repo-specific rules derived from shipped bugs.

Port of ``src/repro/analyze/lint.py``: the reference's nine rules under
their names and messages, its pragmas, ``bare-allow`` and the same
default tree (``src``, ``benchmarks``, ``examples``, ``tools``), so on the
reference's own sources it gives the reference's findings field for
field.  Where a rule could not see the port's idiom it also reads it:
``host-sync`` covers the ``repro_torch/`` counterparts of the four hot
modules and torch's syncs, ``unseeded-rng`` torch's global draws, and
``raw-timing``/``span-leak`` exempt ``repro_torch/obs/`` as they exempt
``repro/obs/``.  ``pallas-ref-mutation`` stays as it is: the port has no
Pallas body, and its CUDA sources (``kernels/csrc/*.cu``) are out of an
AST lint's reach.

Every rule here encodes a bug class this repo has actually hit (or is one
code review away from hitting):

* ``pallas-ref-mutation`` — a Pallas kernel may mutate a ``Ref`` only via
  top-level ``ref[...] = value`` stores.  Stores issued from inside a
  nested ``def``/``lambda`` (a ``fori_loop``/``scan``/``cond`` body) are
  traced into a *different* scope and are silently dropped when the
  kernel is discharged in interpret mode — the discharge bug class.
* ``host-sync`` — ``.item()``, ``np.asarray(device_fn(...))``,
  ``jax.device_get`` and ``block_until_ready`` inside a superstep or
  harvest hot loop serialize the pipeline on a device round-trip per
  iteration; so do torch's ``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``torch.cuda.synchronize()`` and an event's or stream's
  ``.synchronize()``.  Applies to the known hot modules and to any file
  carrying an ``# analyze: hot`` marker.
* ``raw-filtration-sort`` — sorting filtration values (edge lengths,
  diameters, distances) with a bare ``sort``/``argsort``/short
  ``lexsort`` loses the canonical ``(length, i, j)`` tie-break that
  makes diagrams reproducible across engines and tile schedules; use
  ``filtration_from_edges`` / ``merge_edge_chunks``.
* ``f32-exact-compare`` — f32 candidate quantities must never be
  compared against the exact (f64) threshold; compare against the
  margin-widened f32 threshold (``_f32_threshold``) and re-measure
  survivors in f64.
* ``unseeded-rng`` — benchmarks and examples must use
  ``np.random.default_rng(seed)`` (or a seeded ``torch.Generator``);
  legacy global or unseeded RNG makes perf and diagram numbers
  irreproducible.
* ``raw-timing`` — ad-hoc ``time.time()`` / ``time.perf_counter()``
  pairs outside ``repro/obs/``, ``repro_torch/obs/`` and ``benchmarks/``
  bypass the tracer:
  the measurement never lands in the span timeline or the BENCH JSON
  phase breakdown.  Use :func:`repro_torch.obs.trace.stopwatch` (always
  yields ``.elapsed``, records a span when tracing is active).
* ``span-leak`` — ``span(...)`` / ``stopwatch(...)`` must be used as a
  ``with`` context item (or via the ``traced()`` decorator).  A bare
  call creates a context manager that is never entered/exited, so the
  span silently never closes — especially on exception paths.
* ``bare-except`` — recovery paths must catch *typed* faults
  (``TransientFault``, ``WireCorruption``, ``CheckpointCorruption``, …).
  A bare ``except:`` swallows ``KeyboardInterrupt``/``SystemExit`` and —
  worse for this repo — silently absorbs injected faults the resilience
  suite relies on propagating, turning a CI-gated exactness failure into
  a wrong-answer run.
* ``retry-without-backoff`` — a retry loop that sleeps a *constant*
  between attempts hammers a struggling peer in lockstep and replays
  differently under load; use
  :func:`repro_torch.resilience.faults.retry_with_backoff`, whose jittered
  exponential schedule is deterministic given its seed.  Sleeps of a
  computed (non-constant) duration are assumed to be such a schedule.

Deliberate exceptions are suppressed in place with a *justified* pragma
on the offending line (or the line above)::

    d2 = np.asarray(fn(x))  # analyze: allow[host-sync] one sync per round is the schedule

A pragma without a justification is itself a finding (``bare-allow``):
the pragma is the audit trail, not an off switch.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "Rule",
    "RefMutationRule",
    "HostSyncRule",
    "RawFiltrationSortRule",
    "DtypeBoundaryRule",
    "UnseededRngRule",
    "RawTimingRule",
    "SpanLeakRule",
    "BareExceptRule",
    "RetryWithoutBackoffRule",
    "default_rules",
    "lint_source",
    "lint_file",
    "lint_paths",
]


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    allowed: bool = False
    justification: str = ""

    def format(self) -> str:
        text = f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"
        if self.allowed:
            text += f"  (allowed: {self.justification})"
        return text


class Rule:
    """Base class: one repo-specific lint rule."""

    name = "rule"

    def applies(self, relpath: str, source: str) -> bool:
        return True

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------
    @staticmethod
    def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
        """``np.random.default_rng`` -> ("np", "random", "default_rng")."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return tuple(reversed(parts))
        return ()

    def _finding(self, relpath: str, node: ast.AST, message: str) -> Finding:
        return Finding(relpath, getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), self.name, message)


class RefMutationRule(Rule):
    """Pallas ``Ref`` stores are only legal at kernel top level.

    A function is treated as a kernel when it has parameters named
    ``*_ref`` / ``*_refs`` (the repo-wide Pallas naming convention).
    Inside it, any ``ref[...] = ...`` (or ``ref[...] ^= ...``) issued
    from a nested ``def`` or ``lambda`` — i.e. a ``fori_loop`` / ``scan``
    / ``cond`` body that Pallas traces as a separate scope — is flagged:
    interpret-mode discharge drops those stores silently.
    """

    name = "pallas-ref-mutation"

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            args = fn.args
            params = [a.arg for a in (args.posonlyargs + args.args
                                      + args.kwonlyargs)]
            refs = {p for p in params
                    if p.endswith("_ref") or p.endswith("_refs")}
            if not refs:
                continue
            findings.extend(self._check_kernel(fn, refs, relpath))
        return findings

    def _check_kernel(self, kernel: ast.AST, refs: Set[str],
                      relpath: str) -> List[Finding]:
        findings: List[Finding] = []

        def is_ref_store(target: ast.AST) -> bool:
            return (isinstance(target, ast.Subscript)
                    and isinstance(target.value, ast.Name)
                    and target.value.id in refs)

        def visit(node: ast.AST, nested: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_nested = nested or isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
                if nested and isinstance(child, ast.Assign) and any(
                        is_ref_store(t) for t in child.targets):
                    findings.append(self._finding(
                        relpath, child,
                        "Ref store inside a nested trace scope (fori_loop/"
                        "scan/cond body); interpret-mode discharge drops it "
                        "— hoist the store to kernel top level or carry the "
                        "value through the loop carry"))
                elif nested and isinstance(child, ast.AugAssign) and \
                        is_ref_store(child.target):
                    findings.append(self._finding(
                        relpath, child,
                        "in-place Ref update inside a nested trace scope; "
                        "interpret-mode discharge drops it"))
                visit(child, child_nested)

        visit(kernel, nested=False)
        return findings


class HostSyncRule(Rule):
    """No host↔device synchronization inside hot loops.

    Applies only to the superstep/harvest hot modules (and to any source
    carrying an ``# analyze: hot`` marker).  Inside any ``for``/``while``
    body there, flags ``.item()``, ``.block_until_ready()``,
    ``jax.device_get(...)``, and ``np.asarray``/``np.array`` wrapped
    around a call to a known device function (anything imported from a
    ``kernels`` module or assigned from ``jax.jit`` / ``jax.shard_map`` /
    ``pl.pallas_call``); and the port's syncs: ``.cpu()``, ``.numpy()``
    and ``.tolist()`` (a tensor copied to the host waits for its stream),
    ``torch.cuda.synchronize(...)`` and an event's or stream's
    ``.synchronize()``.  An AST cannot tell a tensor from an array, so a
    numpy array's ``.tolist()`` in a hot loop is flagged too.
    """

    name = "host-sync"
    HOT_SUFFIXES = (
        "repro/core/packed_reduce.py",
        "repro/core/serial_parallel.py",
        "repro/scale/shard.py",
        "repro/scale/tiles.py",
        "repro_torch/core/packed_reduce.py",
        "repro_torch/core/serial_parallel.py",
        "repro_torch/scale/shard.py",
        "repro_torch/scale/tiles.py",
    )
    _HOST_COPIES = ("cpu", "numpy", "tolist")
    HOT_MARKER = "# analyze: hot"

    def applies(self, relpath: str, source: str) -> bool:
        posix = relpath.replace(os.sep, "/")
        return (posix.endswith(self.HOT_SUFFIXES)
                or self.HOT_MARKER in source)

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        device_names = self._device_names(tree)
        findings: List[Finding] = []
        seen: Set[Tuple[int, int, str]] = set()

        def emit(node: ast.AST, message: str) -> None:
            key = (getattr(node, "lineno", 0),
                   getattr(node, "col_offset", 0), message)
            if key not in seen:
                seen.add(key)
                findings.append(self._finding(relpath, node, message))

        for loop in ast.walk(tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for node in ast.walk(loop):
                if node is loop or not isinstance(node, ast.Call):
                    continue
                self._check_call(node, device_names, emit)
        return findings

    def _check_call(self, call: ast.Call, device_names: Set[str],
                    emit) -> None:
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr == "item" and not call.args:
                emit(call, ".item() synchronizes the device stream once per "
                           "loop iteration; batch the transfer outside the "
                           "loop")
                return
            if func.attr == "block_until_ready":
                emit(call, "block_until_ready() inside a hot loop serializes "
                           "dispatch; sync once after the loop")
                return
            if func.attr in self._HOST_COPIES:
                # one message for the three, so x.cpu().numpy() is one
                # finding (both calls start at the same column)
                emit(call, "host copy of a tensor (.cpu()/.numpy()/"
                           ".tolist()) waits for the device stream once per "
                           "loop iteration; gather once outside the loop")
                return
            if func.attr == "synchronize":
                emit(call, "synchronize() inside a hot loop waits for the "
                           "device once per iteration; sync once after the "
                           "loop")
                return
        chain = self._attr_chain(func)
        if chain == ("jax", "device_get"):
            emit(call, "jax.device_get inside a hot loop forces a device "
                       "round-trip per iteration")
            return
        if (len(chain) == 2 and chain[0] in ("np", "numpy")
                and chain[1] in ("asarray", "array") and call.args
                and self._calls_device_fn(call.args[0], device_names)):
            emit(call, "host gather of a device computation "
                       "(np.asarray(device_fn(...))) inside a hot loop; one "
                       "blocking transfer per iteration")

    @staticmethod
    def _calls_device_fn(node: ast.AST, device_names: Set[str]) -> bool:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Name) and func.id in device_names:
                return True
            if isinstance(func, ast.Subscript) and \
                    isinstance(func.value, ast.Name) and \
                    func.value.id in device_names:
                return True
        return False

    def _device_names(self, tree: ast.Module) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    "kernels" in node.module.split("."):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    self._is_device_ctor(node.value):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        names.add(target.id)
                    elif isinstance(target, ast.Subscript) and \
                            isinstance(target.value, ast.Name):
                        names.add(target.value.id)
        return names

    def _is_device_ctor(self, call: ast.Call) -> bool:
        chain = self._attr_chain(call.func)
        if chain and chain[-1] in ("jit", "shard_map", "pallas_call", "pmap"):
            return True
        # jax.jit(jax.shard_map(...)) — look one call deeper.
        return any(isinstance(a, ast.Call) and self._is_device_ctor(a)
                   for a in call.args)


class RawFiltrationSortRule(Rule):
    """Filtration values must be ordered with the canonical tie-break.

    Flags ``sort``/``argsort``/``sorted`` whose primary key *names* a
    filtration quantity (``lens``, ``length``, ``dist``, ``diam``, …) and
    ``np.lexsort`` calls whose primary key is such a quantity but which
    carry fewer than the three canonical ``(length, i, j)`` keys.
    """

    name = "raw-filtration-sort"
    _VALUE = re.compile(
        r"(^|_)(len|lens|length|lengths|dist|dists|distance|distances|"
        r"diam|diams|diameter|diameters|edge_len|filt|filtration)(_|$|\d*$)")

    def _names_value(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            name = None
            if isinstance(sub, ast.Name):
                name = sub.id
            elif isinstance(sub, ast.Attribute):
                name = sub.attr
            if name is not None and self._VALUE.search(name):
                return True
        return False

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = self._attr_chain(node.func)
            is_sort = (chain[-1:] and chain[-1] in ("sort", "argsort")) or \
                      chain == ("sorted",)
            if is_sort and node.args and self._names_value(node.args[0]):
                findings.append(self._finding(
                    relpath, node,
                    "raw sort on filtration values; ties must break by the "
                    "canonical (length, i, j) lexsort "
                    "(filtration_from_edges / merge_edge_chunks)"))
                continue
            if is_sort and not node.args and len(chain) >= 2 and \
                    self._VALUE.search(chain[-2]):
                findings.append(self._finding(
                    relpath, node,
                    "in-place sort of filtration values; use the canonical "
                    "(length, i, j) lexsort"))
                continue
            if chain[-1:] == ("lexsort",) and node.args and \
                    isinstance(node.args[0], (ast.Tuple, ast.List)):
                keys = node.args[0].elts
                if keys and self._names_value(keys[-1]) and len(keys) < 3:
                    findings.append(self._finding(
                        relpath, node,
                        "lexsort on filtration values without the full "
                        "(length, i, j) tie-break; diagrams become "
                        "schedule-dependent on ties"))
        return findings


class DtypeBoundaryRule(Rule):
    """f32 candidates are never compared against the exact threshold.

    The tiled harvest measures candidates in f32 and must compare them
    against the margin-widened f32 threshold (``_f32_threshold``), never
    against ``tau_max``/``tau`` directly — f32 rounding near the
    threshold would otherwise drop edges the f64 refine pass expects.
    Names are the contract: anything assigned through ``float32`` /
    ``.astype(np.float32)`` (or a ``*32``/``*_f32`` parameter) is
    f32-tainted; ``tau``-named values are the exact threshold.
    """

    name = "f32-exact-compare"
    _TAU = re.compile(r"(^|_)tau(_|$)")

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            tainted = self._tainted_names(fn)
            if not tainted:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Compare):
                    continue
                sides = [node.left] + list(node.comparators)
                has_f32 = any(self._uses(s, tainted) for s in sides)
                has_tau = any(self._names_tau(s) for s in sides)
                if has_f32 and has_tau:
                    findings.append(self._finding(
                        relpath, node,
                        "f32 candidate compared against the exact threshold; "
                        "compare against the margin-widened f32 threshold "
                        "(_f32_threshold) and re-measure survivors in f64"))
        return findings

    def _tainted_names(self, fn: ast.AST) -> Set[str]:
        args = fn.args
        tainted = {a.arg for a in (args.posonlyargs + args.args
                                   + args.kwonlyargs)
                   if a.arg.endswith("32") or a.arg.endswith("_f32")}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                f32 = self._is_f32_expr(node.value)
                for target in node.targets:
                    if isinstance(target, ast.Name) and (
                            f32 or target.id.endswith("32")
                            or target.id.endswith("_f32")):
                        tainted.add(target.id)
        return tainted

    def _is_f32_expr(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr == "float32":
                return True
            if isinstance(sub, ast.Constant) and sub.value == "float32":
                return True
        return False

    @staticmethod
    def _uses(node: ast.AST, names: Set[str]) -> bool:
        return any(isinstance(sub, ast.Name) and sub.id in names
                   for sub in ast.walk(node))

    def _names_tau(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            name = sub.id if isinstance(sub, ast.Name) else (
                sub.attr if isinstance(sub, ast.Attribute) else None)
            if name is not None and self._TAU.search(name):
                return True
        return False


class UnseededRngRule(Rule):
    """Benchmarks and examples must seed their RNG explicitly.

    Besides numpy's and the stdlib's global draws, torch's: a
    ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
    ``bernoulli``/``multinomial`` without ``generator=`` draws from the
    process-wide generator, and ``torch.manual_seed``/``torch.seed`` set
    it; pass a ``torch.Generator().manual_seed(seed)`` instead.
    """

    name = "unseeded-rng"
    _LEGACY = ("rand", "randn", "randint", "random", "choice", "shuffle",
               "permutation", "uniform", "normal", "standard_normal", "seed")
    _STDLIB = ("random", "randint", "randrange", "choice", "shuffle",
               "uniform", "gauss", "sample")
    _TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "normal",
                    "bernoulli", "multinomial")
    _TORCH_SEEDS = ("manual_seed", "seed")

    def applies(self, relpath: str, source: str) -> bool:
        posix = relpath.replace(os.sep, "/")
        return posix.startswith(("benchmarks/", "examples/")) or \
            "/benchmarks/" in posix or "/examples/" in posix

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = self._attr_chain(node.func)
            if len(chain) == 3 and chain[0] in ("np", "numpy") and \
                    chain[1] == "random" and chain[2] in self._LEGACY:
                findings.append(self._finding(
                    relpath, node,
                    f"legacy global RNG np.random.{chain[2]} is unseeded "
                    "across runs; use np.random.default_rng(seed)"))
            elif chain[-1:] == ("default_rng",) and (
                    not node.args or (isinstance(node.args[0], ast.Constant)
                                      and node.args[0].value is None)):
                findings.append(self._finding(
                    relpath, node,
                    "np.random.default_rng() without a seed; benchmark "
                    "numbers become irreproducible"))
            elif len(chain) == 2 and chain[0] == "random" and \
                    chain[1] in self._STDLIB:
                findings.append(self._finding(
                    relpath, node,
                    f"stdlib random.{chain[1]} uses unseeded global state; "
                    "use np.random.default_rng(seed)"))
            elif len(chain) == 2 and chain[0] == "torch" and \
                    chain[1] in self._TORCH_DRAWS and \
                    not any(k.arg == "generator" for k in node.keywords):
                findings.append(self._finding(
                    relpath, node,
                    f"torch.{chain[1]} without generator= draws from "
                    "torch's global generator; pass "
                    "generator=torch.Generator().manual_seed(seed)"))
            elif len(chain) == 2 and chain[0] == "torch" and \
                    chain[1] in self._TORCH_SEEDS:
                findings.append(self._finding(
                    relpath, node,
                    f"torch.{chain[1]} sets torch's process-wide generator; "
                    "seed a torch.Generator and pass it as generator="))
        return findings


def _in_obs(posix: str) -> bool:
    """Under the tracer's own package, which owns the blessed clock and
    hands spans back to its callers: the reference's or the port's."""
    return "repro/obs/" in posix or "repro_torch/obs/" in posix


class RawTimingRule(Rule):
    """Timing must flow through the tracer, not ad-hoc clock reads.

    Flags ``time.time()``, ``time.perf_counter()``,
    ``time.perf_counter_ns()`` and ``time.process_time()`` — via the
    module attribute or imported bare (``from time import
    perf_counter``) — everywhere except ``repro/obs/`` and
    ``repro_torch/obs/`` (which own the
    one blessed clock) and ``benchmarks/`` (whose wall-clock gates are
    the measurement itself, not a phase to attribute).
    ``time.monotonic`` (deadline arithmetic) and ``time.sleep`` are
    deliberately not timing measurements and stay legal.
    """

    name = "raw-timing"
    _CLOCKS = ("time", "perf_counter", "perf_counter_ns", "process_time")

    def applies(self, relpath: str, source: str) -> bool:
        posix = relpath.replace(os.sep, "/")
        if posix.startswith("benchmarks/") or "/benchmarks/" in posix:
            return False
        return not _in_obs(posix)

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        imported = self._imported_clocks(tree)
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            clock = self._clock_name(node.func, imported)
            if clock is not None:
                findings.append(self._finding(
                    relpath, node,
                    f"raw clock read time.{clock}() bypasses the tracer; "
                    "use repro.obs.trace.stopwatch(name) so the interval "
                    "lands in the span timeline"))
        return findings

    def _clock_name(self, func: ast.AST,
                    imported: Set[str]) -> Optional[str]:
        chain = self._attr_chain(func)
        if len(chain) == 2 and chain[0] == "time" and \
                chain[1] in self._CLOCKS:
            return chain[1]
        if isinstance(func, ast.Name) and func.id in imported:
            return func.id
        return None

    def _imported_clocks(self, tree: ast.Module) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                names.update(a.asname or a.name for a in node.names
                             if a.name in self._CLOCKS)
        return names


class SpanLeakRule(Rule):
    """Every opened span must close — even on the exception path.

    A ``span(...)`` / ``stopwatch(...)`` call (bare or as a
    ``Tracer``-method ``tl.span(...)``) that is not a ``with`` context
    item produces a context manager that is never entered: the span
    never records, or — worse — an explicit ``__enter__`` without the
    guarded ``__exit__`` leaks an open span when the body raises.  The
    ``with`` statement is the only form whose exit runs on exceptions.
    """

    name = "span-leak"
    _OPENERS = ("span", "stopwatch")

    def applies(self, relpath: str, source: str) -> bool:
        return not _in_obs(relpath.replace(os.sep, "/"))

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        with_items: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                with_items.update(id(item.context_expr)
                                  for item in node.items)
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or id(node) in with_items:
                continue
            chain = self._attr_chain(node.func)
            if chain[-1:] and chain[-1] in self._OPENERS:
                findings.append(self._finding(
                    relpath, node,
                    f"{chain[-1]}(...) not used as a `with` item; the span "
                    "never closes on the exception path — write "
                    f"`with {chain[-1]}(...):` (or use the traced() "
                    "decorator)"))
        return findings


class BareExceptRule(Rule):
    """Exception handlers must name what they recover from.

    A bare ``except:`` catches ``KeyboardInterrupt``/``SystemExit`` and
    every injected fault the resilience suite expects to propagate —
    recovery code that swallows :class:`~repro_torch.resilience.faults
    .CheckpointCorruption` or a :class:`~repro_torch.resilience.faults
    .TransientFault` whose retry budget is spent converts a loud,
    CI-gated failure into silently wrong state.  Catch the typed fault
    (or at widest ``Exception``) instead.
    """

    name = "bare-except"

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                findings.append(self._finding(
                    relpath, node,
                    "bare `except:` swallows KeyboardInterrupt and injected "
                    "faults; catch the typed fault the recovery path "
                    "actually handles (TransientFault, WireCorruption, "
                    "CheckpointCorruption, ... or at widest Exception)"))
        return findings


class RetryWithoutBackoffRule(Rule):
    """Retry loops must back off, not hammer at a fixed cadence.

    Flags a ``time.sleep`` (or bare ``sleep`` imported from ``time``)
    with a *constant* duration inside a ``for``/``while`` loop that also
    contains a ``try``/``except`` — the signature of a hand-rolled retry
    loop.  Fixed-interval retries pile onto a struggling peer in
    lockstep and make the failure history irreproducible; use
    ``repro_torch.resilience.faults.retry_with_backoff`` (deterministic
    jittered exponential schedule).  A sleep whose duration is computed
    is assumed to already be such a schedule.
    """

    name = "retry-without-backoff"

    def check(self, tree: ast.Module, source: str,
              relpath: str) -> List[Finding]:
        imported = self._imported_sleep(tree)
        findings: List[Finding] = []
        for loop in ast.walk(tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            if not any(isinstance(sub, ast.Try) for sub in ast.walk(loop)):
                continue
            for node in ast.walk(loop):
                if isinstance(node, ast.Call) \
                        and self._is_sleep(node.func, imported) \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant):
                    findings.append(self._finding(
                        relpath, node,
                        "constant-interval sleep in a retry loop; use "
                        "repro.resilience.faults.retry_with_backoff for a "
                        "deterministic jittered exponential schedule"))
        return findings

    def _is_sleep(self, func: ast.AST, imported: Set[str]) -> bool:
        chain = self._attr_chain(func)
        if chain == ("time", "sleep"):
            return True
        return isinstance(func, ast.Name) and func.id in imported

    @staticmethod
    def _imported_sleep(tree: ast.Module) -> Set[str]:
        names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                names.update(a.asname or a.name for a in node.names
                             if a.name == "sleep")
        return names


def default_rules() -> List[Rule]:
    return [RefMutationRule(), HostSyncRule(), RawFiltrationSortRule(),
            DtypeBoundaryRule(), UnseededRngRule(), RawTimingRule(),
            SpanLeakRule(), BareExceptRule(), RetryWithoutBackoffRule()]


_ALLOW = re.compile(
    r"#\s*analyze:\s*allow(?:\[(?P<rules>[\w,\s-]+)\])?(?P<why>[^#\n]*)")


def _parse_pragmas(source: str) -> Dict[int, Tuple[Optional[Set[str]], str]]:
    """Map line number -> (allowed rule names or None for all, justification)."""
    pragmas: Dict[int, Tuple[Optional[Set[str]], str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        match = _ALLOW.search(line)
        if match is None:
            continue
        rules = match.group("rules")
        names = ({r.strip() for r in rules.split(",") if r.strip()}
                 if rules else None)
        pragmas[lineno] = (names, match.group("why").strip())
    return pragmas


def lint_source(source: str, relpath: str = "<string>",
                rules: Optional[Sequence[Rule]] = None,
                force: bool = False) -> List[Finding]:
    """Lint one source string; returns all findings (allowed ones marked).

    ``force=True`` skips each rule's path applicability check — used by
    tests to point a single rule at a fixture regardless of where it
    lives.
    """
    active = list(rules) if rules is not None else default_rules()
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding(relpath, exc.lineno or 0, exc.offset or 0,
                        "syntax-error", str(exc.msg))]
    pragmas = _parse_pragmas(source)
    findings: List[Finding] = []
    for rule in active:
        if force or rule.applies(relpath, source):
            findings.extend(rule.check(tree, source, relpath))
    for finding in findings:
        for lineno in (finding.line, finding.line - 1):
            entry = pragmas.get(lineno)
            if entry is None:
                continue
            names, why = entry
            if names is None or finding.rule in names:
                if why:
                    finding.allowed = True
                    finding.justification = why
                break
    for lineno, (names, why) in sorted(pragmas.items()):
        if not why:
            findings.append(Finding(
                relpath, lineno, 0, "bare-allow",
                "allow pragma without a justification; write why the "
                "exception is safe (# analyze: allow[rule] <why>)"))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def lint_file(path: str, root: Optional[str] = None,
              rules: Optional[Sequence[Rule]] = None,
              force: bool = False) -> List[Finding]:
    with open(path, encoding="utf-8") as handle:
        source = handle.read()
    relpath = os.path.relpath(path, root) if root else path
    return lint_source(source, relpath.replace(os.sep, "/"), rules, force)


_DEFAULT_GLOBS = ("src", "benchmarks", "examples", "tools")


def _iter_python_files(root: str,
                       subdirs: Iterable[str] = _DEFAULT_GLOBS) -> List[str]:
    out: List[str] = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            out.extend(os.path.join(dirpath, f) for f in filenames
                       if f.endswith(".py"))
    return sorted(out)


def lint_paths(root: str, files: Optional[Sequence[str]] = None,
               rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint the repo tree under ``root`` (src/, benchmarks/, examples/, tools/)."""
    targets = list(files) if files is not None else _iter_python_files(root)
    findings: List[Finding] = []
    for path in targets:
        findings.extend(lint_file(path, root=root, rules=rules))
    return findings
