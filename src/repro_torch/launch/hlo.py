"""Post-SPMD HLO text analysis: trip-weighted FLOPs, HBM traffic and
collective link bytes (port of ``src/repro/launch/hlo.py``).

The port has no HLO of its own: PyTorch runs eagerly, and the port's
dry-run (``launch/dryrun.py``) counts a traced step's dispatched operations
instead.  This module is the reference's parser, kept as the port's own
copy so that the port imports nothing of the reference: it reads the HLO
text that the reference compiles, as
``repro_torch.analyze.collectives.collective_schedule_from_hlo`` does, and
gives the reference's numbers for it, number for number.  It is pure text
work (``re``, ``dataclasses``).

What it computes, as the reference's docstring sets out:

* **computations** are split on header lines; each op's RESULT shape is
  inline (operand shapes are resolved through a per-computation symbol
  table built from defining lines and parameters);
* **while** trip counts come from the backend_config ``known_trip_count``,
  with the condition-constant heuristic as fallback, and a loop body is
  weighted by its trip count (XLA's ``cost_analysis`` counts it once);
* **flops**: ``dot`` = 2 · prod(result dims) · prod(lhs contracting dims),
  ``convolution`` charged like a dot from its result; counted through
  fusion-called computations too;
* **HBM traffic** ≈ Σ (result bytes + operand bytes) over materializing
  top-level ops; ``parameter / tuple / get-tuple-element / bitcast /
  constant`` are free, ops inside fused computations are charged nothing.
  Two corrections for the CPU-backend text: an in-place
  dynamic-update-slice fusion is charged 2 x Σ(non-aliased operands), and
  a pure layout/convert fusion (the bf16 dtype-legalization copies) is
  charged 0;
* **collectives** are charged ring-algorithm per-device link bytes from the
  RESULT shape (R) and replica-group size N:
    all-reduce          2·R·(N-1)/N      (R = full buffer)
    all-gather          R·(N-1)/N        (R = gathered output)
    reduce-scatter      R·(N-1)          (R = scattered shard)
    all-to-all          R·(N-1)/N        (R = local buffer)
    collective-permute  R
  Groups whose device ids span pods (id // pod_size differs) are DCN
  traffic, the rest ICI.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "s2": 1, "u2": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z]+\d*[a-z\d]*)\[([\d,]*)\]")
_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.*\{\s*$")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,}{]+)\}\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,()TS]+)\]")
_TRIP_RE = re.compile(r'known_trip_count[^}]*"n"\s*:\s*"(\d+)"')
_CONST_RE = re.compile(r"=\s*[su]\d+\[\]\s*constant\((\d+)\)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_OPERANDS_RE = re.compile(r"%([\w.\-]+)")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast")

# ops that do not materialize an HBM buffer
_FREE_OPS = {
    "parameter", "tuple", "get-tuple-element", "bitcast", "constant",
    "after-all", "iota", "partition-id", "replica-id",
}


def _first_word(rest: str) -> str:
    """Opcode of an op line: the token right before the first '(' that is
    not part of the result-shape text."""
    # strip the result shape(s): everything up to the last ']' or '}' before
    # the opcode.  Simplest robust approach: scan tokens from the end of the
    # shape prefix.
    m = re.match(r"^(?:\([^()]*\)|[a-z]+\d*[a-z\d]*\[[\d,]*\](?:\{[\d,]*\})?"
                 r"|\s|,|/\*[^*]*\*/)*([\w\-]+)\(", rest)
    return m.group(1) if m else ""


def shape_bytes(text: str) -> int:
    """Sum byte sizes of every shape literal in ``text``."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(text: str) -> List[List[int]]:
    """All shape literals' dims in ``text`` (first = result for op lines)."""
    out = []
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        out.append([int(d) for d in dims.split(",") if d])
    return out


def _ring_bytes(kind: str, result_bytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind == "all-gather":
        return float(result_bytes) * (n - 1) / n
    if kind == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    if kind == "all-to-all":
        return float(result_bytes) * (n - 1) / n
    if kind == "collective-broadcast":
        return float(result_bytes)
    return float(result_bytes)        # collective-permute


@dataclasses.dataclass
class _Op:
    name: str
    opcode: str
    result_bytes: int
    result_dims: List[int]
    line: str


@dataclasses.dataclass
class _Computation:
    name: str
    ops: List[_Op]
    symtab: Dict[str, _Op]
    whiles: List[Tuple[str, str, float]]     # (cond, body, trip)
    calls: List[str]                         # call/conditional edges
    fusion_calls: List[str]                  # fusion-called computations
    max_const: int = 0
    has_dus: bool = False                    # contains dynamic-update-slice
    root_opcode: str = ""
    root_elems: int = 0                      # element count of the root
    n_compute_ops: int = 0                   # non-layout/non-convert ops
    # parameter index -> bytes actually read when the parameter's only
    # consumers are (dynamic-)slice ops (scan xs/cache stacks: a fusion
    # reading stacked[i] must be charged the slice, not the stack)
    param_slice_bytes: Dict[int, int] = dataclasses.field(
        default_factory=dict)


def _split_computations(hlo: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for line in hlo.splitlines():
        if cur is None:
            if "->" in line and line.rstrip().endswith("{"):
                m = _COMP_RE.match(line.strip())
                if m:
                    cur = m.group(1)
                    comps[cur] = []
            continue
        if line.strip() == "}":
            cur = None
            continue
        comps[cur].append(line)
    return comps


def _group_info(line: str, pod_size: int) -> Tuple[int, bool]:
    """(replica group size, crosses_pod) for a collective op line."""
    gm = _GROUPS_RE.search(line)
    if gm:
        groups = gm.group(1).split("},{")
        first = [int(x) for x in groups[0].strip("{}").split(",") if x]
        n = len(first)
        crosses = any(
            len({int(x) // pod_size
                 for x in g.strip("{}").split(",") if x}) > 1
            for g in groups)
        return n, crosses
    gi = _GROUPS_IOTA_RE.search(line)
    if gi:
        n_groups, group_size = int(gi.group(1)), int(gi.group(2))
        # iota groups [G,N]<=[dims(perm)]: contiguous ids iff the iota is
        # untransposed; a group whose stride reaches across pod_size crosses.
        spec = gi.group(3)
        total = n_groups * group_size
        if "T" not in spec and "(" not in spec:
            # [G,N]<=[total] row-major: group g = [g*N, (g+1)*N)
            crosses = group_size > pod_size or (
                total > pod_size and group_size > 1 and
                (pod_size % group_size != 0))
        else:
            # transposed iota: elements of a group are strided by n_groups —
            # any multi-pod program with stride >= pod_size crosses
            crosses = total > pod_size
        return group_size, crosses
    return 1, False


def _parse_computation(name: str, lines: List[str],
                       pod_size: int) -> _Computation:
    comp = _Computation(name=name, ops=[], symtab={}, whiles=[], calls=[],
                        fusion_calls=[])
    for line in lines:
        for m in _CONST_RE.finditer(line):
            comp.max_const = max(comp.max_const, int(m.group(1)))
        dm = _DEF_RE.match(line)
        if not dm:
            continue
        opname, rest = dm.groups()
        opcode = _first_word(rest)
        if not opcode:
            continue
        result_text = rest.split(opcode + "(")[0]
        dims = _shape_dims(result_text)
        op = _Op(name=opname, opcode=opcode,
                 result_bytes=shape_bytes(result_text),
                 result_dims=dims[0] if dims else [], line=line)
        comp.symtab[opname] = op
        comp.ops.append(op)
        if opcode == "dynamic-update-slice":
            comp.has_dus = True
        if opcode not in ("parameter", "constant", "get-tuple-element",
                          "tuple", "bitcast", "convert", "broadcast",
                          "reshape", "copy", "transpose"):
            comp.n_compute_ops += 1
        if line.lstrip().startswith("ROOT "):
            comp.root_opcode = opcode
            n_el = 1
            for d in op.result_dims:
                n_el *= d
            comp.root_elems = n_el
        if opcode == "while":
            cm = re.search(r"condition=%?([\w.\-]+)", line)
            bm = re.search(r"body=%?([\w.\-]+)", line)
            tm = _TRIP_RE.search(line)
            trip = float(tm.group(1)) if tm else 0.0
            if cm and bm:
                comp.whiles.append((cm.group(1), bm.group(1), trip))
        elif opcode in ("call", "conditional", "async-start"):
            for cm in re.finditer(
                    r"(?:to_apply|branch_computations|called_computation)="
                    r"\{?%?([\w.\-]+)", line):
                comp.calls.append(cm.group(1))
        elif opcode == "fusion":
            cm = re.search(r"calls=%?([\w.\-]+)", line)
            if cm:
                comp.fusion_calls.append(cm.group(1))

    # slice-only parameter analysis (see param_slice_bytes)
    param_idx: Dict[str, int] = {}
    for op in comp.ops:
        if op.opcode == "parameter":
            pm = re.search(r"parameter\((\d+)\)", op.line)
            if pm:
                param_idx[op.name] = int(pm.group(1))
    for pname, pidx in param_idx.items():
        slice_bytes = None
        ok = True
        for op in comp.ops:
            if op.name == pname or f"%{pname}" not in op.line:
                continue
            if op.opcode in ("dynamic-slice", "slice", "gather"):
                slice_bytes = max(slice_bytes or 0, op.result_bytes)
            else:
                ok = False
                break
        if ok and slice_bytes is not None:
            comp.param_slice_bytes[pidx] = slice_bytes
    return comp


def _operand_names(line: str, opcode: str) -> List[str]:
    """Operand %names inside the op's parens (excluding attribute refs)."""
    idx = line.find(opcode + "(")
    if idx < 0:
        return []
    depth = 0
    start = idx + len(opcode)
    end = start
    for i in range(start, len(line)):
        if line[i] == "(":
            depth += 1
        elif line[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    return _OPERANDS_RE.findall(line[start:end + 1])


def _dot_flops(op: _Op, comp: _Computation) -> float:
    out_elems = 1
    for d in op.result_dims:
        out_elems *= d
    contract = 1
    cm = _CONTRACT_RE.search(op.line)
    operands = _operand_names(op.line, op.opcode)
    if cm and operands:
        lhs = comp.symtab.get(operands[0])
        if lhs is not None and lhs.result_dims:
            for di in cm.group(1).split(","):
                if di and int(di) < len(lhs.result_dims):
                    contract *= lhs.result_dims[int(di)]
    return 2.0 * out_elems * contract


@dataclasses.dataclass
class ModuleCosts:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))


def analyze_module(hlo: str, pod_size: int = 256) -> Dict[str, float]:
    """Trip-weighted per-device costs of a post-SPMD HLO module."""
    raw = _split_computations(hlo)
    comps = {n: _parse_computation(n, ls, pod_size) for n, ls in raw.items()}
    entry = None
    for line in hlo.splitlines():
        if line.startswith("ENTRY"):
            m = re.search(r"ENTRY\s+%?([\w.\-]+)", line)
            if m:
                entry = m.group(1)
            break
    costs = ModuleCosts()

    def visit(name: str, mult: float, in_fusion: bool,
              stack: Tuple[str, ...]):
        comp = comps.get(name)
        if comp is None or name in stack:
            return
        stack = stack + (name,)
        for op in comp.ops:
            if op.opcode == "dot":
                f = _dot_flops(op, comp) * mult
                costs.flops += f
                costs.counts["dot"] += mult
            elif op.opcode == "convolution":
                # charge like a dot: 2 * out * (in_ch * kernel_spatial)
                f = 2.0 * max(op.result_bytes // 4, 0) * mult
                costs.flops += f
                costs.counts["convolution"] += mult
            if in_fusion:
                continue
            if op.opcode in COLLECTIVES or (
                    op.opcode.endswith("-start") and
                    op.opcode[:-6] in COLLECTIVES):
                kind = op.opcode[:-6] if op.opcode.endswith("-start") \
                    else op.opcode
                n, crosses = _group_info(op.line, pod_size)
                b = _ring_bytes(kind, op.result_bytes, n) * mult
                costs.collective[kind] += b
                costs.collective["total"] += b
                costs.collective["dcn" if crosses else "ici"] += b
                costs.counts[kind] += mult
            if op.opcode in _FREE_OPS or op.opcode.endswith("-done") or \
                    op.opcode == "while":
                continue
            callee = None
            if op.opcode == "fusion":
                cm = re.search(r"calls=%?([\w.\-]+)", op.line)
                callee = comps.get(cm.group(1)) if cm else None
            operand_bytes = []
            for i, on in enumerate(_operand_names(op.line, op.opcode)):
                o = comp.symtab.get(on)
                if o is None:
                    continue
                b = o.result_bytes
                if callee is not None and i in callee.param_slice_bytes:
                    b = min(b, callee.param_slice_bytes[i])
                operand_bytes.append(b)
            if op.opcode in ("dynamic-slice", "slice", "gather"):
                # reads only the slice (charged as result read + write)
                costs.traffic_bytes += 2.0 * op.result_bytes * mult
                continue
            in_place_dus = op.opcode == "dynamic-update-slice" or \
                (callee is not None and callee.has_dus)
            # pure layout/convert fusions: dtype-legalization shadows and
            # layout copies the TPU backend elides/fuses — charged 0
            dtype_legalize = op.opcode == "convert" or (
                callee is not None and callee.n_compute_ops == 0)
            if in_place_dus:
                # aliased buffer(s): only the update region moves.  Charge
                # 2x the sub-half-result operands (update read + slice
                # write); buffer-sized operands are aliased or shadows.
                half = op.result_bytes / 2
                traffic = 2.0 * sum(b for b in operand_bytes if b < half)
            elif dtype_legalize:
                traffic = 0.0
            else:
                traffic = op.result_bytes + sum(operand_bytes)
            costs.traffic_bytes += traffic * mult
        for callee in comp.calls:
            visit(callee, mult, in_fusion, stack)
        for callee in comp.fusion_calls:
            visit(callee, mult, True, stack)       # flops only
        for cond, body, trip in comp.whiles:
            t = trip if trip > 0 else max(
                1, comps.get(cond, _Computation(cond, [], {}, [], [], [])
                             ).max_const)
            visit(body, mult * t, in_fusion, stack)
            visit(cond, mult * t, in_fusion, stack)

    if entry is not None and entry in comps:
        visit(entry, 1.0, False, ())
    else:                                   # fallback: flat, unweighted
        for name in comps:
            visit(name, 1.0, False, ())

    out = {"flops": costs.flops, "traffic_bytes": costs.traffic_bytes}
    out.update({k: v for k, v in costs.collective.items()})
    out.setdefault("total", 0.0)
    out.setdefault("ici", 0.0)
    out.setdefault("dcn", 0.0)
    out.update({f"count_{k}": v for k, v in costs.counts.items()})
    return out


def analyze_collectives(hlo: str, pod_size: int = 256) -> Dict[str, float]:
    """Per-device collective link-bytes (compat wrapper on analyze_module)."""
    full = analyze_module(hlo, pod_size=pod_size)
    keep = tuple(COLLECTIVES) + ("total", "ici", "dcn")
    return {k: v for k, v in full.items()
            if k in keep or (k.startswith("count_") and
                             k[6:] in COLLECTIVES)}
