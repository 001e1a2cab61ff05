"""Opt-in runtime GF(2) sanitizer for the reduction engines (port of
``src/repro/analyze/invariants.py``, whole).

The reduction pipeline is exact algebra over GF(2): every committed pivot
low is unique per dimension, every explicit R column is a strictly
increasing key list, every packed bit-block holds exactly the coordinates
it was consolidated from, every Elias–Fano wire payload decodes back to
the records that produced it, and every budget spill must be reversible
(``R = reduce(∂(gens + [col]))``).  None of these are checked on the hot
path — a single flipped bit produces a *plausible but wrong* diagram.

This module is the cheap, always-correct referee.  It is disabled by
default and costs one ``None`` check per instrumented site.  Enable it
with either::

    compute_ph(points, tau_max, sanitize=True)

or the environment variable ``REPRO_SANITIZE=1`` (checked at import
time, so it also covers code paths that never go through
``compute_ph``).  On the first violated invariant the active
:class:`Sanitizer` raises a structured :class:`SanitizeViolation` that
names the check, the instrumented call site (``file:line``), and the
reduction context (dimension, superstep, batch, sweep slice) — instead
of letting the error propagate into a silently wrong barcode.  The checks
run on the host, on the numpy arrays the engines already hold, whichever
device the kernels run on.

Stdlib + numpy at import, as in the reference: the one check that needs
:mod:`repro_torch.kernels` imports it inside the check.
"""
from __future__ import annotations

import os
import sys
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np


class SanitizeViolation(RuntimeError):
    """A GF(2) invariant did not hold at an instrumented site.

    Attributes:
        check: short name of the violated invariant (e.g.
            ``"pivot-low-unique"``).
        detail: human-readable description of what went wrong.
        location: ``file:line`` of the instrumented call site.
        context: reduction context at failure time (``dim``,
            ``superstep``, ``batch``, ``slice`` — whatever the engine had
            published via :meth:`Sanitizer.set_context`).
    """

    def __init__(self, check: str, detail: str, location: str = "",
                 context: Optional[Mapping[str, Any]] = None) -> None:
        self.check = check
        self.detail = detail
        self.location = location
        self.context: Dict[str, Any] = dict(context or {})
        parts = [f"REPRO_SANITIZE[{check}]"]
        if location:
            parts.append(f"at {location}")
        if self.context:
            ctx = ", ".join(f"{k}={v}" for k, v in sorted(self.context.items()))
            parts.append(f"({ctx})")
        super().__init__(" ".join(parts) + f": {detail}")


class Sanitizer:
    """Incremental GF(2) invariant checks, armed by :func:`sanitizing`.

    All ``check_*`` methods are cheap relative to the work they guard
    (at most one extra pass over the data already in hand) and raise
    :class:`SanitizeViolation` on the first broken invariant.  Engines
    publish where they are via :meth:`set_context` so the violation can
    say *which* superstep/batch/slice went wrong.
    """

    def __init__(self) -> None:
        self.context: Dict[str, Any] = {}
        self.counts: Dict[str, int] = {}

    # -- bookkeeping ----------------------------------------------------
    def set_context(self, **kwargs: Any) -> None:
        """Publish (or clear, with ``None``) reduction context keys."""
        for key, value in kwargs.items():
            if value is None:
                self.context.pop(key, None)
            else:
                self.context[key] = value

    def _tick(self, check: str) -> None:
        self.counts[check] = self.counts.get(check, 0) + 1

    def _fail(self, check: str, detail: str) -> None:
        # Frame 0 is _fail, 1 the check_* method, 2 the instrumented site.
        frame = sys._getframe(2)
        location = f"{frame.f_code.co_filename}:{frame.f_lineno}"
        raise SanitizeViolation(check, detail, location, self.context)

    # -- pivot bookkeeping (reduction.py) -------------------------------
    def check_fresh_pivot(self, known_lows: Mapping[int, Any], low: int) -> None:
        """A pivot low may be claimed at most once per dimension."""
        self._tick("pivot-low-unique")
        if low in known_lows:
            self._fail(
                "pivot-low-unique",
                f"pivot low {int(low)} committed twice; a duplicate low means "
                "two columns were both declared reduced with the same pivot "
                "(lost XOR or a stale pivot-exchange replica)")

    def check_canonical_column(self, keys: np.ndarray) -> None:
        """Stored/encoded R columns are strictly increasing key lists."""
        self._tick("canonical-column")
        if keys.size > 1 and bool(np.any(np.diff(keys.astype(np.int64)) <= 0)):
            self._fail(
                "canonical-column",
                f"column keys are not strictly increasing ({keys.size} keys, "
                "GF(2) columns must be canonical sorted supports)")

    def check_pair_orders(self, births: np.ndarray, deaths: np.ndarray) -> None:
        """In a valid filtration order no pair can die before it is born."""
        self._tick("pair-order")
        bad = np.flatnonzero(np.asarray(deaths) < np.asarray(births))
        if bad.size:
            k = int(bad[0])
            self._fail(
                "pair-order",
                f"{bad.size} persistence pair(s) with death < birth (first: "
                f"birth={float(np.asarray(births)[k])!r}, "
                f"death={float(np.asarray(deaths)[k])!r}); the canonical "
                "(length, i, j) filtration tie-break was violated upstream")

    def check_rematerialization(self, explicit_r: np.ndarray,
                                rematerialized: np.ndarray,
                                col_id: int) -> None:
        """Spilling a column to implicit form must be lossless.

        ``explicit_r`` is the stored R column about to be dropped;
        ``rematerialized`` is ``reduce(∂(gens + [col]))`` — what every
        later :meth:`PivotStore._materialize` call will reconstruct.
        """
        self._tick("spill-rematerialization")
        if not np.array_equal(np.asarray(explicit_r), np.asarray(rematerialized)):
            self._fail(
                "spill-rematerialization",
                f"column {int(col_id)}: explicit R ({np.asarray(explicit_r).size} "
                f"keys) != δ-expansion of its generator list "
                f"({np.asarray(rematerialized).size} keys); demoting now would "
                "silently corrupt every later implicit lookup")

    # -- packed bit-blocks (packed_reduce.py) ---------------------------
    def check_segment_bits(self, positions: np.ndarray, seg_len: int) -> None:
        """No set bit may live beyond its segment's key universe."""
        self._tick("packed-segment")
        n_stray = int(np.count_nonzero(np.asarray(positions) >= seg_len))
        if n_stray:
            self._fail(
                "packed-segment",
                f"{n_stray} set bit(s) at rank >= the segment universe "
                f"(len {int(seg_len)}); stray bits would be silently dropped "
                "by consolidation, i.e. a lost GF(2) coordinate")

    def check_consolidation(self, row_idx: np.ndarray, keys: np.ndarray,
                            universe: np.ndarray, block: np.ndarray) -> None:
        """Consolidation must preserve the exact (row, key) bit multiset."""
        self._tick("packed-consolidation")
        from ..kernels.gf2 import set_bit_positions  # lazy: torch

        got_rows, got_pos, _ = set_bit_positions(np.ascontiguousarray(block))
        if int(np.count_nonzero(np.asarray(got_pos) >= len(universe))):
            self._fail(
                "packed-consolidation",
                "consolidated block has set bits beyond the merged universe "
                f"(len {len(universe)})")
        got_keys = np.asarray(universe)[got_pos]
        want = np.lexsort((keys, row_idx))
        have = np.lexsort((got_keys, got_rows))
        same = (len(got_rows) == len(row_idx)
                and np.array_equal(np.asarray(row_idx)[want], got_rows[have])
                and np.array_equal(np.asarray(keys)[want], got_keys[have]))
        if not same:
            self._fail(
                "packed-consolidation",
                f"consolidation changed the block contents: "
                f"{len(row_idx)} (row, key) bits in, {len(got_rows)} out")

    # -- wire codec (pivot_cache.py) ------------------------------------
    def check_wire_roundtrip(
            self, records: Sequence[Mapping[str, Any]], payload: np.ndarray,
            decode: Callable[[np.ndarray], List[Dict[str, Any]]]) -> None:
        """Every encoded pivot-exchange delta must decode back exactly."""
        self._tick("wire-roundtrip")
        try:
            back = decode(np.asarray(payload))
        except Exception as exc:  # noqa: BLE001 - converted to a violation
            self._fail("wire-roundtrip",
                       f"decode of a just-encoded delta failed: {exc!r}")
            return
        if len(back) != len(records):
            self._fail(
                "wire-roundtrip",
                f"encoded {len(records)} commit record(s) but decoded "
                f"{len(back)}")
        for rec, got in zip(records, back):
            if int(rec["low"]) != int(got["low"]) or \
                    int(rec["col_id"]) != int(got["col_id"]) or \
                    str(rec["mode"]) != str(got["mode"]):
                self._fail(
                    "wire-roundtrip",
                    f"record header changed on the wire: sent "
                    f"(low={int(rec['low'])}, col={int(rec['col_id'])}, "
                    f"mode={rec['mode']}), got (low={int(got['low'])}, "
                    f"col={int(got['col_id'])}, mode={got['mode']})")
            sent_col = rec.get("column")
            got_col = got.get("column")
            if (sent_col is None) != (got_col is None) or (
                    sent_col is not None and not np.array_equal(
                        np.asarray(sent_col), np.asarray(got_col))):
                self._fail(
                    "wire-roundtrip",
                    f"R column for low {int(rec['low'])} changed on the wire")
            sent_gens = rec.get("gens")
            sent_gens = (np.sort(np.asarray(sent_gens, dtype=np.int64))
                         if sent_gens is not None
                         else np.empty(0, dtype=np.int64))
            got_gens = np.asarray(
                got.get("gens") if got.get("gens") is not None else [],
                dtype=np.int64)
            if not np.array_equal(sent_gens, got_gens):
                self._fail(
                    "wire-roundtrip",
                    f"generator list for low {int(rec['low'])} changed on "
                    "the wire")


_ACTIVE: Optional[Sanitizer] = (
    Sanitizer()
    if os.environ.get("REPRO_SANITIZE", "0") not in ("", "0")
    else None)


def active_sanitizer() -> Optional[Sanitizer]:
    """The armed :class:`Sanitizer`, or ``None`` when checks are off."""
    return _ACTIVE


@contextmanager
def sanitizing(enabled: Optional[bool] = True) -> Iterator[Optional[Sanitizer]]:
    """Scope the sanitizer on (``True``), off (``False``), or as-is (``None``).

    ``None`` leaves the ambient state (the ``REPRO_SANITIZE`` env default
    or an enclosing :func:`sanitizing` scope) untouched — this is what
    lets ``compute_ph(sanitize=None)`` defer to the environment.
    """
    global _ACTIVE
    if enabled is None:
        yield _ACTIVE
        return
    previous = _ACTIVE
    _ACTIVE = Sanitizer() if enabled else None
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = previous
