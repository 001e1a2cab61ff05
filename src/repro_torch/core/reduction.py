"""Cohomology reduction engines (Dory §4.3).

Port of ``src/repro/core/reduction.py`` (host numpy, unchanged semantics).
:class:`PivotStore` takes the reference's ``commit_log`` and ``install``,
which the distributed packed reduction uses for its wire backlogs and pivot
replicas.  The engines take the reference's warm-restart hooks
(``seed_gens``, ``commit_log``, ``essential_log``; :func:`seed_column`),
which :mod:`repro_torch.core.resume` drives.  The GF(2) sanitizer's hooks
(:mod:`repro_torch.analyze.invariants`) sit at the reference's sites: a
spill's rematerialization, a fresh pivot and a canonical column at
``commit``, a fresh pivot at ``install``, and the pair order before
clearance.

Implements the paper's reduction family on packed paired-index keys:

* ``explicit`` mode — paper Algorithm 1: store the reduced coboundary columns
  ``R^⊥`` (sorted key arrays).  Fastest, highest memory.
* ``implicit`` mode — paper Algorithm 2 / §4.3.4 ("fast implicit column"):
  store only the reduction operations ``V^⊥`` (lists of generator column
  ids); a lookback re-materializes ``R^⊥(e') = ⊕ δe''`` by vectorized
  coboundary enumeration + merge-cancel.  Memory ∝ Σ|V| — the paper's
  potential factor-n saving.

Both modes implement:
* **trivial persistence pairs** (§4.3.5): pairs ``(t, e')`` with
  ``t = min δe'`` and ``diam(t) = e'`` are never stored and are detected by
  an O(1) check against the precomputed min-cofacet array; reductions with a
  trivial owner use its freshly-enumerated coboundary.
* **clearing** (§4.5, Chen-Kerber): columns that were pivots in the lower
  dimension are skipped entirely.

The bit-packed serial-parallel engine (§4.4) lives in ``packed_reduce.py``
and reuses the same column primitives.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..analyze.invariants import active_sanitizer
from ..obs.metrics import MetricsRegistry
from ..obs.trace import span
from .pairing import EMPTY_KEY


def merge_cancel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Symmetric difference of two sorted unique int64 key arrays (GF(2) add).

    The vector form of "column j <- column j (+) column i": concatenate,
    sort, drop equal pairs.  Inputs may carry EMPTY_KEY padding (stripped)."""
    m = np.concatenate([a, b])
    m = m[m != EMPTY_KEY]
    m.sort(kind="stable")
    if m.size == 0:
        return m
    neq_prev = np.empty(m.size, dtype=bool)
    neq_prev[0] = True
    np.not_equal(m[1:], m[:-1], out=neq_prev[1:])
    neq_next = np.empty(m.size, dtype=bool)
    neq_next[-1] = True
    np.not_equal(m[:-1], m[1:], out=neq_next[:-1])
    return m[neq_prev & neq_next]


def parity_reduce(keys: np.ndarray) -> np.ndarray:
    """Keep keys appearing an odd number of times (multi-way GF(2) sum)."""
    keys = keys[keys != EMPTY_KEY]
    if keys.size == 0:
        return keys
    u, c = np.unique(keys, return_counts=True)
    return u[(c % 2) == 1]


@dataclasses.dataclass
class DimensionAdapter:
    """Dimension-specific plumbing for the generic cohomology reduction.

    columns are identified by int64 ids (edge order for H1*, packed triangle
    key for H2*); lows are cofacet keys one dimension up.
    """
    # coboundary of a batch of column ids -> (B, K) sorted keys, EMPTY pad
    cobdy: Callable[[np.ndarray], np.ndarray]
    # candidate trivial owner of a low key -> column id
    owner_of_low: Callable[[np.ndarray], np.ndarray]
    # min cofacet key of a column id (for trivial checks); vectorized
    min_cobdy: Callable[[np.ndarray], np.ndarray]
    # filtration value of a column id / of a low key
    birth_value: Callable[[np.ndarray], np.ndarray]
    death_value: Callable[[np.ndarray], np.ndarray]


@dataclasses.dataclass
class ReductionResult:
    pairs: np.ndarray          # (k, 2) float64 (birth, death), death finite
    essentials: np.ndarray     # (m,) float64 births of never-dying classes
    pivot_lows: np.ndarray     # int64 keys that became pivots (for clearing)
    stats: Dict[str, float]
    # provenance (optional — engines fill them, synthetic results may not):
    # column ids aligned with ``pairs`` rows / ``pivot_lows`` entries /
    # ``essentials`` entries, so callers can split a batched reduction back
    # into per-source diagrams and warm-start engines can replay columns
    pair_cols: Optional[np.ndarray] = None      # (k,) int64
    pivot_cols: Optional[np.ndarray] = None     # (p,) int64, incl. trivial
    essential_ids: Optional[np.ndarray] = None  # (m,) int64

    def diagram(self) -> np.ndarray:
        ess = np.stack([self.essentials,
                        np.full_like(self.essentials, np.inf)], axis=1) \
            if self.essentials.size else np.zeros((0, 2))
        return np.concatenate([self.pairs, ess], axis=0)


class PivotStore:
    """R^⊥/V^⊥ storage with trivial pairs excluded (paper §4.3.1, §4.3.5).

    ``store_budget_bytes`` makes the explicit store *budgeted*: once the
    stored bytes would cross the budget, columns are demoted to implicit
    form (V^⊥ generator lists, re-materialized on lookup) — memory stays
    bounded by the budget plus one column, at the price of re-enumerating
    coboundaries when a spilled column is looked up.  The reduction's output
    is unchanged: both representations reproduce the identical ``R^⊥`` keys.
    Per-column representation is tracked in ``col_modes`` so the two forms
    coexist in one table.

    Spill *policy* is largest-explicit-column-first (a max-heap over
    explicit column sizes): when a commit would cross the budget, the
    biggest explicit columns already in the store are demoted to implicit
    until the incoming column fits — unless the incoming column is itself
    at least as big as everything stored, in which case it is the one that
    goes implicit.  Big columns buy the least lookups per byte, so evicting
    them first keeps the most pivots explicit under a fixed budget (the
    earlier policy never demoted: whatever committed first stayed explicit
    forever, i.e. naive FIFO).

    Mixed mode needs one extra invariant: a spilled column's stored V must
    be a *complete* δ-basis expansion, which requires the expansions of the
    explicit columns it absorbed too (``R(o) = δo ⊕ ⊕_{g∈V(o)} δg`` — an
    explicit ``R`` array alone cannot be expanded after the fact).  So
    whenever spilling is possible, gens are tracked for explicit commits as
    well (``gens_lists``, counted against the budget); the pure explicit
    path stores nothing extra.
    """

    def __init__(self, adapter: DimensionAdapter, mode: str,
                 store_budget_bytes: Optional[int] = None,
                 cache=None, commit_log: Optional[list] = None):
        assert mode in ("explicit", "implicit")
        self.adapter = adapter
        self.mode = mode
        self.store_budget_bytes = store_budget_bytes
        self.track_gens = (mode == "implicit"
                           or store_budget_bytes is not None)
        self.low_to_idx: Dict[int, int] = {}
        self.columns: List[np.ndarray] = []   # explicit: R keys; implicit: V gens
        self.gens_lists: List[Optional[np.ndarray]] = []  # δ-expansions
        self.col_ids: List[int] = []
        self.col_modes: List[str] = []
        self.bytes_stored = 0
        self.n_spilled = 0
        # shared PackedPivotCache (core.pivot_cache): memoizes implicit
        # re-materializations and trivial-owner coboundaries by low — both
        # canonical per low, so cache hits can never perturb bit-identity
        self.cache = cache
        # when set, every non-trivial commit appends a wire-format record
        # here (the distributed reduction drains it each superstep)
        self.commit_log = commit_log
        # max-heap (as negated sizes) over explicit column byte sizes for the
        # largest-explicit-column-first spill policy; entries are permanent
        # (a column is popped exactly once, when demoted)
        self._explicit_heap: List[Tuple[int, int]] = []

    def lookup_addend(self, low: int, self_id: int) -> Optional[np.ndarray]:
        """Column to add into r given its current low; None if low is fresh.

        Order of checks mirrors the paper: trivial pair first (O(1) check,
        nothing stored), then the committed pivot table.
        """
        owner = int(self.adapter.owner_of_low(np.array([low], dtype=np.int64))[0])
        if owner != self_id:
            mc = int(self.adapter.min_cobdy(np.array([owner], dtype=np.int64))[0])
            if mc == low:
                # (low, owner) is a trivial pair: R(owner) == δ(owner).
                return self.adapter.cobdy(np.array([owner], dtype=np.int64))[0]
        idx = self.low_to_idx.get(low)
        if idx is None:
            return None
        if self.col_modes[idx] == "explicit":
            return self.columns[idx]
        return self._materialize(idx, low)

    def _materialize(self, idx: int, low: int) -> np.ndarray:
        """R(e') = ⊕_{e'' in V(e') ∪ {e'}} δe'' for an implicit column,
        served from the shared pivot cache when possible — the reduced
        column at a given low is canonical, so the memo is exact."""
        if self.cache is not None:
            keys = self.cache.get_column(low)
            if keys is not None:
                return keys
        gens = np.concatenate([self.columns[idx],
                               np.array([self.col_ids[idx]], dtype=np.int64)])
        r = parity_reduce(self.adapter.cobdy(gens).ravel())
        if self.cache is not None:
            self.cache.put_column(low, r)
        return r

    def _demote(self, idx: int) -> None:
        """Convert a stored explicit column to implicit (V^⊥) in place."""
        assert self.col_modes[idx] == "explicit" \
            and self.gens_lists[idx] is not None
        san = active_sanitizer()
        if san is not None and callable(getattr(self.adapter, "cobdy", None)):
            # a demotion is one-way: verify the δ-expansion reproduces the
            # explicit R keys *before* they are dropped (needs a real
            # adapter — synthetic stores with stub adapters skip this)
            gens = np.concatenate([
                self.gens_lists[idx],
                np.array([self.col_ids[idx]], dtype=np.int64)])
            rematerialized = parity_reduce(self.adapter.cobdy(gens).ravel())
            san.check_rematerialization(self.columns[idx], rematerialized,
                                        self.col_ids[idx])
        self.bytes_stored -= self.columns[idx].nbytes
        self.columns[idx] = self.gens_lists[idx]
        self.col_modes[idx] = "implicit"
        self.n_spilled += 1

    def _make_room(self, incoming_total: int, incoming_r_nbytes: int) -> bool:
        """Largest-explicit-column-first spill: demote the biggest explicit
        columns until ``incoming_total`` more bytes (R keys plus tracked
        gens) fit the budget.  Returns False (caller commits implicitly)
        once the incoming column's R keys are at least as big as every
        remaining explicit column — demoting smaller columns to admit a
        bigger one would only shrink the explicit set.  Demotions are
        planned first and applied only when they actually make the
        incoming column fit: demotion is one-way (the explicit R keys are
        dropped), so a doomed admission must not evict anything."""
        planned: List[Tuple[int, int]] = []
        freed = 0
        fits = True
        while self.bytes_stored - freed + incoming_total \
                > self.store_budget_bytes:
            if not self._explicit_heap:
                fits = False
                break
            neg_size, idx = self._explicit_heap[0]
            if -neg_size <= incoming_r_nbytes:
                fits = False
                break
            planned.append(heapq.heappop(self._explicit_heap))
            freed += -neg_size
        if not fits:
            for item in planned:
                heapq.heappush(self._explicit_heap, item)
            return False
        if planned:
            with span("reduce/spill", n=len(planned), freed_bytes=freed):
                for _, idx in planned:
                    self._demote(idx)
        return True

    def commit(self, low: int, col_id: int, r: np.ndarray, gens: np.ndarray,
               trivial: bool) -> None:
        if trivial:
            return  # never stored (paper §4.3.5)
        san = active_sanitizer()
        if san is not None:
            san.check_fresh_pivot(self.low_to_idx, low)
            if r.size:
                san.check_canonical_column(r)
        mode = self.mode
        if mode == "explicit" and self.store_budget_bytes is not None:
            incoming = r.nbytes + (gens.nbytes if self.track_gens else 0)
            if not self._make_room(incoming, r.nbytes):
                mode = "implicit"   # budget spill: keep V gens, drop R keys
                self.n_spilled += 1
        self.low_to_idx[low] = len(self.columns)
        self.col_ids.append(col_id)
        self.col_modes.append(mode)
        if mode == "explicit":
            self.columns.append(r)
            self.bytes_stored += r.nbytes
            if self.store_budget_bytes is not None:
                heapq.heappush(self._explicit_heap,
                               (-r.nbytes, len(self.columns) - 1))
            # keep the δ-expansion too when spilling is possible: a later
            # spilled column that absorbed this one needs it (see class
            # docstring); counted against the budget for honesty
            self.gens_lists.append(gens if self.track_gens else None)
            if self.track_gens:
                self.bytes_stored += gens.nbytes
        else:
            self.columns.append(gens)
            self.gens_lists.append(gens)
            self.bytes_stored += gens.nbytes
        if self.commit_log is not None:
            self.commit_log.append({
                "low": low, "col_id": col_id, "mode": mode,
                "column": r if mode == "explicit" else None,
                "gens": gens,
            })

    def install(self, low: int, col_id: int, mode: str, column, gens) -> None:
        """Install a decoded replicated pivot verbatim (no budget logic).

        The distributed reduction's *replica* store is built exclusively
        through this path, from records that crossed the pivot-exchange
        wire.  A replica never spills or demotes — it holds whatever mode
        the authoritative store committed (a later demotion on the
        authority is representational only and is not replicated)."""
        assert mode in ("explicit", "implicit")
        san = active_sanitizer()
        if san is not None:
            san.check_fresh_pivot(self.low_to_idx, low)
        self.low_to_idx[low] = len(self.columns)
        self.col_ids.append(col_id)
        self.col_modes.append(mode)
        gens = np.ascontiguousarray(gens, dtype=np.int64)
        if mode == "explicit":
            column = np.ascontiguousarray(column, dtype=np.int64)
            self.columns.append(column)
            self.bytes_stored += column.nbytes
            self.gens_lists.append(gens if self.track_gens else None)
            if self.track_gens:
                self.bytes_stored += gens.nbytes
        else:
            self.columns.append(gens)
            self.gens_lists.append(gens)
            self.bytes_stored += gens.nbytes

    def lookup_addends_batched(self, lows: np.ndarray, self_ids: np.ndarray):
        """Vectorized :meth:`lookup_addend` over a batch of columns.

        ``lows``: (B,) int64 current lows (negative = inactive, skipped);
        ``self_ids``: (B,) int64 owning column ids.  Returns
        ``(addends, owners, owner_gens)`` — per column the addend key array
        (None when the low is fresh), the owner column id, and the owner's
        stored δ-expansion (empty for trivial owners / untracked columns).
        The per-element adapter calls of the scalar path (one
        ``np.array([x])`` per probe) collapse into one ``owner_of_low``, one
        ``min_cobdy``, and one ``cobdy`` call per batch round.
        """
        lows = np.asarray(lows, dtype=np.int64)
        self_ids = np.asarray(self_ids, dtype=np.int64)
        B = len(lows)
        addends: List[Optional[np.ndarray]] = [None] * B
        owners = np.full(B, -1, dtype=np.int64)
        owner_gens: List[Optional[np.ndarray]] = [None] * B
        no_gens = np.zeros(0, dtype=np.int64)
        active = lows >= 0
        if not active.any():
            return addends, owners, owner_gens
        own = np.full(B, -1, dtype=np.int64)
        own[active] = self.adapter.owner_of_low(lows[active])
        # trivial pairs first (order mirrors lookup_addend): owner != self
        # and low == min δ(owner)  =>  addend is δ(owner) itself
        cand = active & (own != self_ids)
        trivial = np.zeros(B, dtype=bool)
        if cand.any():
            ci = np.where(cand)[0]
            mc = self.adapter.min_cobdy(own[ci])
            trivial[ci[mc == lows[ci]]] = True
        if trivial.any():
            ti = np.where(trivial)[0]
            # a trivial addend δ(owner) is canonical per low (owner =
            # owner_of_low(low)), so it lives in the shared cache too;
            # only the misses get the batched enumeration
            miss = []
            for i in ti:
                cached = (self.cache.get_column(int(lows[i]))
                          if self.cache is not None else None)
                if cached is None:
                    miss.append(i)
                else:
                    addends[i] = cached
                owners[i] = own[i]
                owner_gens[i] = no_gens
            if miss:
                mi = np.asarray(miss)
                tcob = self.adapter.cobdy(own[mi])
                for k, i in enumerate(mi):
                    row = tcob[k]
                    addends[i] = row[row != EMPTY_KEY]
                    if self.cache is not None:
                        self.cache.put_column(int(lows[i]), addends[i])
        for i in np.where(active & ~trivial)[0]:
            idx = self.low_to_idx.get(int(lows[i]))
            if idx is None:
                continue
            owners[i] = self.col_ids[idx]
            g = self.gens_lists[idx]
            owner_gens[i] = g if g is not None else no_gens
            if self.col_modes[idx] == "explicit":
                addends[i] = self.columns[idx]
            else:
                addends[i] = self._materialize(idx, int(lows[i]))
        return addends, owners, owner_gens


def clearing_filter(column_ids, cleared) -> np.ndarray:
    """Drop cleared ids from ``column_ids``, order preserved (vectorized).

    ``cleared`` may be a set (legacy callers) or any int array-like; one
    ``np.isin`` replaces the former per-column Python membership loop, which
    dominated at large ``n_e``.
    """
    ids = np.asarray(column_ids, dtype=np.int64)
    if cleared is None:
        return ids
    if isinstance(cleared, (set, frozenset)):
        carr = np.fromiter(cleared, dtype=np.int64, count=len(cleared))
    else:
        carr = np.asarray(cleared, dtype=np.int64)
    if ids.size == 0 or carr.size == 0:
        return ids
    return ids[~np.isin(ids, carr)]


def finalize_result(pairs: List[tuple], essentials: List[float],
                    essential_ids: List[int],
                    stats: Dict[str, float]) -> ReductionResult:
    """Assemble a :class:`ReductionResult` from 4-tuple ``(b, d, low, col)``
    pair records — trivial pairs (d == b) drop out of the diagram but keep
    their lows/cols for clearing and warm restarts (shared by all engines).
    """
    finite = [(b, d) for b, d, _, _ in pairs if d > b]
    pair_arr = np.array(finite, dtype=np.float64).reshape(-1, 2)
    pair_cols = np.array([c for b, d, _, c in pairs if d > b], dtype=np.int64)
    pivot_lows = np.array([low for _, _, low, _ in pairs], dtype=np.int64)
    pivot_cols = np.array([c for _, _, _, c in pairs], dtype=np.int64)
    return ReductionResult(
        pairs=pair_arr,
        essentials=np.array(essentials, dtype=np.float64),
        pivot_lows=pivot_lows,
        stats=stats,
        pair_cols=pair_cols,
        pivot_cols=pivot_cols,
        essential_ids=np.array(essential_ids, dtype=np.int64),
    )


def _parity_gens(gens_parity: Dict[int, int]) -> np.ndarray:
    """Odd-count generator ids of a parity dict as a sorted int64 array."""
    g = np.array([k for k, p in gens_parity.items() if p % 2 == 1],
                 dtype=np.int64)
    g.sort()
    return g


def seed_column(adapter: DimensionAdapter, col_id: int,
                seed: np.ndarray) -> np.ndarray:
    """Initial residual of a warm-started column (resume support).

    ``R0(col) = ⊕_{g ∈ seed ∪ {col}} δg`` — the partial reduction state a
    prior run recorded as the column's V-expansion, re-expressed against the
    *current* coboundary.  Every ``g`` precedes ``col`` in decreasing
    filtration order, so handing this to an engine in place of ``δ(col)``
    is a valid left-to-right partial reduction: completing it greedily
    yields the canonical pairing, bit-identical to a cold run.
    """
    seed = np.asarray(seed, dtype=np.int64)
    gens = np.concatenate([seed, np.array([col_id], dtype=np.int64)])
    return parity_reduce(adapter.cobdy(gens).ravel())


def clearance_commit(store: PivotStore, adapter: DimensionAdapter,
                     ids: np.ndarray, lows: np.ndarray,
                     gens_list, get_columns,
                     pairs: List[tuple], essentials: List[float],
                     essential_ids: Optional[List[int]] = None,
                     essential_log: Optional[list] = None) -> None:
    """Batched clearance (§4.4 "clearance" step), shared by the batch and
    packed engines: batched value lookups, trivial-pair detection, commits
    in batch order.

    ``lows``: (B,) int64 current lows (-1 = empty column -> essential).
    ``get_columns(rows)`` materializes the R key arrays for exactly the
    rows whose explicit columns the store will hold — it is never called
    for trivial pairs (nothing stored, §4.3.5) nor for a pure implicit
    store (only gens stored).  Appends ``(birth, death, low, col_id)``
    tuples and essential births in place.  ``essential_ids`` collects the
    essential column ids alongside; ``essential_log`` additionally records
    each essential column's δ-expansion (``{"col_id", "gens"}``) so a
    warm restart can replay it (:mod:`repro_torch.core.resume`).
    """
    ids_arr = np.asarray(ids, dtype=np.int64)
    lows = np.asarray(lows, dtype=np.int64)
    B = len(ids_arr)
    empty = [i for i in range(B) if lows[i] < 0]
    if empty:
        births = adapter.birth_value(ids_arr[empty])
        essentials.extend(float(b) for b in births)
        if essential_ids is not None:
            essential_ids.extend(int(ids_arr[i]) for i in empty)
        if essential_log is not None:
            for i in empty:
                essential_log.append({
                    "col_id": int(ids_arr[i]),
                    "gens": _parity_gens(gens_list[i]),
                })
    nonempty = [i for i in range(B) if lows[i] >= 0]
    if not nonempty:
        return
    ne_ids = ids_arr[nonempty]
    ne_lows = lows[nonempty]
    mcs = adapter.min_cobdy(ne_ids)
    ne_owners = adapter.owner_of_low(ne_lows)
    births = adapter.birth_value(ne_ids)
    deaths = adapter.death_value(ne_lows)
    san = active_sanitizer()
    if san is not None:
        san.check_pair_orders(births, deaths)
    trivial = (np.asarray(mcs) == ne_lows) & (np.asarray(ne_owners) == ne_ids)
    if store.mode == "implicit":
        store_rows = np.zeros(0, dtype=np.int64)
    else:
        store_rows = np.asarray(nonempty, dtype=np.int64)[~trivial]
    cols = dict(zip(store_rows.tolist(), get_columns(store_rows)))
    no_col = np.zeros(0, dtype=np.int64)
    for k, i in enumerate(nonempty):
        if trivial[k]:
            store.commit(int(ne_lows[k]), int(ne_ids[k]), no_col, no_col,
                         True)
        else:
            g = _parity_gens(gens_list[i])
            store.commit(int(ne_lows[k]), int(ne_ids[k]), cols.get(i, no_col),
                         g, False)
        pairs.append((float(births[k]), float(deaths[k]), int(ne_lows[k]),
                      int(ne_ids[k])))


def reduce_dimension(
    adapter: DimensionAdapter,
    column_ids: np.ndarray,
    mode: str = "explicit",
    cleared=None,
    return_store: bool = False,
    store_budget_bytes: Optional[int] = None,
    seed_gens: Optional[Dict[int, np.ndarray]] = None,
    commit_log: Optional[list] = None,
    essential_log: Optional[list] = None,
):
    """Single-column (paper 1-thread) cohomology reduction.

    The reference's parameters in the reference's order; it runs on the
    host only, so it takes no ``device``.

    ``column_ids`` must be in *decreasing* filtration order (``F^-1``), with
    clearing already applied or supplied via ``cleared`` (set or int array).
    ``store_budget_bytes`` bounds the explicit pivot store: columns past the
    budget are kept implicitly (V^⊥) and re-materialized on lookup — same
    diagram, bounded memory (see :class:`PivotStore`).  ``return_store``
    returns ``(result, store)``.

    Warm restarts (:mod:`repro_torch.core.resume`): ``seed_gens`` maps
    column ids to the δ-expansion a prior run recorded for them — a seeded
    column starts from :func:`seed_column`'s residual with its gens parity
    pre-loaded, so committed/logged expansions stay *full* raw-δ
    expansions.  ``commit_log`` threads through to :class:`PivotStore`
    (every non-trivial commit appended); ``essential_log`` records
    ``{"col_id", "gens"}`` for every essential column.
    """
    store = PivotStore(adapter, mode, store_budget_bytes=store_budget_bytes,
                       commit_log=commit_log)
    pairs: List[tuple] = []
    essentials: List[float] = []
    essential_ids: List[int] = []
    n_reductions = 0
    n_columns_in = len(column_ids)
    column_ids = clearing_filter(column_ids, cleared)

    for col_id in column_ids:
        col_id = int(col_id)
        seed = seed_gens.get(col_id) if seed_gens else None
        if seed is not None and len(seed):
            r = seed_column(adapter, col_id, seed)
            gens_parity: Dict[int, int] = {int(g): 1 for g in seed}
        else:
            r = adapter.cobdy(np.array([col_id], dtype=np.int64))[0]
            r = r[r != EMPTY_KEY]
            gens_parity = {}
        while True:
            if r.size == 0:
                essentials.append(float(
                    adapter.birth_value(np.array([col_id], dtype=np.int64))[0]))
                essential_ids.append(col_id)
                if essential_log is not None:
                    essential_log.append({"col_id": col_id,
                                          "gens": _parity_gens(gens_parity)})
                break
            low = int(r[0])
            addend = store.lookup_addend(low, col_id)
            if addend is None:
                # Fresh pivot: (low, col_id) is a persistence pair.
                mc = int(adapter.min_cobdy(
                    np.array([col_id], dtype=np.int64))[0])
                owner = int(adapter.owner_of_low(
                    np.array([low], dtype=np.int64))[0])
                trivial = (mc == low) and (owner == col_id)
                gens = _parity_gens(gens_parity)
                store.commit(low, col_id, r, gens, trivial)
                b = float(adapter.birth_value(np.array([col_id], dtype=np.int64))[0])
                d = float(adapter.death_value(np.array([low], dtype=np.int64))[0])
                pairs.append((b, d, low, col_id))
                break
            # r <- r (+) R(owner); track V in parity dict (implicit bookkeeping)
            n_reductions += 1
            owner = int(self_owner_of(store, adapter, low))
            gens_parity[owner] = gens_parity.get(owner, 0) + 1
            for g in store_gens(store, low):
                gens_parity[int(g)] = gens_parity.get(int(g), 0) + 1
            r = merge_cancel(r, addend)

    reg = MetricsRegistry()
    reg.counter("n_columns").inc(n_columns_in)
    reg.counter("n_reductions").inc(n_reductions)
    reg.counter("n_pairs").inc(len(pairs))
    reg.counter("n_essential").inc(len(essentials))
    reg.gauge("stored_bytes").set(store.bytes_stored)
    reg.gauge("n_stored_columns").set(len(store.columns))
    reg.counter("n_spilled").inc(store.n_spilled)
    result = finalize_result(pairs, essentials, essential_ids, reg.as_stats())
    if return_store:
        return result, store
    return result


def self_owner_of(store: PivotStore, adapter: DimensionAdapter, low: int) -> int:
    """Column id that owns pivot ``low`` (committed or trivial)."""
    idx = store.low_to_idx.get(low)
    if idx is not None:
        return store.col_ids[idx]
    return int(adapter.owner_of_low(np.array([low], dtype=np.int64))[0])


def store_gens(store: PivotStore, low: int) -> np.ndarray:
    """δ-expansion V(owner) for implicit bookkeeping.

    Empty for trivial owners (R = δ·owner) and for explicit owners of a
    pure explicit run (nothing tracked, nothing ever needs it); the stored
    expansion otherwise — including explicit owners of a budgeted run,
    whose expansions later spilled columns depend on.
    """
    idx = store.low_to_idx.get(low)
    if idx is not None and store.gens_lists[idx] is not None:
        return store.gens_lists[idx]
    return np.zeros(0, dtype=np.int64)
