"""COO/Hi-C input (``repro_torch.scale.sparse_input``) against the JAX
package and against the port's dense ``dists=`` build, on the CPU.

Every comparison is exact: arrays ``np.array_equal`` with equal dtypes,
floats bit for bit.  ``coo_symmetrize`` runs on random triplets with
duplicates, reversed pairs and diagonal entries, and raises the
reference's exception for each bad input; ``build_filtration_coo`` is
field-by-field the reference's and the dense build's; ``compute_ph`` on a
COO filtration gives the reference's diagrams for every engine.  Hypothesis
tests set ``deadline=None``.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import compute_ph as ref_compute_ph
from repro.scale import sparse_input as ref_sparse
from repro_torch import compute_ph
from repro_torch.core.filtration import build_filtration
from repro_torch.scale import (build_filtration_coo, contacts_to_distances,
                               coo_symmetrize)


def assert_filtrations_equal(ref, mine):
    a, b = dataclasses.asdict(ref), dataclasses.asdict(mine)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def triplets(seed, n=30, nnz=200):
    """Random COO triplets, each pair also given reversed, a duplicate of
    some pairs at a larger value, and diagonal entries."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    vals = rng.uniform(0.05, 3.0, size=nnz)
    dup = rng.choice(nnz, size=nnz // 4, replace=False)
    diag = rng.integers(0, n, size=5)
    rows = np.concatenate([rows, cols, rows[dup], diag])
    cols = np.concatenate([cols, rows[:nnz], cols[dup], diag])
    vals = np.concatenate([vals, vals, vals[dup] + 0.5,
                           rng.uniform(0, 1, size=5)])
    perm = rng.permutation(rows.size)
    return rows[perm], cols[perm], vals[perm], n


def dense_of(rows, cols, vals, n):
    """The materialized matrix: missing entries beyond any tau."""
    d = np.full((n, n), 1e18)
    np.fill_diagonal(d, 0.0)
    for i, j, v in zip(rows, cols, vals):
        if i != j:
            a, b = min(i, j), max(i, j)
            d[a, b] = d[b, a] = min(d[a, b], v)
    return d


@pytest.mark.parametrize("n_arg", [None, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_symmetrize_matches_reference(seed, n_arg):
    rows, cols, vals, _ = triplets(seed)
    want = ref_sparse.coo_symmetrize(rows, cols, vals, n=n_arg)
    got = coo_symmetrize(rows, cols, vals, n=n_arg)
    assert want[0] == got[0]
    for a, b in zip(want[1:], got[1:]):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)
    n, iu, ju, v = got
    assert (iu < ju).all()
    assert np.unique(iu * n + ju).size == iu.size


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 25),
       nnz=st.integers(0, 80))
def test_coo_symmetrize_hypothesis(seed, n, nnz):
    rows, cols, vals, n = triplets(seed, n=n, nnz=nnz)
    want = ref_sparse.coo_symmetrize(rows, cols, vals)
    got = coo_symmetrize(rows, cols, vals)
    assert want[0] == got[0]
    for a, b in zip(want[1:], got[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("args,match", [
    ((np.array([0, 1]), np.array([1]), np.array([0.5, 0.5])),
     "identical shapes"),
    ((np.array([0, -1]), np.array([1, 2]), np.array([0.5, 0.5])),
     "negative"),
    ((np.array([0, 5]), np.array([1, 2]), np.array([0.5, 0.5]), 3),
     "n >= 6"),
])
def test_coo_symmetrize_errors_match_reference(args, match):
    with pytest.raises(ValueError, match=match) as want:
        ref_sparse.coo_symmetrize(*args)
    with pytest.raises(ValueError, match=match) as got:
        coo_symmetrize(*args)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=match):
        build_filtration_coo(*args)


@pytest.mark.parametrize("dense_order", [False, True])
@pytest.mark.parametrize("tau", [0.5, 1.0, 2.5, np.inf])
@pytest.mark.parametrize("seed", [0, 3])
def test_build_filtration_coo_matches_reference_and_dense(seed, tau,
                                                          dense_order):
    rows, cols, vals, n = triplets(seed)
    want = ref_sparse.build_filtration_coo(rows, cols, vals, n=n,
                                           tau_max=tau,
                                           with_dense_order=dense_order)
    got = build_filtration_coo(rows, cols, vals, n=n, tau_max=tau,
                               with_dense_order=dense_order)
    assert_filtrations_equal(want, got)
    assert (got.dense_order is None) == (not dense_order)
    if np.isfinite(tau):
        dense = build_filtration(dists=dense_of(rows, cols, vals, n),
                                 tau_max=tau)
        for k in ("n", "n_e", "edges", "edge_len", "degree", "max_deg",
                  "nbr_vtx", "nbr_vtx_ord", "nbr_edge_ord", "nbr_edge_vtx"):
            np.testing.assert_array_equal(getattr(got, k), getattr(dense, k),
                                          err_msg=k)
        assert got.n_e > 0


def test_coo_inf_entries_never_become_edges():
    rows, cols = np.array([0, 1, 2]), np.array([1, 2, 3])
    vals = np.array([0.5, np.inf, 0.7])
    for build in (ref_sparse.build_filtration_coo, build_filtration_coo):
        filt = build(rows, cols, vals, n=4, tau_max=np.inf)
        assert filt.n_e == 2
        assert sorted(map(tuple, filt.edges.tolist())) == [(0, 1), (2, 3)]


@pytest.mark.parametrize("alpha,scale", [(-1.0, 1.0), (-0.5, 2.0),
                                         (-1.3, 0.7)])
def test_contacts_to_distances_matches_reference(alpha, scale):
    rng = np.random.default_rng(4)
    counts = rng.integers(-3, 40, size=(12, 12)).astype(np.float64)
    counts[0, :3] = [0.0, -1.0, 0.5]
    want = ref_sparse.contacts_to_distances(counts, alpha=alpha, scale=scale)
    got = contacts_to_distances(counts, alpha=alpha, scale=scale)
    assert want.dtype == got.dtype
    assert np.array_equal(want, got)
    assert np.isinf(got[counts <= 0]).all()
    assert np.isfinite(got[counts > 0]).all()


@pytest.mark.parametrize("engine", ["single", "batch", "packed"])
def test_compute_ph_on_coo_filtration_matches_reference(engine):
    """A Hi-C-like contact map: counts -> distances -> COO -> diagrams."""
    rng = np.random.default_rng(6)
    n, nnz = 24, 160
    rows = rng.integers(0, n, size=nnz)
    cols = rng.integers(0, n, size=nnz)
    counts = rng.integers(-2, 30, size=nnz).astype(np.float64)
    want_d = ref_sparse.contacts_to_distances(counts, alpha=-0.7)
    got_d = contacts_to_distances(counts, alpha=-0.7)
    ref_f = ref_sparse.build_filtration_coo(rows, cols, want_d, n=n,
                                            tau_max=0.6)
    my_f = build_filtration_coo(rows, cols, got_d, n=n, tau_max=0.6)
    ref = ref_compute_ph(filtration=ref_f, maxdim=2, engine=engine,
                         batch_size=8)
    mine = compute_ph(filtration=my_f, maxdim=2, engine=engine,
                      batch_size=8, device="cpu")
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.diagrams[1].shape[0] > 0
