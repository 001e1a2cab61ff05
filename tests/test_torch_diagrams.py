"""The public functions the ported host modules had lacked, against their
references on seeded inputs: the diagram summaries and TDA features
(``core/diagrams.py``), the paired-key accessors (``core/pairing.py``),
``min_tri_cobdy`` (``core/coboundary.py``) and ``Filtration.edge_order_of``
/ ``Filtration.diam_value`` (``core/filtration.py``).  Exact equality
throughout: each is host numpy, ported line for line."""
import numpy as np
import pytest

from repro.core import build_filtration as ref_build
from repro.core import coboundary as ref_cb
from repro.core import diagrams as ref_diagrams
from repro.core import pairing as ref_pairing
from repro_torch.core import build_filtration
from repro_torch.core import coboundary as cb
from repro_torch.core import diagrams
from repro_torch.core import pairing


def _diagram(seed, k=40, n_inf=3, n_zero=4):
    """A seeded diagram with finite pairs, essential classes and
    zero-persistence pairs, in no particular order."""
    rng = np.random.default_rng(seed)
    birth = rng.uniform(0.0, 1.0, size=k)
    death = birth + rng.exponential(0.2, size=k)
    death[:n_inf] = np.inf
    death[n_inf:n_inf + n_zero] = birth[n_inf:n_inf + n_zero]
    pd = np.stack([birth, death], axis=1)
    return pd[rng.permutation(k)]


DIAGRAMS = [_diagram(s) for s in range(4)] + [np.zeros((0, 2)),
                                              _diagram(9, k=1, n_inf=1,
                                                       n_zero=0)]


@pytest.mark.parametrize("pd", DIAGRAMS, ids=range(len(DIAGRAMS)))
def test_betti_curve(pd):
    taus = np.linspace(-0.1, 1.6, 57)
    want = ref_diagrams.betti_curve(pd, taus)
    got = diagrams.betti_curve(pd, taus)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("tau_cap", [np.inf, 0.7, 1.0])
@pytest.mark.parametrize("pd", DIAGRAMS, ids=range(len(DIAGRAMS)))
def test_total_persistence_and_summary(pd, tau_cap):
    assert diagrams.total_persistence(pd, tau_cap) \
        == ref_diagrams.total_persistence(pd, tau_cap)
    assert diagrams.summary(pd, tau_cap) == ref_diagrams.summary(pd, tau_cap)


@pytest.mark.parametrize("resolution,sigma,tau_cap", [(16, 0.1, 1.0),
                                                      (7, 0.05, 1.5)])
@pytest.mark.parametrize("pd", DIAGRAMS, ids=range(len(DIAGRAMS)))
def test_persistence_image(pd, resolution, sigma, tau_cap):
    want = ref_diagrams.persistence_image(pd, resolution, sigma, tau_cap)
    got = diagrams.persistence_image(pd, resolution, sigma, tau_cap)
    assert got.shape == want.shape == (resolution, resolution)
    assert np.array_equal(got, want)


def test_primary_secondary():
    rng = np.random.default_rng(3)
    kp = rng.integers(0, 2**31 - 1, size=200)
    ks = rng.integers(0, 2**32 - 1, size=200)
    keys = ref_pairing.pack_np(kp, ks)
    for fn in ("primary", "secondary"):
        want = getattr(ref_pairing, fn)(keys)
        got = getattr(pairing, fn)(keys)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)
    assert np.array_equal(pairing.primary(keys), kp)
    assert np.array_equal(pairing.secondary(keys), ks)
    assert int(pairing.primary(int(keys[0]))) == int(kp[0])


def _filtrations(seed, n=18):
    pts = np.random.default_rng(seed).normal(size=(n, 3))
    return ref_build(points=pts, tau_max=2.0), build_filtration(
        points=pts, tau_max=2.0)


def _triangles(filt):
    """Every triangle key of the filtration (case-1 enumeration)."""
    groups = ref_cb.case1_triangles_of_edges(
        filt, np.arange(filt.n_e, dtype=np.int64), sparse=True)
    return np.concatenate([g for g in groups if g.size])


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_min_tri_cobdy(seed, sparse):
    rf, tf = _filtrations(seed)
    tris = _triangles(rf)
    assert tris.size > 10
    want = ref_cb.min_tri_cobdy(rf, tris, sparse=sparse)
    got = cb.min_tri_cobdy(tf, tris, sparse=sparse)
    assert np.array_equal(got, want)
    assert np.array_equal(cb.min_tri_cobdy(tf, tris[0], sparse=sparse),
                          ref_cb.min_tri_cobdy(rf, tris[0], sparse=sparse))


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_order_of_and_diam_value(seed):
    rf, tf = _filtrations(seed)
    for a in range(rf.n):
        for b in range(rf.n):
            assert tf.edge_order_of(a, b) == rf.edge_order_of(a, b)
    kp = np.arange(rf.n_e, dtype=np.int64)[::-1]
    assert np.array_equal(tf.diam_value(kp), rf.diam_value(kp))
    assert tf.diam_value(3) == rf.diam_value(3)
