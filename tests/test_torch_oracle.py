"""The port's textbook oracle, on the CPU.

``repro_torch.core.ref`` (the textbook standard reduction) against the
reference's ``repro.core.ref`` on clouds of at most 10 points, and all three
port engines (single, batch, packed) against the port's oracle, as
``tests/test_ph_engine.py::test_engine_matches_oracle`` holds the
reference's engines.  Diagrams are compared exactly (``np.array_equal``
after canonical ordering; floats bit for bit).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import ref as ref_oracle
from repro_torch import compute_ph
from repro_torch.core import ref as oracle
from repro_torch.core.diagrams import canonicalize
from repro_torch.core.filtration import pairwise_distances


def random_cloud(seed, n=None, d=3):
    rng = np.random.default_rng(seed)
    n = n or int(rng.integers(6, 18))
    return rng.normal(size=(n, d))


def assert_diagrams_exact(got, want, dims=(0, 1, 2)):
    for d in dims:
        a, b = canonicalize(got[d]), canonicalize(want[d])
        assert a.shape == b.shape, (d, a, b)
        assert np.array_equal(a, b), (d, a, b)


@pytest.mark.parametrize("tau", [np.inf, 1.4])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_core_oracle_matches_reference(seed, tau):
    pts = random_cloud(seed, n=6 + seed)
    dists = pairwise_distances(pts)
    want_s = ref_oracle.vr_simplices(dists, tau, 2)
    got_s = oracle.vr_simplices(dists, tau, 2)
    assert got_s == want_s
    want = ref_oracle.standard_reduction_points(pts, tau_max=tau, maxdim=2)
    got = oracle.standard_reduction_points(pts, tau_max=tau, maxdim=2)
    assert got.keys() == want.keys()
    for d in want:
        assert got[d].dtype == want[d].dtype
        assert np.array_equal(got[d], want[d]), d
    assert np.array_equal(oracle.standard_reduction(dists, tau, 1)[1],
                          ref_oracle.standard_reduction(dists, tau, 1)[1])
    for t in (0.3, 0.8, 1.5):
        assert oracle.betti_numbers(dists, t) == \
            ref_oracle.betti_numbers(dists, t)


def test_core_oracle_on_ten_points():
    pts = random_cloud(9, n=10)
    want = ref_oracle.standard_reduction_points(pts, maxdim=2)
    got = oracle.standard_reduction_points(pts, maxdim=2)
    for d in want:
        assert np.array_equal(got[d], want[d]), d
    assert got[0].shape[0] == 10


def test_core_oracle_circle_betti():
    t = np.linspace(0, 2 * np.pi, 9, endpoint=False)
    pts = np.stack([np.cos(t), np.sin(t)], axis=1)
    b = oracle.betti_numbers(pairwise_distances(pts), 0.8)
    assert b == {0: 1, 1: 1, 2: 0}


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("engine", ["single", "batch", "packed"])
def test_engine_matches_oracle(engine, seed, sparse, mode):
    pts = random_cloud(seed)
    tau = np.inf if seed % 2 == 0 else 1.6
    want = oracle.standard_reduction_points(pts, tau_max=tau, maxdim=2)
    got = compute_ph(points=pts, tau_max=tau, maxdim=2, mode=mode,
                     sparse=sparse, engine=engine, batch_size=8,
                     device="cpu")
    assert_diagrams_exact(got.diagrams, want)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), nd=st.integers(2, 4),
       engine=st.sampled_from(["single", "batch", "packed"]))
def test_engine_matches_oracle_hypothesis(seed, nd, engine):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(int(rng.integers(5, 12)), nd))
    tau = float(rng.uniform(0.8, 2.5))
    want = oracle.standard_reduction_points(pts, tau_max=tau, maxdim=2)
    got = compute_ph(points=pts, tau_max=tau, maxdim=2, mode="implicit",
                     engine=engine, batch_size=4, device="cpu")
    assert_diagrams_exact(got.diagrams, want)
