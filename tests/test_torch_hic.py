"""The paper's Hi-C workload in the port, on the CPU.

Every point-cloud generator of ``repro_torch.data.pointclouds`` returns the
reference's array bit for bit at two seeds, and the Hi-C pair (control and
auxin, ``hic_pair(120, 8)``, maxdim 2) gives the JAX package's diagrams
through the port's packed and batch engines on the CPU
(``np.array_equal``).
"""
import numpy as np
import pytest

from repro.core import compute_ph as ref_compute_ph
from repro.data import pointclouds as ref_clouds
from repro_torch import compute_ph
from repro_torch.data import pointclouds

GENERATORS = [
    ("circle_points", dict(n=40, noise=0.05)),
    ("circle_points", dict(n=17)),
    ("sphere_points", dict(n=30)),
    ("clifford_torus", dict(n=50)),
    ("o3_points", dict(n=20)),
    ("dragon_like", dict(n=60)),
    ("fractal_like", dict(n=48)),
    ("genome_like", dict(n=200, n_loops=6)),
    ("genome_like", dict(n=150, n_loops=4, loop_strength=0.0)),
]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name,kw", GENERATORS)
def test_generator_matches_reference(name, kw, seed):
    want = getattr(ref_clouds, name)(seed=seed, **kw)
    got = getattr(pointclouds, name)(seed=seed, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_unseeded_generators_match_reference():
    for fn, kw in (("two_circles", dict(n=12, separation=4.0)),
                   ("two_circles", {}),
                   ("clifford_torus", dict(n=49, grid=True))):
        want = getattr(ref_clouds, fn)(**kw)
        got = getattr(pointclouds, fn)(**kw)
        assert np.array_equal(got, want), fn


@pytest.mark.parametrize("seed", [1, 4])
def test_hic_pair_matches_reference(seed):
    for a, b in zip(ref_clouds.hic_pair(300, 10, seed=seed),
                    pointclouds.hic_pair(300, 10, seed=seed)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("engine", ["packed", "batch"])
@pytest.mark.parametrize("condition", [0, 1])
def test_hic_pair_diagrams_match_reference(engine, condition):
    points = pointclouds.hic_pair(120, 8, seed=1)[condition]
    kw = dict(points=points, tau_max=0.5, maxdim=2, engine=engine,
              backend="tiled", tile_m=64, tile_n=64)
    ref = ref_compute_ph(**kw)
    mine = compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.diagrams[1].shape[0] > 0
    assert mine.stats["n_e"] == ref.stats["n_e"]
