"""CPU probe of the distributed packed reduction; needs no card.

    PYTHONPATH=src python tools/dist_reduce_probe.py [dist] [profile] [full] [hic]

Each part prints one JSON line; with no argument all four run (about
20 minutes on one CPU core, ``full`` the most of them).  The numbers are
the host CPU's, never a device number.

* ``dist``    — torus4 at n = 10,000, tau 0.15, maxdim 1 through
  ``compute_ph(device="cpu", engine="packed")`` (the numpy block path) at
  P = 1 and at P = 4: ``t_h1``, supersteps, exchange rounds and bytes,
  sweep probes and the simulated P-device wall.
* ``profile`` — the same cloud's H1 reduction on the kernel path
  (``use_kernels=True``: the kernels' plain versions on the CPU), in
  ``compute_ph``'s batches of 128, at P = 1 and P = 4 under
  ``cProfile``: consolidations, expansions and evictions, the
  consolidations' cumulative seconds, the largest block, the reduction's
  seconds, and the kernel rounds with the most hit rows one of them
  handed the kernels.
* ``full``    — the same kernel-path reduction, without ``cProfile``, on
  the main path's cloud: torus4 at n = 50,000, tau from a 96 MiB budget
  (about 13 minutes).
* ``hic``     — the Hi-C pair at n = 25,000 (``hic_pair(25_000, 200,
  seed=1)``): the shared tau of ``estimate_tau_max`` at 128, 64 and 32 MiB
  and auxin's edge count at each.
"""
from __future__ import annotations

import cProfile
import json
import pstats
import sys

import numpy as np

from repro_torch import compute_ph
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core.packed_reduce import (_PackedBatch,
                                            reduce_dimension_packed)
from repro_torch.data.pointclouds import clifford_torus, hic_pair
from repro_torch.obs.trace import stopwatch
from repro_torch.scale import estimate_tau_max, harvest_edges
from repro_torch.scale.tiles import build_filtration_tiled

N, TAU = 10_000, 0.15
COUNTS = ("n_supersteps", "n_exchange_rounds", "exchange_bytes",
          "n_sweep_probes", "n_rounds", "sim_wall_s")


def dist() -> dict:
    points = clifford_torus(N, seed=0)
    out = {}
    for p in (1, 4):
        res = compute_ph(points=points, tau_max=TAU, maxdim=1,
                         backend="tiled", engine="packed", n_shards=p,
                         device="cpu")
        out[f"P{p}"] = dict(t_h1=res.stats["t_h1"],
                            **{k: res.stats[f"h1_{k}"] for k in COUNTS})
    return out


def kernel_path(points, tau: float, profiled: bool) -> dict:
    """H1 of ``points`` on the kernel path at P = 1 and P = 4, with the
    hit rows of every kernel round counted."""
    filt = build_filtration_tiled(points=points, tau_max=tau, device="cpu")
    cleared = compute_h0(filt).death_edges
    cols = np.arange(filt.n_e - 1, -1, -1, dtype=np.int64)
    real = _PackedBatch.xor_rows_kernels
    hits = []

    def counted(self, packed_hit, ridx, pos):
        hits.append(len(packed_hit))
        return real(self, packed_hit, ridx, pos)

    out = dict(n_e=int(filt.n_e))
    _PackedBatch.xor_rows_kernels = counted
    try:
        for p in (1, 4):
            hits.clear()
            prof = cProfile.Profile()
            with stopwatch("probe/kernel_path", shards=p) as sw:
                if profiled:
                    prof.enable()
                res = reduce_dimension_packed(
                    make_h1_adapter(filt, sparse=True), cols,
                    cleared=cleared, batch_size=128, n_shards=p,
                    use_kernels=True, device="cpu")
                prof.disable()
            st = res.stats
            row = dict(seconds=sw.elapsed, under_cprofile=profiled,
                       **{k: st[k] for k in ("n_consolidations",
                                             "n_expansions", "n_evictions",
                                             "n_rounds", "peak_block_bytes")},
                       kernel_rounds=len(hits),
                       max_hit_rows=max(hits, default=0))
            if profiled:
                cons = [v for k, v in pstats.Stats(prof).stats.items()
                        if k[2] == "consolidate"]
                row["consolidate_cum_s"] = sum(v[3] for v in cons)
            out[f"P{p}"] = row
    finally:
        _PackedBatch.xor_rows_kernels = real
    return out


def profile() -> dict:
    return kernel_path(clifford_torus(N, seed=0), TAU, profiled=True)


def full() -> dict:
    points = clifford_torus(50_000, seed=0)
    tau = estimate_tau_max(points, 96 * 2**20)
    return dict(tau_max=tau, **kernel_path(points, tau, profiled=False))


def hic() -> dict:
    control, auxin = hic_pair(25_000, n_loops=200, seed=1)
    out = {}
    for mib in (128, 64, 32):
        tau = min(estimate_tau_max(x, mib * 2**20) for x in (control, auxin))
        iu, _, _ = harvest_edges(points=auxin, tau_max=tau, tile_m=2048,
                                 tile_n=2048, backend="kernel", device="cpu")
        out[f"{mib}MiB"] = dict(tau_max=tau, auxin_n_e=int(iu.size))
    return out


PARTS = {"dist": dist, "profile": profile, "full": full, "hic": hic}


def main(argv) -> int:
    for name in argv or list(PARTS):
        print(json.dumps({"part": name, **PARTS[name]()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
