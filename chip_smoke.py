"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs one card; no arguments

Phases, one JSON line each, in this order (serving first: after the PH
paths' long profiles, a short profiled serving epoch has lost one of its
28 flash launches from the profile, in two runs of three):

1. ``device``   — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions.
2. ``build``    — nvcc builds the port's kernels from ``src/repro_torch/
   kernels/csrc`` (at first use, all sources in parallel); the ``-Xptxas
   -v`` report of each, and the float32 flash library's SASS
   (``cuobjdump -sass``): no matrix-multiply opcode (``HMMA``, ``HGMMA``,
   ...) and no spill in any of its instantiations.
3. ``kernels``  — every kernel against its plain PyTorch version on the
   card at the main path's shapes (GF(2) exact; pairwise within
   ``atol = 1e-4 * max(1, max |x|^2)``, ``rtol = 1e-5``).  Each is timed
   two ways: device time from ``torch.profiler`` (the kernel alone; all
   kernels and copies of the plain version and of one PyTorch library call
   where one computes the same function), and the per-call time of
   back-to-back calls between CUDA events, which includes the host's
   dispatch.  Beside them, the least time the card could take.
   ``gf2_find_low`` runs on whole blocks, on a segment's window of a wider
   block and on an unaligned view; ``gf2_scatter_xor`` at 11 % of a
   block's bits, with and without repeated coordinates, beside the dense
   ``gf2_parallel_xor`` (kept off the path).  A sweep of the serial kernel
   over its number of dependent XORs follows, at 128 x 256, 128 x 2176 and
   128 x 896 words (``serial_reduce_sweep``: the block in one thread
   block's shared memory; clusters of five and two), then every route
   ``serial_plan`` can choose
   (one block's shared memory, clusters of 2, 5, 8 and 16, the global
   route; G = 2), each exact against the plain version and timed
   (``kernels_serial_routes``).
4. ``serve``    — token serving at the full width of qwen3-0.6b
   (``repro_torch.serve.engine.ServeEngine``, seeded random weights): 16
   requests of 1024–2048 prompt tokens and 32 new tokens through 8 slots
   (two prefill epochs of 8 x 2048 tokens, 2 x 32 decode steps).  The flash
   kernel must launch during the run.  One more epoch (a prefill and 8
   decode steps) runs under ``torch.profiler`` for the card's busy and idle
   share; each of its flash launches must be the tensor-core kernel, one a
   layer (28 a prefill).  Then one epoch's prefill runs twice, through the
   flash kernel as served and through ``_sdpa_masked`` (the same batch with
   its ``arange`` positions passed explicitly, which the model sends
   there), and the logits must agree within ``3e-2 * max(1, max
   |logits|)``.
5. ``serve_f32`` — one serving epoch of full-width qwen3-0.6b computing in
   float32 (``compute_dtype="float32"``, seeded random weights): 8 requests
   of 1,024–2,048 prompt tokens, one prefill (8 x 2048 tokens) and one
   decode step, under ``torch.profiler``; its 28 flash launches must all be the
   float32 SIMT kernel.  Then that epoch's prefill through the flash kernel
   and through ``_sdpa_masked``, timed; the logits must agree within
   ``1e-3 * max(1, max |logits|)``.
6. ``train``    — training on the card through ``repro_torch.launch.train``
   (the counts set to 0 just before ``run``): full-width qwen3-0.6b
   (seeded random weights, float32 parameters, bf16 compute), 10 steps
   of 8 x 1,024 tokens in 4 microbatches (at 2 the peak passed 60 GB),
   every step logged; each step's
   loss, gradient norm and lr, the median step seconds after step 0,
   tokens/s and the peak device memory; ``tda_monitor`` at step 0, whose
   forward runs under ``torch.no_grad()`` through the bf16 flash kernel
   (one launch a layer, 28).  One more step under ``torch.profiler`` (CUDA
   activity only): the card's busy share, device seconds by kind of
   operation and its five longest device operations
   (``train_profiled_step``).  The full-width state (float32 parameters,
   m and v) through the checkpointer: ``save_async``, one step while its
   thread writes, ``save``, a verified ``restore``, every leaf equal bit
   for bit, the seconds and bytes of each part (``train_checkpoint``).
   One step of the same model in float32 compute (TF32 off) on 1 x 65
   tokens on the card and on the CPU from the card's weights: loss and
   gradient norm within 1e-4 relative, the updated weights as
   ``TRAIN_*_TOL`` states (``train_card_vs_cpu``).  Then
   ``examples/train_lm.py``'s run (reduced qwen3, 300 steps of 16 x 64,
   checkpoints every 100): its gate ``final < first - 0.5``, and
   ``run(restore=True)`` to 310 steps resuming at step 300
   (``train_learning``).  The phase frees its memory before the PH
   phases.
6b. ``lm_archs`` — the four architectures of the MoE/MLA slice at their
   published widths and depths through ``ServeEngine`` (seeded random
   weights, bf16 compute), one after another, each freed before the
   next and the counts set to 0 just before its ``run``: granite-moe-
   1b-a400m (float32 parameters) and, with ``param_dtype="bfloat16"``,
   deepseek-v2-lite-16b and glm4-9b, each 16 requests of 1,024-2,048
   prompt tokens through 8 slots (two epochs, the second warm), and
   granite-34b, 4 requests of 256-512 through 2 slots (its 67.9 GB of
   weights leave about 15 GiB), 16 new tokens each.  Each prints its
   parameter and cache bytes (MLA's latent cache, ``(r + d_rope)`` a
   layer, slot and position), peak bytes, prefill s, decode ms and
   tokens/s; its flash launches must equal ``n_layers`` a prefill
   (deepseek's at d = 192, the values zero-padded) and the engine's cache
   the formula's bytes.  One more epoch, a prefill and one decode step,
   runs under ``torch.profiler`` (every flash launch the tensor-core
   kernel; busy shares, the longest kernels).  Each model's first epoch
   prefill also runs through ``_sdpa_masked``, its logits within
   ``SERVE_CONTRACT`` of the flash route's; on granite-moe
   ``sample_temperature`` draws twice from one seed (equal) and at ``T =
   1e-7`` (equal to greedy).
6c. ``train_moe`` — ``repro_torch.launch.train`` on full-width
   granite-moe-1b-a400m (float32 parameters, bf16 compute), 4 steps of
   8 x 1,024 tokens in 4 microbatches, ``tda_monitor`` at step 0, the
   counts set to 0 just before ``run``: step s, tokens/s, peak bytes,
   losses and gradient norms finite, the MoE aux loss > 0 every step,
   one flash launch a layer (the monitor), the peak under 60 GB; one
   more step under ``torch.profiler`` (``train_moe_profiled_step``).
   Then one step of its reduced copy (float32, 4 x 65 tokens, 2 microbatches)
   on the card and on the CPU under ``train_card_vs_cpu``'s gates
   (``train_moe_card_vs_cpu``).
7. ``main_path`` — ``repro_torch.compute_ph`` on torus4 at n = 50,000 with
   a 96 MiB budget and 2048 x 2048 tiles (``backend="tiled"``,
   ``engine="packed"``); the launch count of every kernel of the path
   during that call must be > 0 (``gf2_parallel_xor``'s is reported: 0),
   and the harvest must be identical to a second harvest of the same cloud
   through the plain pairwise version on the card.  The call runs under
   ``torch.profiler``, for the card's busy and idle share and each
   kernel's device time on the path.  A wrapper around the kernel branch
   of the parallel phase (``_PackedBatch.xor_rows_kernels``) times every
   round and keeps the first 200 with the state they met; a wrapper around
   the serial pre-pass's ``gf2_serial_reduce`` keeps a host copy of each
   input.  The copies are timed (``round_capture_s``,
   ``serial_capture_s``) and the wall is reported with and without them.
   ``serial_replay`` (after ``cross_check``) — each captured serial input
   again through the kernel and the plain version, exactly equal, with each
   launch's shape, reductions, route, ranks, device µs (queued behind a
   ``torch.cuda._sleep`` between CUDA events) and per-call µs.
   ``round_step`` — the parallel-phase round, old form (a host-built
   dense addend block, the dense kernel, a padded find-low round trip per
   segment; ``old_step`` here) against the new, on copies of the same
   state with equal results: at 128 x 128 and 128 x 2048 words (8 repeats)
   and on the 200 captured rounds.  The new form's summed time must not
   exceed the old's in any of the three.
8. ``cross_check`` — torus4 (n = 10,000, maxdim 1) and o3 (n = 1,024,
   maxdim 2) on the card with the kernels and on the CPU: identical
   filtration arrays and diagrams.
9. ``mesh_path`` — ``compute_ph(maxdim=0)`` over a 4-entry data mesh of
   the card (``make_data_mesh(4, devices=["cuda:0"] * 4)``): the main
   path's cloud, tiles and 96 MiB budget at the main path's tau (the
   per-device reading of the budget would pick a larger one), under
   ``torch.profiler``, the counts set to 0 just before it.  The sharded
   harvest gives each entry one tile a round on its own CUDA stream.  Its
   filtration's ``edges`` and ``edge_len`` and its H0 diagram must equal
   ``main_path``'s and ``pairwise_sq_dists`` must launch once a tile
   (325).  It prints the wall and phase split, the harvest's tiles, rounds
   and per-round transfer (``gather_bytes``), the card's busy and idle
   share and each kernel's launches.  Cut to maxdim 0 to make room for
   phases 13 to 15: its H1 over the mesh repeated the main path's whole
   host-bound reduction (``t_h1`` 274 s, with a split equal to the
   loop-back's number for number) and stays held at n = 10,000 by
   ``dist_path``'s mesh run and by ``tests/test_torch_cuda.py``.
10. ``dist_path`` — the distributed reduction at ``cross_check``'s torus4
   cloud (n = 10,000 at its tau, P = 4, ``exchange_every=4``), twice under
   ``torch.profiler``: over the host loop-back (``n_shards=4``) and over
   the 4-entry mesh.  Diagrams and every split counter must be equal
   between the two, the diagrams equal to the cloud's P = 1 card result;
   ``gf2_find_low`` and ``gf2_scatter_xor`` must launch
   (``gf2_serial_reduce`` runs only in a superstep that holds one slice:
   its launches are printed, not gated) and an exchange round happen.
   One line each: wall and phase split, the split counters, ``sim_*``,
   idle share, launches and the most hit rows one round handed the
   kernels.
11. ``dist_check`` — ``cross_check``'s o3 cloud (maxdim 2) through the
   distributed reduction on the card at P = 3, implicit,
   ``exchange_every=4``, equal to its P = 1 card diagrams.  (Its torus4
   runs at P 2 and 4 left to make room for ``serve_ph``: ``dist_path``
   runs that cloud at P = 4 over both transports, and the card test
   ``test_compute_ph_dist_card_matches_cpu`` holds P in {2, 4} x cadence.)
12. ``serve_ph`` — the PH service, ``repro_torch.serve.PHServeEngine``
   (packed engine, a 4 MiB admission account, 256 MiB of tenant cache, 8
   clouds a batch) on the card, in the shape of the reference launcher's
   ``run_ph`` traffic, under ``torch.profiler`` with the counts set to 0
   just before it: a cold wave of 8 clouds of 1,500 points
   (``rng.normal``, seed 0) at the 0.5 % quantile of pair lengths
   (``sample_pair_lengths``, seed 0), served as one union batch; an
   update wave of 8 requests alternating tau growth to 1.5x and the
   arrival of 64 points, each on its own cached cloud and served warm;
   one request at 3x tau that admission clamps to the account and serves
   warm at the granted tau.  Every request at maxdim 1 (the service's
   default 2, cut for time).  Every response's path must be the planned
   one; the 9 warm responses and 2 of the cold wave must equal (H0, H1) a
   cold ``compute_ph`` on the card at the granted tau; ``gf2_find_low``
   and ``gf2_scatter_xor`` must launch.  A checkpoint saved and reloaded
   keeps its ``content_hash``; under a ``resume.load`` bit flip the
   reload raises ``CheckpointCorruption`` and a cold reduction through
   the engine's reducer gives the cached diagrams.  It prints the walls
   of both waves and the clamped request, requests/s, the cache-hit
   ratio, each ``serve_ph_*`` counter, p50 and p95 latency, each
   kernel's launches and the card's idle share.
13. ``resilience`` — ``dist_path``'s loop-back run (torus4, n = 10,000,
   P = 4, ``exchange_every=4``) under one seeded fault plan, the counts
   set to 0 just before it: a shard killed at the start of superstep 2
   and one mid-superstep 4, a slow shard at superstep 3, a payload dropped
   twice in exchange round 1, one corrupted in round 2 and one delayed in
   round 3, and tile 3 of the harvest failing once.  Every spec must
   fire; the filtration must equal an unfaulted harvest on the card and
   the diagrams ``dist_path``'s loop-back diagrams; 2 shard deaths, 1 wire
   corruption, 1 tile retry, at least 2 re-deals; find-low and
   scatter-XOR must launch.  ``kill_shard`` over the 4-entry mesh must
   raise ``ValueError`` at the first superstep, before any GF(2) launch.
   It prints every ``resilience_*`` counter and ``t_h1`` beside
   ``dist_path``'s.
14. ``sanitize`` — ``cross_check``'s o3 cloud through ``compute_ph(...,
   engine="packed", sanitize=True)`` on the card at P = 1 and at P = 3
   (``dist_check``'s run): diagrams equal ``cross_check``'s card result,
   ``sanitize_checks`` > 0; the checks by name, each wall beside the
   unsanitized one.
15. ``device_engine`` — the torch device engine
   (``repro_torch.core.device_engine``): ``h0_msf_mask`` on the main
   path's filtration on the card must mark exactly the main path's
   union-find death edges; one ``make_distributed_round`` over the
   4-entry mesh of the card at ``launch/dryrun.py``'s ``ph_round_64k``
   shape (256 columns an entry, width 64, 2^20 pivots, from a seed) must
   be bit-identical to the same call on a ``cpu x 4`` mesh.  The walls
   and the number of Borůvka rounds.
16. ``hic_suite`` — the Hi-C pair that ``benchmarks/fig21_hic.py`` runs,
    at ``benchmarks/suite.py``'s scale 1.0 (``hic_pair(350, 24, seed=1)``,
    tau 0.6, maxdim 2), on the card, one call after another: each condition
    through the batch engine and the packed engine on the tiled harvest, and
    the control also through the packed engine over ``build_filtration_coo``
    of the card's harvest (every pair also reversed, a duplicate at a larger
    value, diagonal entries).  Every diagram ``np.array_equal`` to the batch
    engine's; each run's wall and launches; the Fig. 21 table (H1 and H2
    features with persistence above 0.02, 0.05 and 0.08, auxin against
    control); H1 at 0.05 and 0.08 must fall under auxin, as
    ``fig21_hic.py`` gates it.
17. ``hic_path`` — the regime ``examples/genome_hic.py`` documents
    (50,000 loci, a 128 MiB budget), cut to fit the run's time limit: half
    its loci and a quarter of its budget, ``hic_pair(25_000, 200,
    seed=1)`` at 32 MiB, one ``tau_max`` for both conditions (the smaller
    of ``estimate_tau_max`` at 32 MiB of each, about 0.030).  The cut takes
    auxin from about 2.4 M edges to 0.59 M, a quarter of the regime's
    work.  Each condition
    through ``compute_ph(maxdim=1, engine="packed", backend="tiled")`` at
    2048 x 2048 tiles under ``torch.profiler``, with the counts set to 0
    just before it: n_e, the synchronised wall, the phase split, the card's
    busy and idle share, each PH kernel's launches (all four must launch on
    auxin) and device seconds and the H1 classes above each Fig. 21 threshold,
    finite deaths and essential classes apart (no gate on direction: at a
    tau near 0.03 a class of persistence above 0.05 can only be essential).
    The auxin harvest must equal a harvest through the plain pairwise
    version, and its serial pre-pass inputs replay exactly through the
    kernel and the plain version (``hic_serial_replay``).  The control's
    card harvest, as COO triplets, must build a filtration equal field by
    field to ``build_filtration_tiled`` on the card.
18. ``analyze`` — the static correctness gates of ``python -m
    repro_torch.analyze`` on the card: the port's lint over the checkout
    (no unjustified finding; the counts by rule), then
    ``collectives.check_repo(device=...)``, every registered mesh round
    function over the 4-entry mesh of the card, with no violation and
    each schedule equal to the registry's and to the ``cpu x 4`` run's.
    With the counts set to 0 just before it, the candidate round
    (``scale.shard._candidate_round_fn``) must launch
    ``pairwise_sq_dists`` once an entry (4) and give the ``cpu x 4`` run's
    candidate lists; the exchange round must gather the uneven wire
    buffer bit for bit (``Mesh``'s ``all_gather``), and the exchange over
    the card mesh must return the loop-back's payloads.

Phase 3 holds the flash kernel against its plain version (``rtol = atol =
2e-4`` in float32, ``1e-2`` in bfloat16: see ``FLASH_BF16_TOL``) at the
serving prefill's shape and at gemma3-1b's local layers (bfloat16: the
tensor-core kernel of ``flash_attention_sm90.cu``; float32: the SIMT kernel
of ``flash_attention.cu``), with ``scaled_dot_product_attention`` as the
library yardstick, then in both dtypes on ragged, short, non-causal,
narrow-window, narrow-head, wide-head and single-head cases for
correctness alone (``FLASH_BF16_EDGES``, ``FLASH_F32_EDGES``).  Each timed case
reports its TFLOP/s and its share of the bound.  The serving prefill's
head expansion and layout copies around the kernel (``_flash_prefill``)
are timed beside it.

Then the ``nvidia-smi`` line, the kernels summary (each kernel's
launches on the main path, the Hi-C path, ``dist_path``'s loop-back,
``mesh_path``, ``serve_ph``, ``resilience``, the training run, each
``lm_archs`` architecture and ``train_moe``) and, last, ``{"ok": true,
"device": ...}``.  Any failed
check raises and the script exits non-zero; without a card it exits 2,
and without ``src/repro_torch`` beside it (the script copied alone) it
exits 1, printing no result either way.  It imports nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12        # float32 / 32-bit ops outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # bf16 dense tensor cores
MAIN_PATH_N = 50_000         # torus4 points, benchmarks/table1_datasets.py
# The bfloat16 flash kernel rounds the probabilities to bfloat16 for P.V,
# where its plain version keeps them in float32; both round the output
# once.  tests/test_torch_flash_numerics.py emulates that arithmetic on the
# CPU and finds it inside 1e-2, which stays below a typical |o| at the
# serving shape (unit-normal inputs give outputs of standard deviation about
# sqrt(e / S), some 0.04 at S = 1024), as the 3e-2 of tests/test_kernels.py
# does not.
FLASH_BF16_TOL = 1e-2
FLASH_F32_TOL = 2e-4
# The float32 kernel sums in another order than its plain version and
# nothing else: at the two timed shapes its largest error is held to 1e-5.
FLASH_F32_MAX_ERR = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
CSRC = "src/repro_torch/kernels/csrc"


def emit(phase: str, **fields) -> None:
    """One JSON line; ``elapsed_s`` is the script's seconds so far, which
    says where the run's time limit goes."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wall_ms(fn, iters: int) -> float:
    """Mean time of one call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events after one warm-up call.  For a small kernel this is
    the host's dispatch rate (Python, ctypes, allocation), not the kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean device time per call of ``fn`` without the profiler: the stream
    is held by a ``torch.cuda._sleep`` of about 2 ms while the host
    enqueues ``iters`` calls, then CUDA events time them back to back (the
    gaps between launches included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def clocks_under(fn, seconds: float = 2.0) -> dict:
    """The card's SM clock (MHz) and power draw (W), sampled by
    ``nvidia-smi`` every 100 ms while ``fn`` runs back to back for about
    ``seconds``: the medians, and the number of samples."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    clocks, watts = [], []
    for ln in out.splitlines():
        try:
            mhz, w = (float(x) for x in ln.split(","))
        except ValueError:
            continue
        clocks.append(mhz)
        watts.append(w)
    return dict(samples=len(clocks),
                sm_mhz_median=float(np.median(clocks)) if clocks else None,
                power_w_median=float(np.median(watts)) if watts else None)


def profiled(fn, host: bool = True):
    """Run ``fn`` under ``torch.profiler`` (host and CUDA activity, or the
    CUDA activity alone without ``host``); return its result and the
    device-side events (kernels, copies, memsets)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, device_events(prof.events())


def device_events(evs, annotations=()):
    """The device-side events (kernels, copies, memsets) of a profile,
    without the device-lane copies of ``record_function`` ranges (named in
    ``annotations``), which span a whole annotated region and are no device
    work."""
    from torch.autograd import DeviceType

    return [ev for ev in evs if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name not in annotations]


def device_ms(fn, iters: int, kernel: Optional[str] = None):
    """Mean device time per call of ``fn``: the profiler's CUDA activity
    over ``iters`` calls after a warm-up, summed over every kernel and copy;
    or, where ``kernel`` names one, the mean of that kernel's launches
    (at most one a call; the profiler may miss one).  None where the
    profiler records no device activity."""
    fn()
    torch.cuda.synchronize()
    _, evs = profiled(lambda: [fn() for _ in range(iters)])
    per = iters
    if kernel is not None:
        evs = [ev for ev in evs if kernel in ev.name]
        if len(evs) > iters:
            raise AssertionError(f"{kernel}: {len(evs)} launches profiled "
                                 f"in {iters} calls")
        per = len(evs)
    if not evs:
        return None
    return sum(ev.time_range.elapsed_us() for ev in evs) / per / 1e3


def busy_us(evs) -> float:
    """Length of the union of the events' device intervals (µs)."""
    total, end = 0.0, -np.inf
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in evs):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def timings(kernel: str, fn, plain, library, iters: int,
            plain_iters: int) -> dict:
    """The kernel's device time alone and its wrapper's per-call time, the
    plain version's and the library call's device time per call (all their
    kernels and copies) and their per-call times."""
    out = dict(kernel_ms=device_ms(fn, iters, kernel),
               wrapper_ms=wall_ms(fn, iters),
               plain_ms=device_ms(plain, plain_iters),
               plain_wall_ms=wall_ms(plain, plain_iters),
               library_ms=None, library_wall_ms=None)
    if library is not None:
        out.update(library_ms=device_ms(library, iters),
                   library_wall_ms=wall_ms(library, iters))
    return out


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """Least time (ms) for the work, and which of bytes/operations sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def sparse_rows(rng, c: int, w: int) -> np.ndarray:
    """Bit rows whose first set word lies anywhere in the row, some empty."""
    rows = (rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
            & rng.integers(0, 2**32, size=(c, w), dtype=np.uint32))
    first = rng.integers(0, w, size=c)
    rows[np.arange(w)[None, :] < first[:, None]] = 0
    rows[::9] = 0
    return rows


def serial_block(rng, c: int, cap: int, planted: int = 16,
                 w: Optional[int] = None) -> np.ndarray:
    """The packed engine's serial pre-pass input: R words whose lows spread
    over the row, ``planted`` rows planted onto an earlier row's low (a
    batch's intra-block collisions), V identity words at the tail, padded
    to a multiple of 128 words (to ``w`` words where given)."""
    vw = (c + 31) // 32
    if w is None:
        w = -(-(cap + vw) // 128) * 128
    blk = np.zeros((c, w), dtype=np.uint32)
    r = sparse_rows(rng, c, cap)
    rows = np.arange(c)
    first = rng.integers(0, cap, size=c)
    r[np.arange(cap)[None, :] < first[:, None]] = 0
    r[rows, first] |= np.uint32(1) << rng.integers(0, 32, size=c).astype(
        np.uint32)
    for i in rng.choice(np.arange(1, c), size=planted, replace=False):
        j = int(rng.integers(0, i))
        r[i, :first[j] + 1] = r[j, :first[j] + 1]
    blk[:, :cap] = r
    blk[rows, cap + (rows >> 5)] = np.uint32(1) << (rows & 31).astype(
        np.uint32)
    return blk


SERIAL_SYMBOL = "gf2_serial_reduce_kernel"
# Every route of the serial kernel, once each against the plain version:
# (G, C, W); serial_plan picks the shared-memory block, clusters of 5, 2, 8
# and 16 ranks and the global route from them.
SERIAL_ROUTE_CASES = ((1, 128, 256), (1, 128, 2176), (1, 128, 600),
                      (1, 128, 3500), (1, 128, 7000), (1, 128, 8000),
                      (2, 128, 2176), (2, 45, 8003))


def serial_bound(c: int, w: int, n_red: int, g: int = 1):
    """The serial kernel's least time: the blocks read and written once,
    lows and counts written; one word operation a word scanned and a word
    of each XOR."""
    return bound(g * (2 * c * w * 4.0 + c * 4.0 + 4.0),
                 g * c * w + n_red * w)


def serial_held(t, what: str) -> dict:
    """The kernel against the plain version on the same blocks, exactly:
    block, lows and counts.  Returns the counts and the plan."""
    from repro_torch.kernels import gf2

    got = gf2.gf2_serial_reduce(t)
    want = gf2.gf2_serial_reduce_plain(t)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"gf2_serial_reduce differs from its plain "
                             f"version: {what}")
    _, c, w = t.shape
    return dict(n_reductions=int(want[2].sum()), plan=gf2.serial_plan(c, w))


def serial_routes(dev) -> None:
    """Each case of SERIAL_ROUTE_CASES exact against the plain version and
    timed (the kernel's device time); every route must have launched."""
    from repro_torch.kernels import gf2

    rng = np.random.default_rng(7)
    routes = set()
    for g, c, w in SERIAL_ROUTE_CASES:
        vw = (c + 31) // 32
        blk = np.stack([serial_block(rng, c, w - vw, c // 4, w)
                        for _ in range(g)])
        t = gf2.to_tensor(blk, dev)
        held = serial_held(t, f"{g}x{c}x{w}")
        plan = held["plan"]
        ms = device_ms(lambda: gf2.gf2_serial_reduce(t), 20, SERIAL_SYMBOL)
        b_ms, b_by = serial_bound(c, w, held["n_reductions"], g)
        routes.add(plan.route)
        emit("kernels_serial_routes", shape=[g, c, w], route=plan.route,
             k=plan.k, slice_words=plan.S, threads=plan.threads,
             smem_bytes=plan.smem_bytes, n_reductions=held["n_reductions"],
             exact=True, kernel_ms=ms, bound_ms=b_ms, bound_by=b_by)
    if routes != {"smem", "cluster", "global"}:
        raise AssertionError(f"serial routes launched: {sorted(routes)}")


# gf2_find_low's phase-3 cases: (rows, words, view).  "whole" is a block of
# its own; "window" reads words 2,176 .. 4,351 of a 128 x 4,352 block (a
# segment's window, no copy); "unaligned" starts one word past a 16-byte
# boundary, which takes the kernel's word-load variant.
FIND_LOW_CASES = ((128, 128, "whole"), (128, 1024, "whole"),
                  (128, 2048, "whole"), (128, 2176, "window"),
                  (128, 2048, "unaligned"))
# Addend bits per block bit in the scatter-XOR cases, about what a dense
# round of the packed engine carries.
SCATTER_DENSITY = 0.11


def find_low_case(dev, rng, c: int, w: int, view: str) -> dict:
    """gf2_find_low against its plain version on one view, timed, with its
    bound: the words up to each row's low read once, the lows written."""
    from repro_torch.kernels import gf2

    cols = sparse_rows(rng, c, w)
    if view == "whole":
        t = gf2.to_tensor(cols, dev)
    elif view == "window":
        wide = np.zeros((c, 2 * w), dtype=np.uint32)
        wide[:, :w] = 0xFFFFFFFF              # words the window excludes
        wide[:, w:] = cols
        t = gf2.to_tensor(wide, dev)[:, w:]
    else:
        t = gf2.to_tensor(np.concatenate(
            [np.zeros(1, np.uint32), cols.reshape(-1)]), dev)[1:].view(c, w)
    got = gf2.gf2_find_low(t)
    want = gf2.gf2_find_low_plain(t)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and np.array_equal(
            got.cpu().numpy(), gf2.find_low_np(cols))):
        raise AssertionError(f"gf2_find_low differs at {c}x{w} {view}")
    nzw = cols != 0
    scanned = np.where(nzw.any(1), nzw.argmax(1) + 1, w).sum()
    b_ms, b_by = bound(scanned * 4.0 + c * 4.0, scanned)
    t_ = timings("gf2_find_low_kernel", lambda: gf2.gf2_find_low(t),
                 lambda: gf2.gf2_find_low_plain(t), None, 200, 50)
    return dict(name="gf2_find_low", shape=[c, w], view=view,
                row_stride=int(t.stride(0)),
                aligned=int(t.data_ptr() % 16 == 0), max_abs_err=0.0,
                exact=True, **t_, bound_ms=b_ms, bound_by=b_by,
                bound_share=(b_ms / t_["kernel_ms"]) if t_["kernel_ms"]
                else None)


def scatter_xor_case(dev, rng, c: int, w: int, repeat: bool) -> dict:
    """gf2_scatter_xor against its plain version, at SCATTER_DENSITY of the
    block's bits (with ``repeat``, a third of the coordinates again), timed
    with its coordinates on the host, where the wrapper range-checks and
    stages them, beside torch.bitwise_xor on a dense addend block built
    beforehand.  Bound: the coordinates read once, each
    touched word read and written once."""
    from repro_torch.kernels import gf2

    n_bits = c * w * 32
    flat = rng.choice(n_bits, size=int(SCATTER_DENSITY * n_bits),
                      replace=False)
    if repeat:
        flat = np.concatenate([flat, flat[::3]])
        rng.shuffle(flat)
    rows = rng.integers(0, 2**32, size=(c, w), dtype=np.uint32)
    idx_host = torch.from_numpy(flat.astype(np.int64))
    idx_dev = idx_host.to(dev, torch.int32)
    t = gf2.to_tensor(rows, dev)
    want = gf2.gf2_scatter_xor_plain(t.clone(), idx_dev)
    got = gf2.gf2_scatter_xor(t.clone(), idx_host)
    u, counts = np.unique(flat, return_counts=True)
    u = u[counts % 2 == 1]
    host = rows.copy()
    gf2.scatter_xor_bits(host, u // (w * 32), u % (w * 32))
    torch.cuda.synchronize()
    if not (torch.equal(got, want)
            and np.array_equal(gf2.to_numpy(got), host)):
        raise AssertionError(f"gf2_scatter_xor differs at {c}x{w}, "
                             f"repeat={repeat}")
    dense = gf2.to_tensor(host ^ rows, dev)
    touched = np.unique(flat >> 5).size
    b_ms, b_by = bound(flat.size * 4.0 + touched * 8.0, flat.size)
    scratch = t.clone()
    t_ = timings("gf2_scatter_xor_kernel",
                 lambda: gf2.gf2_scatter_xor(scratch, idx_host),
                 lambda: gf2.gf2_scatter_xor_plain(scratch, idx_dev),
                 lambda: torch.bitwise_xor(t, dense), 200, 20)
    return dict(name="gf2_scatter_xor", shape=[c, w], repeat=repeat,
                coords=int(flat.size), touched_words=int(touched),
                max_abs_err=0.0, exact=True, **t_,
                library="torch.bitwise_xor on a pre-built dense addend block",
                bound_ms=b_ms, bound_by=b_by,
                bound_share=(b_ms / t_["kernel_ms"]) if t_["kernel_ms"]
                else None)


def check_kernels(dev) -> dict:
    from repro_torch.kernels import gf2
    from repro_torch.kernels.pairwise_dist import (pairwise_sq_dists,
                                                   pairwise_sq_dists_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    summary = {}

    for d in (4, 9):
        m = n = 2048
        x = torch.as_tensor(rng.normal(size=(m, d)) / np.sqrt(d),
                            dtype=torch.float32, device=dev)
        y = torch.as_tensor(rng.normal(size=(n, d)) / np.sqrt(d),
                            dtype=torch.float32, device=dev)
        got = pairwise_sq_dists(x, y)
        want = pairwise_sq_dists_plain(x, y)
        torch.cuda.synchronize()
        scale = max(1.0, float((x * x).sum(1).max()))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4 * scale)
        err = float((got - want).abs().max())
        b_ms, b_by = bound((m * d + n * d + m * n) * 4.0,
                           m * n * (2 * d + 3) + (m + n) * 2 * d)
        entry = dict(
            name="pairwise_sq_dists", shape=[m, n, d], max_abs_err=err,
            atol=1e-4 * scale, rtol=1e-5,
            **timings("pairwise_sq_dists_kernel",
                      lambda: pairwise_sq_dists(x, y),
                      lambda: pairwise_sq_dists_plain(x, y),
                      lambda: torch.cdist(x, y) ** 2, 50, 50),
            library="torch.cdist(x, y) ** 2 (two calls)",
            bound_ms=b_ms, bound_by=b_by)
        emit("kernels", **entry)
        summary.setdefault("pairwise_sq_dists", entry)

    for case in FIND_LOW_CASES:
        entry = find_low_case(dev, rng, *case)
        emit("kernels", **entry)
        summary.setdefault("gf2_find_low", entry)

    for w in (128, 2048):
        for repeat in (False, True):
            entry = scatter_xor_case(dev, rng, 128, w, repeat)
            emit("kernels", **entry)
            summary.setdefault("gf2_scatter_xor", entry)

    for w in (128, 2048):
        c = 128
        a = gf2.to_tensor(rng.integers(0, 2**32, size=(c, w),
                                       dtype=np.uint32), dev)
        b = gf2.to_tensor(rng.integers(0, 2**32, size=(c, w),
                                       dtype=np.uint32), dev)
        got = gf2.gf2_parallel_xor(a, b)
        want = gf2.gf2_parallel_xor_plain(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"gf2_parallel_xor differs at W={w}")
        b_ms, b_by = bound(3 * c * w * 4.0, c * w)
        entry = dict(
            name="gf2_parallel_xor", shape=[c, w], max_abs_err=0.0,
            exact=True,
            **timings("gf2_parallel_xor_kernel",
                      lambda: gf2.gf2_parallel_xor(a, b),
                      lambda: gf2.gf2_parallel_xor_plain(a, b),
                      lambda: torch.bitwise_xor(a, b), 200, 200),
            library="torch.bitwise_xor", bound_ms=b_ms, bound_by=b_by)
        emit("kernels", **entry)
        summary.setdefault("gf2_parallel_xor", entry)

    for cap in (128, 2048):
        c = 128
        blk = serial_block(rng, c, cap)[None]
        t = gf2.to_tensor(blk, dev)
        red, lows, reds = gf2.gf2_serial_reduce(t)
        pred, plows, preds = gf2.gf2_serial_reduce_plain(t)
        torch.cuda.synchronize()
        if not (torch.equal(red, pred) and torch.equal(lows, plows)
                and torch.equal(reds, preds)):
            raise AssertionError(f"gf2_serial_reduce differs at W="
                                 f"{blk.shape[2]}")
        w = blk.shape[2]
        n_red = int(preds[0])
        if n_red == 0:
            raise AssertionError("serial_reduce test block has no collisions")
        b_ms, b_by = serial_bound(c, w, n_red)
        plan = gf2.serial_plan(c, w)
        entry = dict(
            name="gf2_serial_reduce", shape=[1, c, w], n_reductions=n_red,
            route=plan.route, k=plan.k, max_abs_err=0.0, exact=True,
            **timings(SERIAL_SYMBOL,
                      lambda: gf2.gf2_serial_reduce(t),
                      lambda: gf2.gf2_serial_reduce_plain(t), None, 50, 2),
            bound_ms=b_ms, bound_by=b_by)
        emit("kernels", **entry)
        summary.setdefault("gf2_serial_reduce", entry)

    # The serial kernel's cost against its dependent XOR steps at the
    # phase's two widths (one block's shared memory; a cluster of five) and
    # at 896 words (a cluster of two, as most of the path's launches): the
    # fit's intercept is the load, the first lows, the walk and the
    # write-back, its slope one XOR, first-bit pass and, in a cluster, one
    # cluster barrier.
    for cap, srng in ((128, rng), (2048, np.random.default_rng(8)),
                      (860, np.random.default_rng(9))):
        points = []
        for planted in (0, 16, 48, 96):
            t = gf2.to_tensor(serial_block(srng, 128, cap, planted)[None],
                              dev)
            held = serial_held(t, f"{planted} rows planted")
            ms = device_ms(lambda: gf2.gf2_serial_reduce(t), 50,
                           SERIAL_SYMBOL)
            points.append(dict(planted=planted,
                               n_reductions=held["n_reductions"],
                               kernel_ms=ms))
        fit = None
        if all(p["kernel_ms"] is not None for p in points):
            slope, icpt = np.polyfit([p["n_reductions"] for p in points],
                                     [p["kernel_ms"] for p in points], 1)
            fit = dict(us_per_reduction=slope * 1e3, us_at_zero=icpt * 1e3)
        w = int(t.shape[2])
        plan = gf2.serial_plan(128, w)
        emit("serial_reduce_sweep", shape=[1, 128, w], route=plan.route,
             k=plan.k, points=points, fit=fit)
    serial_routes(dev)
    flash = check_flash(dev, rng)
    summary["flash_attention_bf16"] = flash["bfloat16"]
    summary["flash_attention_f32"] = flash["float32"]
    return summary


def attended_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, over S queries and S keys."""
    i = np.arange(s)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int((hi - lo + 1).sum())


FLASH_SM90 = "flash_attention_kernel_sm90"   # the bf16 kernel's symbol
FLASH_F32 = "flash_attention_f32_kernel"     # the f32 kernel's symbol
FLASH_SYMBOL = {torch.bfloat16: FLASH_SM90, torch.float32: FLASH_F32}
# Correctness-only bfloat16 cases: (BH, S, d, causal, window).
# (64, 1024, 128) is tda_monitor's forward in the training phase: 4 x 1,024
# tokens, 16 heads; (16, 2048, 192) MLA's prefill width (nope 128 + rope 64,
# the values zero-padded to it), run at the kernel's D = 256; then the
# lm_archs prefills: granite-moe-1b-a400m (8 x 16 heads, d = 64), glm4-9b
# (8 x 32, d = 128) and granite-34b (2 x 48 heads of 512 tokens).
FLASH_BF16_EDGES = ((8, 1000, 128, True, -1), (8, 1000, 128, False, -1),
                    (8, 1000, 128, True, 1), (16, 1000, 64, True, -1),
                    (16, 1000, 40, True, 256), (1, 2048, 128, True, -1),
                    (64, 1024, 128, True, -1), (16, 2048, 192, True, -1),
                    (128, 2048, 64, True, -1), (256, 2048, 128, True, -1),
                    (96, 512, 128, True, -1))
# Correctness-only float32 cases, at the SIMT kernel's tile edges (128
# queries, 64 keys; 64 and 32 at d = 256): S not a multiple of 128, S below
# 64, windows below a tile, BH = 1, and every template width.
FLASH_F32_EDGES = ((8, 1000, 128, True, -1), (8, 1000, 128, False, -1),
                   (8, 1000, 128, True, 1), (8, 1000, 128, False, 50),
                   (1, 2048, 128, True, -1), (16, 37, 64, True, -1),
                   (16, 63, 128, False, 16), (16, 1000, 40, True, 256),
                   (16, 333, 8, False, 16), (16, 777, 16, True, -1),
                   (4, 1000, 256, True, 100), (4, 63, 256, False, -1),
                   (1, 200, 256, False, 1))


def check_flash(dev, rng) -> dict:
    """The flash kernel against its plain version at the serving prefill's
    shape (bf16, and f32) and at gemma3-1b's local layers (d = 256, window
    1024, bf16 and f32), timed, with SDPA on the same inputs as the library
    yardstick; then bf16 and f32 cases held for correctness alone; then the
    copies of ``_flash_prefill`` around the kernel at the serving shape.
    Returns the serving shape's entry for each dtype."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(bh, s, d, dtype):
        return [torch.as_tensor(rng.normal(size=(bh, s, d)), dtype=dtype,
                                device=dev) for _ in range(3)]

    def held(q, k, v, causal, window):
        tol = FLASH_BF16_TOL if q.dtype == torch.bfloat16 else FLASH_F32_TOL
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        return (tol, float((got.float() - want.float()).abs().max()),
                float(want.float().abs().median()))

    first = {}
    for bh, s, d, dtype, window in ((128, 2048, 128, torch.bfloat16, -1),
                                    (128, 2048, 128, torch.float32, -1),
                                    (32, 2048, 256, torch.bfloat16, 1024),
                                    (32, 2048, 256, torch.float32, 1024)):
        q, k, v = inputs(bh, s, d, dtype)
        tol, err, typical = held(q, k, v, True, window)
        if window > 0:
            i = torch.arange(s, device=dev)
            diff = i[:, None] - i[None, :]
            lib_kw = dict(attn_mask=(diff >= 0) & (diff < window))
            lib_name = "scaled_dot_product_attention, boolean attn_mask"
        else:
            lib_kw = dict(is_causal=True)
            lib_name = "scaled_dot_product_attention, is_causal=True"

        def library():
            return sdpa(q[:, None], k[:, None], v[:, None], **lib_kw)

        pairs = attended_pairs(s, True, window)
        flops = 4 * bh * d * pairs
        peak = (BF16_TC_FLOPS_PER_S if dtype == torch.bfloat16
                else FP32_OPS_PER_S)
        b_ms, b_by = bound(4 * bh * s * d * q.element_size(), flops, peak)
        if dtype == torch.float32 and not err <= FLASH_F32_MAX_ERR:
            raise AssertionError(f"float32 flash kernel at {(bh, s, d)}: max "
                                 f"abs error {err} > {FLASH_F32_MAX_ERR}")
        # Which kernels the library call runs (SDPA picks its backend).
        _, lib_evs = profiled(library)
        lib_kernels = sorted({ev.name[:100] for ev in lib_evs})
        t = timings(FLASH_SYMBOL[dtype],
                    lambda: flash_attention(q, k, v, causal=True,
                                            window=window),
                    lambda: flash_attention_plain(q, k, v, causal=True,
                                                  window=window),
                    library, 10, 3)
        kernel_ms = t["kernel_ms"] or t["wrapper_ms"]
        # The FFMA peak assumes the 1,980 MHz boost clock: read the clock
        # the float32 kernel runs at.
        if dtype == torch.float32:
            t["clocks_under_kernel"] = clocks_under(
                lambda: flash_attention(q, k, v, causal=True, window=window))
        entry = dict(
            name="flash_attention", shape=[bh, s, d],
            dtype=str(dtype).replace("torch.", ""), causal=True,
            window=window, attended_pairs=pairs, flops=flops,
            max_abs_err=err, median_abs_out=typical, rtol=tol, atol=tol,
            **t, library=lib_name, library_kernels=lib_kernels,
            bound_ms=b_ms, bound_by=b_by,
            bound_peak_ops_per_s=peak, tflops=flops / kernel_ms / 1e9,
            bound_share=b_ms / kernel_ms)
        emit("kernels", **entry)
        first.setdefault(entry["dtype"], entry)
        del q, k, v
        torch.cuda.empty_cache()

    for dtype, edges in ((torch.bfloat16, FLASH_BF16_EDGES),
                         (torch.float32, FLASH_F32_EDGES)):
        for bh, s, d, causal, window in edges:
            q, k, v = inputs(bh, s, d, dtype)
            tol, err, typical = held(q, k, v, causal, window)
            emit("kernels_correctness", name="flash_attention",
                 shape=[bh, s, d], dtype=str(dtype).replace("torch.", ""),
                 causal=causal, window=window, max_abs_err=err,
                 median_abs_out=typical, rtol=tol, atol=tol)
    emit("kernels_prefill_copies", **prefill_copies(dev, rng))
    return first


def prefill_copies(dev, rng) -> dict:
    """Device time of one ``_flash_prefill`` at the serving shape (qwen3-
    0.6b: 8 x 2048 tokens, 16 query heads and 8 KV heads of 128, bf16),
    split into the flash kernel and everything else: the KV heads'
    ``repeat_interleave`` and the (B, S, H, D) -> (B·H, S, D) layout copies
    of q, k and v."""
    from repro_torch.models.attention import _flash_prefill

    b, s, h, kvh, hd = 8, 2048, 16, 8, 128
    q = torch.as_tensor(rng.normal(size=(b, s, h, hd)), dtype=torch.bfloat16,
                        device=dev)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, kvh, hd)),
                            dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    iters = 10
    _flash_prefill(q, k, v, -1, True)
    torch.cuda.synchronize()
    _, evs = profiled(lambda: [_flash_prefill(q, k, v, -1, True)
                               for _ in range(iters)])
    kern = [ev for ev in evs if FLASH_SM90 in ev.name]
    rest = [ev for ev in evs if FLASH_SM90 not in ev.name]
    if len(kern) != iters:
        raise AssertionError(f"_flash_prefill profiled {len(kern)} tensor-"
                             f"core flash launches in {iters} calls")
    by_name = by_kernel(rest)
    return dict(
        shape=dict(batch=b, seq=s, heads=h, kv_heads=kvh, head_dim=hd),
        kernel_ms=sum(ev.time_range.elapsed_us() for ev in kern) / iters
        / 1e3,
        copies_ms=sum(ev.time_range.elapsed_us() for ev in rest) / iters
        / 1e3,
        copies_per_call=len(rest) / iters,
        copies=[dict(name=k[:100], per_call=n / iters,
                     ms=us / iters / 1e3)
                for k, (n, us) in sorted(by_name.items(),
                                         key=lambda kv: -kv[1][1])])


# ---------------------------------------------------------------------------
# phases 7 and 8: the port's main path, and card vs CPU
# ---------------------------------------------------------------------------

PH_KERNELS = ("pairwise_sq_dists", "gf2_find_low", "gf2_scatter_xor",
              "gf2_serial_reduce")
# Kernels kept beside the path's: the dense parallel XOR, whose launches on
# the path are reported (0: the round runs gf2_scatter_xor instead).
OFF_PATH_KERNELS = ("gf2_parallel_xor",)
CAPTURED_ROUNDS = 200


def kernel_counters():
    """Every kernel wrapper, by name; each carries its ``launches``."""
    from repro_torch.kernels import gf2
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pairwise_dist import pairwise_sq_dists

    return {"pairwise_sq_dists": pairwise_sq_dists,
            "gf2_find_low": gf2.gf2_find_low,
            "gf2_scatter_xor": gf2.gf2_scatter_xor,
            "gf2_parallel_xor": gf2.gf2_parallel_xor,
            "gf2_serial_reduce": gf2.gf2_serial_reduce,
            "flash_attention": flash_attention}


def reset_counters() -> dict:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def assert_filtrations_equal(a, b, what: str) -> None:
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    for k in fa:
        va, vb = fa[k], fb[k]
        same = (np.array_equal(va, vb) if isinstance(va, np.ndarray)
                else va == vb)
        if not same:
            raise AssertionError(f"{what}: filtration field {k} differs")


def n_pairs(res) -> dict:
    return {str(d): int(pd.shape[0]) for d, pd in res.diagrams.items()}


def check_diagrams(res, maxdim: int, what: str) -> None:
    """Diagrams of every dimension up to ``maxdim``: (k, 2), finite births,
    no death before its birth, and some H1 pairs."""
    for d in range(maxdim + 1):
        pd = res.diagrams[d]
        if pd.ndim != 2 or pd.shape[1] != 2 \
                or not np.isfinite(pd[:, 0]).all() \
                or (pd[:, 1] < pd[:, 0]).any():
            raise AssertionError(f"{what}: H{d} diagram malformed")
    if res.diagrams[1].shape[0] == 0:
        raise AssertionError(f"{what}: no H1 pairs")


class RoundTap:
    """Wraps ``_PackedBatch.xor_rows_kernels``, the kernel branch of
    ``xor_addends``, for the length of a ``with`` block: times every call
    (host clock; the round ends in a synchronising copy), notes its rows
    (their sum and the most in one round) and coordinates, and keeps the inputs of the first ``keep`` calls, with
    a copy of the batch state they met and their time on the path, for
    :func:`round_step` to replay.  The copies run inside the main path's
    timed call; ``capture_s`` is their host time, which the main path
    reports beside its wall."""

    def __init__(self, keep: int):
        self.keep = keep
        self.calls = 0
        self.seconds = 0.0
        self.rows = 0
        self.max_rows = 0
        self.coords = 0
        self.rounds = []
        self.path_s = []
        self.capture_s = 0.0

    def __enter__(self):
        from repro_torch.core.packed_reduce import _PackedBatch

        real = self.real = _PackedBatch.xor_rows_kernels
        tap = self

        def tapped(batch, packed_hit, ridx, pos):
            keep = len(tap.rounds) < tap.keep
            if keep:
                t0 = time.perf_counter()
                tap.rounds.append((batch_state(batch), list(packed_hit),
                                   ridx.copy(), pos.copy()))
                tap.capture_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            out = real(batch, packed_hit, ridx, pos)
            dt = time.perf_counter() - t0
            if keep:
                tap.path_s.append(dt)
            tap.seconds += dt
            tap.calls += 1
            tap.rows += len(packed_hit)
            tap.max_rows = max(tap.max_rows, len(packed_hit))
            tap.coords += len(pos)
            return out

        _PackedBatch.xor_rows_kernels = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core.packed_reduce import _PackedBatch

        _PackedBatch.xor_rows_kernels = self.real


class SerialTap:
    """Wraps the packed reduction's ``gf2_serial_reduce`` (the name its
    serial pre-pass calls) for the length of a ``with`` block: keeps a host
    copy of every input and notes each call's host seconds.  The copies run
    inside the main path's timed call; ``capture_s`` is their host time,
    which the main path leaves out of ``wall_less_capture_s``."""

    def __init__(self):
        self.inputs = []
        self.path_s = []
        self.capture_s = 0.0

    def __enter__(self):
        from repro_torch.core import packed_reduce

        real = self.real = packed_reduce.gf2_serial_reduce
        tap = self

        def tapped(blocks):
            t0 = time.perf_counter()
            tap.inputs.append(blocks.cpu())
            tap.capture_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            out = real(blocks)
            tap.path_s.append(time.perf_counter() - t0)
            return out

        packed_reduce.gf2_serial_reduce = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import packed_reduce

        packed_reduce.gf2_serial_reduce = self.real


def serial_replay(dev, tap: SerialTap, path_launches: int,
                  phase: str = "serial_replay") -> dict:
    """A path's serial pre-pass inputs again, each through the kernel and
    the plain version (exactly equal), with the kernel's device time: each
    launch's shape, reductions, route and time."""
    from repro_torch.kernels import gf2

    if len(tap.inputs) != path_launches:
        raise AssertionError(f"{len(tap.inputs)} serial inputs captured, "
                             f"{path_launches} launches on the path")
    launches = []
    for i, host in enumerate(tap.inputs):
        t = host.to(dev)
        held = serial_held(t, f"{phase} input {i}")
        plan = held["plan"]
        launches.append(dict(
            shape=list(t.shape), n_reductions=held["n_reductions"],
            route=plan.route, k=plan.k,
            queued_us=queued_ms(lambda: gf2.gf2_serial_reduce(t), 20) * 1e3,
            per_call_us=wall_ms(lambda: gf2.gf2_serial_reduce(t), 20) * 1e3,
            path_host_s=tap.path_s[i]))
    out = dict(n=len(launches), launches=launches,
               queued_s=sum(x["queued_us"] for x in launches) / 1e6,
               per_call_s=sum(x["per_call_us"] for x in launches) / 1e6,
               exact=True)
    emit(phase, **out)
    return out


def batch_state(batch) -> dict:
    """What a parallel-phase round reads and writes of a ``_PackedBatch``."""
    return dict(B=batch.B, VW=batch.VW, device=batch.device,
                block=batch.block.copy(), segs=list(batch.segs),
                seg_off=list(batch.seg_off), r_words=batch.r_words,
                cap=batch.cap, lows=batch.lows.copy(),
                peak_bytes=batch.peak_bytes)


def batch_from(state: dict):
    """A kernel-path ``_PackedBatch`` holding a copy of ``state``."""
    from repro_torch.core.packed_reduce import _PackedBatch

    b = object.__new__(_PackedBatch)
    b.__dict__.update(state, block=state["block"].copy(),
                      lows=state["lows"].copy(), use_kernels=True,
                      cache=None, scalar={}, n_consolidations=0,
                      n_expansions=0, n_evictions=0)
    return b


def old_step(batch, packed_hit, ridx, pos) -> None:
    """The kernel branch of ``xor_addends`` before the round was
    rewired, kept to time against the new one: a dict maps rows to
    local indices, a lexsort orders the coordinates, ``scatter_bits`` fills
    a dense (rows, cap) addend block on the host, the dense
    ``gf2_parallel_xor`` XORs it into a device copy of the rows, the rows
    come back, and ``refresh_lows`` runs ``gf2_find_low`` on each segment's
    rows, padded to 32, in one round trip each."""
    from repro_torch.kernels import gf2

    local = {r: k for k, r in enumerate(packed_hit)}
    lrid = np.array([local[int(r)] for r in ridx], dtype=np.int64)
    order = np.lexsort((pos, lrid))
    packed = np.zeros((len(packed_hit), batch.cap), dtype=np.uint32)
    gf2.scatter_bits(packed, lrid[order], pos[order])
    batch.peak_bytes = max(batch.peak_bytes,
                           batch.block.nbytes + packed.nbytes)
    rview = batch.block[:, :batch.cap]
    rview[packed_hit] = gf2.to_numpy(gf2.gf2_parallel_xor(
        gf2.to_tensor(rview[packed_hit], batch.device),
        gf2.to_tensor(packed, batch.device)))
    batch.refresh_lows(np.asarray(packed_hit, dtype=np.int64))


def step_pair(state, packed_hit, ridx, pos, old_first: bool):
    """Both steps on copies of one state, in the given order: their host
    seconds (each ends in a synchronising copy), checked to leave equal
    rows, lows and peak accounts.  The new step is the round as the path
    runs it, ``xor_rows_kernels``."""
    out = {}
    for name in (("old", "new") if old_first else ("new", "old")):
        b = batch_from(state)
        fn = old_step if name == "old" else type(b).xor_rows_kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(b, packed_hit, ridx, pos)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0, b)
    a, b = out["old"][1], out["new"][1]
    if not (np.array_equal(a.block, b.block) and np.array_equal(a.lows,
                                                                b.lows)
            and a.peak_bytes == b.peak_bytes):
        raise AssertionError(f"old and new steps differ on a round of "
                             f"{len(packed_hit)} rows")
    return out["old"][0], out["new"][0]


def synthetic_round(rng, dev, c: int, w: int):
    """A dense kernel-path round at a phase-3 shape: c rows of a one-segment
    block of w words (c * w * 32 keys), every row hit, each row's addend
    SCATTER_DENSITY of the bit space with ascending ranks, as the path
    hands them over."""
    universe = np.sort(rng.choice(2**40, size=w * 32, replace=False))
    block = np.zeros((c, w + (c + 31) // 32), dtype=np.uint32)
    block[:, :w] = sparse_rows(rng, c, w)
    ranks = [np.sort(rng.choice(w * 32, size=int(SCATTER_DENSITY * w * 32),
                                replace=False)) for _ in range(c)]
    ridx = np.repeat(np.arange(c, dtype=np.int64), [len(r) for r in ranks])
    state = dict(B=c, VW=(c + 31) // 32, device=dev, block=block,
                 segs=[universe], seg_off=[0], r_words=w, cap=w,
                 lows=np.full(c, -1, dtype=np.int64),
                 peak_bytes=block.nbytes)
    return state, list(range(c)), ridx, np.concatenate(ranks)


def round_step(dev, tap: RoundTap, repeats: int = 8) -> dict:
    """The parallel-phase round, old form against new, in this run: at the
    two phase-3 shapes (``repeats`` times each, the order alternating) and
    on the rounds captured from the main path (the order alternating by
    round, after one warm-up pair), beside the same rounds' seconds on the
    path, which ran under the profiler."""
    rng = np.random.default_rng(1)
    shapes = []
    for w in (128, 2048):
        args = synthetic_round(rng, dev, 128, w)
        step_pair(*args, True)                       # warm-up
        times = [step_pair(*args, k % 2 == 0) for k in range(repeats)]
        shapes.append(dict(
            rows=128, words=w, coords=int(args[2].size), repeats=repeats,
            old_s=[t[0] for t in times], new_s=[t[1] for t in times],
            old_sum_s=sum(t[0] for t in times),
            new_sum_s=sum(t[1] for t in times)))
    rounds = tap.rounds
    if not rounds:
        raise AssertionError("no kernel-path round was captured")
    step_pair(*rounds[0], True)
    times = [step_pair(*r, k % 2 == 0) for k, r in enumerate(rounds)]
    captured = dict(
        n=len(rounds), rows=[len(r[1]) for r in rounds],
        words=[int(r[0]["cap"]) for r in rounds],
        coords=[int(r[2].size) for r in rounds],
        segments=[len(r[0]["segs"]) for r in rounds],
        old_sum_s=sum(t[0] for t in times), new_sum_s=sum(t[1] for t in times),
        old_median_s=float(np.median([t[0] for t in times])),
        new_median_s=float(np.median([t[1] for t in times])),
        path_sum_s=sum(tap.path_s))
    out = dict(shapes=shapes, captured=captured,
               path_kernel_branch=dict(calls=tap.calls, seconds=tap.seconds,
                                       rows=tap.rows, coords=tap.coords))
    emit("round_step", **out)
    for what, o, n in [(f"128x{s['words']}", s["old_sum_s"], s["new_sum_s"])
                       for s in shapes] + [(
                           f"{captured['n']} captured rounds",
                           captured["old_sum_s"], captured["new_sum_s"])]:
        if not n <= o:
            raise AssertionError(f"the new round is slower than the old at "
                                 f"{what}: {n} s against {o} s")
    return out


def path_profile(evs, wall: float) -> dict:
    """A path's profile: the card's busy seconds and idle share of the
    wall, and each PH kernel's profiled launches and device seconds."""
    busy_s = busy_us(evs) / 1e6
    per_kernel = {}
    for k in PH_KERNELS + OFF_PATH_KERNELS:
        kev = [ev for ev in evs if f"{k}_kernel" in ev.name]
        per_kernel[k] = dict(
            profiled_launches=len(kev),
            device_s=sum(ev.time_range.elapsed_us() for ev in kev) / 1e6)
    return dict(device_events=len(evs), device_busy_s=busy_s,
                device_idle_share=(1.0 - busy_s / wall) if evs else None,
                kernels_on_path=per_kernel)


def harvest_held(dev, points, tau: float, n_e: int, what: str) -> None:
    """The path's harvest again, through the pairwise kernel and through
    its plain version on the card (2048 x 2048 tiles): identical edges,
    as many as the path's ``n_e``."""
    from repro_torch.kernels.pairwise_dist import pairwise_sq_dists_plain
    from repro_torch.scale.tiles import harvest_edges

    kern = harvest_edges(points=points, tau_max=tau, tile_m=2048,
                         tile_n=2048, backend="kernel", device=dev)
    plain = harvest_edges(points=points, tau_max=tau, tile_m=2048,
                          tile_n=2048, backend="kernel", device=dev,
                          sq_dists=pairwise_sq_dists_plain)
    for a, b, field in zip(kern, plain, ("i", "j", "length")):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: harvest {field} differs between "
                                 "the kernel and the plain version")
    if kern[0].size != n_e:
        raise AssertionError(f"{what}: harvest edge count differs from "
                             "compute_ph's")


class FiltrationTap:
    """Wraps ``repro_torch.scale``'s ``build_filtration_tiled`` and
    ``build_filtration_sharded`` (the names ``compute_ph`` calls) for the
    length of a ``with`` block, keeping the last build's ``edges``,
    ``edge_len`` and ``TileStats``: the mesh path's filtration is held to
    the main path's through them.  It also keeps the last H0 result
    ``compute_ph`` computed (``h0``), whose death edges ``device_engine``
    holds the Borůvka forest to."""

    def __enter__(self):
        import repro_torch.core.homology as homology
        import repro_torch.scale as scale

        self.real = {name: getattr(scale, name)
                     for name in ("build_filtration_tiled",
                                  "build_filtration_sharded")}
        self.real_h0 = homology.compute_h0
        tap = self

        def h0_tapped(filt):
            tap.h0 = self.real_h0(filt)
            return tap.h0

        homology.compute_h0 = h0_tapped

        def wrap(real):
            def tapped(*args, **kw):
                out = real(*args, **kw)
                filt, tap.stats = out if kw.get("return_stats") \
                    else (out, None)
                tap.edges, tap.edge_len = filt.edges, filt.edge_len
                return out
            return tapped

        for name, real in self.real.items():
            setattr(scale, name, wrap(real))
        return self

    def __exit__(self, *exc):
        import repro_torch.core.homology as homology
        import repro_torch.scale as scale

        for name, real in self.real.items():
            setattr(scale, name, real)
        homology.compute_h0 = self.real_h0


def main_path(dev, n: int, tap: RoundTap, serial: SerialTap):
    """The main path under the profiler; returns its line, its result, its
    filtration's ``(edges, edge_len)`` and its H0 death edges."""
    from repro_torch import compute_ph
    from repro_torch.data.pointclouds import clifford_torus

    points = clifford_torus(n, seed=0)
    counters = reset_counters()
    filt = FiltrationTap()

    def run():
        t0 = time.perf_counter()
        out = compute_ph(points=points, maxdim=1, backend="tiled",
                         engine="packed", memory_budget_bytes=96 * 2**20,
                         tile_m=2048, tile_n=2048, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # The whole call runs under the profiler: its device events give the
    # card's busy time and each kernel's device time on the path.
    with tap, serial, filt:
        (res, wall), evs = profiled(run)
    launches = {k: counters[k].launches
                for k in PH_KERNELS + OFF_PATH_KERNELS}
    for name in PH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"main path never launched {name}")
    check_diagrams(res, 1, "main path")
    st = res.stats
    tau = st["tau_max_estimated"]
    harvest_held(dev, points, tau, int(st["n_e"]), "main path")
    out = dict(n=n, n_e=int(st["n_e"]), tau_max=tau, wall_s=wall,
               t_filtration=st["t_filtration"], t_h0=st["t_h0"],
               t_h1=st["t_h1"], pairs=n_pairs(res), launches=launches,
               h1_n_supersteps=st["h1_n_supersteps"],
               h1_n_rounds=st["h1_n_rounds"],
               h1_n_reductions=st["h1_n_reductions"],
               **{f"h1_{k}": st[f"h1_{k}"] for k in BLOCK_COUNTS},
               **path_profile(evs, wall),
               kernel_round_calls=tap.calls,
               kernel_round_s=tap.seconds,
               round_capture_s=tap.capture_s,
               serial_capture_s=serial.capture_s,
               wall_less_capture_s=wall - tap.capture_s - serial.capture_s,
               harvest_identical_to_plain=True)
    emit("main_path", **out)
    return out, res, (filt.edges, filt.edge_len), filt.h0.death_edges


def cross_check(dev) -> dict:
    """Each case on the card and on the CPU: identical diagrams and
    filtrations.  Returns each case's card result and wall, by name."""
    from repro_torch import compute_ph
    from repro_torch.scale.tiles import build_filtration_tiled

    out = {}
    for name, points, tau, maxdim in check_cases():
        times = {}
        results = {}
        for where in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            results[where.type] = compute_ph(
                points=points, tau_max=tau, maxdim=maxdim, backend="tiled",
                engine="packed", device=where)
            times[where.type] = time.perf_counter() - t0
        card, host = results["cuda"], results["cpu"]
        for d in range(maxdim + 1):
            if not np.array_equal(card.diagrams[d], host.diagrams[d]):
                raise AssertionError(f"{name}: H{d} differs card vs CPU")
        assert_filtrations_equal(
            build_filtration_tiled(points=points, tau_max=tau, device=dev),
            build_filtration_tiled(points=points, tau_max=tau, device="cpu"),
            name)
        emit("cross_check", case=name, n=len(points), tau_max=tau,
             maxdim=maxdim, n_e=int(card.stats["n_e"]), pairs=n_pairs(card),
             card_s=times["cuda"], cpu_s=times["cpu"],
             card_use_kernels=card.stats["h1_use_kernels"], identical=True)
        out[name] = dict(result=card, card_s=times["cuda"])
    return out


def check_cases():
    """``cross_check``'s clouds: (name, points, tau_max, maxdim)."""
    from repro_torch.data.pointclouds import clifford_torus, o3_points

    return [("torus4", clifford_torus(10_000, seed=0), 0.15, 1),
            ("o3", o3_points(1024, seed=0), 1.1, 2)]


# ---------------------------------------------------------------------------
# phases 9 to 11: compute_ph over a 4-entry mesh of the card, and the
# distributed packed reduction (n_shards on one card)
# ---------------------------------------------------------------------------

DIST_SHARDS, DIST_EVERY = 4, 4     # the reference's --dist-shards 4 default
DIST_SIM = ("sim_wall_s", "sim_conc_s", "sim_sweep_s", "sim_sync_s")
DIST_COUNTS = ("n_supersteps", "n_exchange_rounds", "exchange_bytes",
               "n_tournament_reductions", "n_sweep_probes", "n_rounds",
               "n_reductions")
# dist_check's o3 run, which sanitize repeats under the sanitizer
DIST_CHECK_O3 = dict(n_shards=3, exchange_every=4, mode="implicit")
# How the packed blocks held their rows: a fused block that grows where its
# slices' own blocks would evict rebuilds a 4x larger block each time.
BLOCK_COUNTS = ("n_consolidations", "n_expansions", "n_evictions")


def card_mesh(dev, p: int = DIST_SHARDS):
    """A ``(data=p,)`` mesh whose every entry is this card."""
    from repro_torch.launch.mesh import make_data_mesh

    return make_data_mesh(p, devices=[dev] * p)


def mesh_path(dev, n: int, main, harvest, tau: float) -> dict:
    """``compute_ph(maxdim=0)`` over a 4-entry data mesh of the card
    (``make_data_mesh(4, devices=["cuda:0"] * 4)``): the main path's cloud,
    tiles and budget at the main path's tau, under the profiler, the
    counts set to 0 just before it.  The sharded harvest gives each entry
    one tile a round on its own stream.  Gates: the filtration's ``edges``
    and ``edge_len`` equal the main path's, H0 equals ``main``'s and
    ``pairwise_sq_dists`` launches once a tile (325).  H1 over the mesh
    (a repeat of the main path's host-bound reduction, about 274 s) is
    held at n = 10,000 by ``dist_path``'s mesh run."""
    from repro_torch import compute_ph
    from repro_torch.data.pointclouds import clifford_torus
    from repro_torch.scale.shard import partition_tiles

    points = clifford_torus(n, seed=0)
    mesh = card_mesh(dev)
    shards = partition_tiles(n, 2048, 2048, DIST_SHARDS)
    n_tiles = sum(len(t) for t in shards)
    counters = reset_counters()
    filt = FiltrationTap()

    def run():
        t0 = time.perf_counter()
        out = compute_ph(points=points, tau_max=tau, maxdim=0,
                         backend="tiled", engine="packed",
                         memory_budget_bytes=96 * 2**20, tile_m=2048,
                         tile_n=2048, mesh=mesh, exchange_every=DIST_EVERY)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with filt:
        (res, wall), evs = profiled(run)
    launches = {k: counters[k].launches
                for k in PH_KERNELS + OFF_PATH_KERNELS}
    if launches["pairwise_sq_dists"] != n_tiles:
        raise AssertionError(f"mesh path: {launches['pairwise_sq_dists']} "
                             f"pairwise launches for {n_tiles} tiles")
    edges, edge_len = harvest
    if not (np.array_equal(filt.edges, edges)
            and np.array_equal(filt.edge_len, edge_len)):
        raise AssertionError("mesh path: filtration differs from the main "
                             "path's")
    if not np.array_equal(res.diagrams[0], main.diagrams[0]):
        raise AssertionError("mesh path: H0 differs from the main path's")
    st = res.stats
    if st["n_shards"] != DIST_SHARDS:
        raise AssertionError("mesh path: the harvest did not shard over 4 "
                             "entries")
    out = dict(n=n, mesh=repr(mesh), maxdim=0, tau_max=tau,
               n_e=int(st["n_e"]), wall_s=wall,
               t_filtration=st["t_filtration"], t_h0=st["t_h0"],
               pairs=n_pairs(res), launches=launches,
               harvest_tiles=n_tiles,
               harvest_rounds=max(len(t) for t in shards),
               gather_bytes=filt.stats.gather_bytes,
               candidate_pairs=filt.stats.candidate_pairs,
               per_device_peak_bytes=st["per_device_peak_bytes"],
               per_device_base_bytes=st["per_device_base_bytes"],
               **path_profile(evs, wall), filtration_equal_main_path=True,
               h0_equal_main_path=True)
    emit("mesh_path", **out)
    return out


def dist_path(dev, cards: dict) -> dict:
    """The distributed reduction at ``cross_check``'s torus4 cloud (n =
    10,000 at its tau), P = 4, ``exchange_every=4``, twice, each under the
    profiler with the counts set to 0 just before it: over the host
    loop-back (``n_shards=4``) and over the 4-entry mesh of the card.
    Diagrams and every split counter must be equal between the two and the
    diagrams equal to the cloud's P = 1 card result; ``gf2_find_low`` and
    ``gf2_scatter_xor`` must launch (the fused 4 x 128-row blocks go
    through them; ``gf2_serial_reduce`` runs only in a superstep that holds
    one slice, so its launches are printed, not gated) and an exchange
    round must happen."""
    from repro_torch import compute_ph
    from repro_torch.scale.tiles import tile_grid

    name, points, tau, maxdim = check_cases()[0]
    one = cards[name]["result"]
    runs = {}
    for route, kw in (("loopback", dict(n_shards=DIST_SHARDS, device=dev)),
                      ("mesh", dict(mesh=card_mesh(dev)))):
        counters = reset_counters()
        tap = RoundTap(keep=0)

        def run():
            t0 = time.perf_counter()
            out = compute_ph(points=points, tau_max=tau, maxdim=maxdim,
                             backend="tiled", engine="packed",
                             exchange_every=DIST_EVERY, **kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        with tap:
            (res, wall), evs = profiled(run)
        launches = {k: counters[k].launches
                    for k in PH_KERNELS + OFF_PATH_KERNELS}
        for k in ("pairwise_sq_dists", "gf2_find_low", "gf2_scatter_xor"):
            if launches[k] <= 0:
                raise AssertionError(f"dist path ({route}) never launched "
                                     f"{k}")
        for d in range(maxdim + 1):
            if not np.array_equal(res.diagrams[d], one.diagrams[d]):
                raise AssertionError(f"dist path ({route}): H{d} differs "
                                     "from P = 1 on the card")
        st = res.stats
        if st["h1_n_shards"] != DIST_SHARDS \
                or st["h1_n_exchange_rounds"] <= 0:
            raise AssertionError(f"dist path ({route}): no exchange round "
                                 "at 4 shards")
        runs[route] = dict(
            route=route, n=len(points), n_shards=DIST_SHARDS,
            exchange_every=DIST_EVERY, tau_max=tau, n_e=int(st["n_e"]),
            wall_s=wall, t_filtration=st["t_filtration"], t_h0=st["t_h0"],
            t_h1=st["t_h1"], p1_card_s=cards[name]["card_s"],
            pairs=n_pairs(res), launches=launches,
            **{f"h1_{k}": st[f"h1_{k}"]
               for k in DIST_COUNTS + DIST_SIM + BLOCK_COUNTS},
            h1_sim_wall_bookkeeping_s=st["h1_sim_wall_bookkeeping_s"],
            **path_profile(evs, wall),
            kernel_round_calls=tap.calls, kernel_round_s=tap.seconds,
            kernel_round_rows=tap.rows, max_hit_rows=tap.max_rows,
            diagrams_equal_p1=True)
        runs[route]["_diagrams"] = res.diagrams
    loop, mesh = runs["loopback"], runs["mesh"]
    for d in range(maxdim + 1):
        if not np.array_equal(loop["_diagrams"][d], mesh["_diagrams"][d]):
            raise AssertionError(f"dist path: H{d} differs between the "
                                 "loop-back and the mesh")
    for k in DIST_COUNTS + BLOCK_COUNTS:
        if loop[f"h1_{k}"] != mesh[f"h1_{k}"]:
            raise AssertionError(f"dist path: h1_{k} differs between the "
                                 "loop-back and the mesh")
    if mesh["launches"]["pairwise_sq_dists"] \
            != len(tile_grid(len(points), 2048, 2048)):
        raise AssertionError("dist path (mesh): not one pairwise launch a "
                             "tile")
    diagrams = loop["_diagrams"]
    for run in (loop, mesh):
        del run["_diagrams"]
        emit("dist_path", **run, split_equal_between_routes=True)
    return loop, diagrams


def dist_check(dev, cards: dict) -> None:
    """``cross_check``'s o3 cloud (maxdim 2, where the exchanges of the
    reference's tests happen) through the distributed reduction on the
    card at P = 3, implicit, ``exchange_every=4``, ``np.array_equal`` to
    its P = 1 card diagrams.  The torus4 cloud at P 2 and 4 is held by
    ``dist_path`` (P = 4 over both transports) and by the card tests
    (``test_compute_ph_dist_card_matches_cpu``: P in {2, 4} x cadence).
    Returns each run's wall by case name."""
    from repro_torch import compute_ph

    runs = {"o3": [DIST_CHECK_O3]}
    walls = {}
    for name, points, tau, maxdim in check_cases():
        one = cards[name]
        for kw in runs.get(name, ()):
            counters = reset_counters()
            res, wall = timed(lambda: compute_ph(
                points=points, tau_max=tau, maxdim=maxdim, backend="tiled",
                engine="packed", device=dev, **kw))
            for d in range(maxdim + 1):
                if not np.array_equal(res.diagrams[d],
                                      one["result"].diagrams[d]):
                    raise AssertionError(f"dist_check {name} {kw}: H{d} "
                                         "differs from P = 1 on the card")
            walls[name] = wall
            top = f"h{maxdim}"
            emit("dist_check", case=name, n=len(points), tau_max=tau,
                 maxdim=maxdim, **kw, wall_s=wall, p1_card_s=one["card_s"],
                 launches={k: counters[k].launches for k in PH_KERNELS},
                 **{f"{top}_{k}": res.stats[f"{top}_{k}"]
                    for k in DIST_COUNTS},
                 identical_to_p1=True)
    return walls


# ---------------------------------------------------------------------------
# phase 12: the PH service (PHServeEngine over warm resume)
# ---------------------------------------------------------------------------

# The reference launcher's run_ph traffic at a size a service holds on the
# card: 8 clouds of 1,500 points (about 5,700 edges each at the 0.5 %
# quantile of pair lengths), a 4 MiB admission account, 256 MiB of tenant
# cache, the packed engine; maxdim 1, cut from the service's default 2.
# At the 1 % quantile (about 11,000 edges a cloud) the phase took 64.1 s
# on an H100, more than the 60 s it may take of the run; at 0.5 %, 37.3 s.
SERVE_PH_N, SERVE_PH_CLOUDS, SERVE_PH_Q = 1500, 8, 0.005
SERVE_PH_BUDGET, SERVE_PH_STORE = 4 << 20, 256 << 20
SERVE_PH_ARRIVALS = 64


def serve_ph_traffic(rng, clouds, tau: float):
    """The update wave: 8 requests, even uids grow tau to 1.5x on one
    cached cloud, odd uids bring 64 new points to another; then one
    request at 3x tau on the first, which admission clamps.  Returns
    (uid, dataset, points, tau, expected path) rows."""
    rows = []
    for k in range(SERVE_PH_CLOUDS):
        uid = SERVE_PH_CLOUDS + k
        if k % 2 == 0:
            rows.append((uid, f"ds{k}", clouds[k], 1.5 * tau, "warm_tau"))
        else:
            grown = np.concatenate(
                [clouds[k], rng.normal(size=(SERVE_PH_ARRIVALS, 3))], axis=0)
            rows.append((uid, f"ds{k}", grown, tau, "warm_points"))
    rows.append((2 * SERVE_PH_CLOUDS, "ds0", clouds[0], 3.0 * tau,
                 "warm_tau"))
    return rows


def serve_ph(dev) -> dict:
    """``PHServeEngine(engine="packed", device=dev)`` under the profiler,
    the counts set to 0 just before it: a cold wave of 8 clouds served as
    one union batch, an update wave of 8 warm requests (tau growth, point
    arrival) and one request at 3x tau that admission clamps to the 4 MiB
    account and serves warm.  Gates: every path as planned; 9 warm and 2
    cold responses equal (H0, H1) to a cold ``compute_ph`` on the card at
    the granted tau; find-low and scatter-XOR launched; a checkpoint saved
    and reloaded keeps its hash, and under a ``resume.load`` bit flip the
    reload raises ``CheckpointCorruption`` and a cold reduction through
    the engine's reducer gives the cached diagrams."""
    import tempfile

    from repro_torch import compute_ph
    from repro_torch.core.resume import (ReductionCheckpoint,
                                         canonical_diagram, cold_reduce)
    from repro_torch.resilience.faults import (CheckpointCorruption,
                                               FaultPlan, FaultSpec, inject)
    from repro_torch.scale.budget import sample_pair_lengths
    from repro_torch.serve.ph import PHRequest, PHServeEngine

    rng = np.random.default_rng(0)
    clouds = [rng.normal(size=(SERVE_PH_N, 3))
              for _ in range(SERVE_PH_CLOUDS)]
    tau = float(np.quantile(sample_pair_lengths(clouds[0], seed=0),
                            SERVE_PH_Q))
    updates = serve_ph_traffic(rng, clouds, tau)
    engine = PHServeEngine(engine="packed",
                           memory_budget_bytes=SERVE_PH_BUDGET,
                           store_budget_bytes=SERVE_PH_STORE,
                           max_batch_clouds=SERVE_PH_CLOUDS, seed=0,
                           device=dev)
    counters = reset_counters()

    def run():
        walls = {}
        for k, p in enumerate(clouds):
            engine.submit(PHRequest(uid=k, points=p, tau_max=tau,
                                    dataset=f"ds{k}", maxdim=1))
        _, walls["cold_wave_s"] = timed(engine.run)
        for uid, ds, p, t, _ in updates[:-1]:
            engine.submit(PHRequest(uid=uid, points=p, tau_max=t,
                                    dataset=ds, maxdim=1))
        _, walls["update_wave_s"] = timed(engine.run)
        uid, ds, p, t, _ = updates[-1]
        engine.submit(PHRequest(uid=uid, points=p, tau_max=t, dataset=ds,
                                maxdim=1))
        _, walls["clamped_s"] = timed(engine.run)
        return walls

    walls, evs = profiled(run)
    launches = {k: counters[k].launches for k in PH_KERNELS}
    wall = sum(walls.values())
    done = engine.done
    plan = [(k, f"ds{k}", clouds[k], tau, "batched")
            for k in range(SERVE_PH_CLOUDS)] + updates
    for uid, _, _, _, path in plan:
        r = done[uid]
        if not r.admitted or r.path != path or r.degraded:
            raise AssertionError(f"serve_ph: request {uid} took {r.path} "
                                 f"(admitted {r.admitted}), planned {path}")
    clamped = done[updates[-1][0]]
    if not (clamped.granted_tau < 3.0 * tau
            and "clamped" in clamped.admission.reason):
        raise AssertionError("serve_ph: the 3x tau request was not clamped "
                             "to the account")
    for k in ("gf2_find_low", "gf2_scatter_xor"):
        if launches[k] <= 0:
            raise AssertionError(f"serve_ph: the service never launched {k}")
    # every warm response and two of the cold wave against a cold run
    checked = []
    for uid, _, points, _, _ in plan[:2] + updates:
        r = done[uid]
        res, cold_s = timed(lambda: compute_ph(
            points=points, tau_max=r.granted_tau, maxdim=1, engine="packed",
            device=dev))
        for d in (0, 1):
            if not np.array_equal(r.diagrams[d],
                                  canonical_diagram(res.diagrams[d])):
                raise AssertionError(f"serve_ph: request {uid} ({r.path}) "
                                     f"H{d} differs from a cold compute_ph")
        checked.append(dict(uid=uid, path=r.path, n=len(points),
                            granted_tau=r.granted_tau,
                            n_e=int(res.stats["n_e"]), cold_s=cold_s,
                            served_s=r.latency_s))
    # a checkpoint through disk, clean and under a bit flip
    entry = engine._cache[("default", "ds1")]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ds1.npz")
        digest = entry.checkpoint.save(path)
        if ReductionCheckpoint.load(path).content_hash() != digest \
                or digest != entry.checkpoint.content_hash():
            raise AssertionError("serve_ph: a reloaded checkpoint changed "
                                 "its content hash")
        nbytes = os.path.getsize(path)
        with inject(FaultPlan.of(FaultSpec("resume.load", "bitflip"))) \
                as inj:
            try:
                ReductionCheckpoint.load(path)
            except CheckpointCorruption:
                (fallback, _), fallback_s = timed(lambda: cold_reduce(
                    entry.filtration, maxdim=1, reducer=engine._reducer))
            else:
                raise AssertionError("serve_ph: a bit-flipped checkpoint "
                                     "loaded")
        if inj.n_fired("resume.load", "bitflip") != 1:
            raise AssertionError("serve_ph: the bit flip did not fire once")
    for d in (0, 1):
        if not np.array_equal(canonical_diagram(fallback[d]),
                              entry.diagrams[d]):
            raise AssertionError(f"serve_ph: the cold fallback's H{d} "
                                 "differs from the cached diagrams")
    stats = engine.stats()
    lat = np.array([done[u].latency_s for u in sorted(done)])
    out = dict(
        n=SERVE_PH_N, clouds=SERVE_PH_CLOUDS, quantile=SERVE_PH_Q,
        tau_max=tau, granted_clamped_tau=clamped.granted_tau,
        n_e_clamped=checked[-1]["n_e"], budget_bytes=SERVE_PH_BUDGET,
        store_budget_bytes=SERVE_PH_STORE, maxdim=1, **walls,
        requests=len(done), requests_per_s=len(done) / wall,
        cache_hit_ratio=stats["serve_ph_n_cache_hits"]
        / stats["serve_ph_n_requests"],
        latency_p50_s=float(np.percentile(lat, 50)),
        latency_p95_s=float(np.percentile(lat, 95)),
        serve_ph={k: v for k, v in stats.items()
                  if k.startswith("serve_ph_")},
        launches=launches, **path_profile(evs, wall), checked=checked,
        checkpoint_bytes=nbytes, checkpoint_hash=digest,
        bitflip_fallback_s=fallback_s, all_equal_cold=True)
    emit("serve_ph", **out)
    return out


# ---------------------------------------------------------------------------
# phases 13 to 15: recovery, the GF(2) sanitizer and the device engine
# ---------------------------------------------------------------------------

# One seeded plan for every fault class of the distributed driver and the
# tile harvest (tests/test_resilience.py's classes): supersteps and
# exchange rounds are the H1 reduction's, tiles the harvest's ordinals.
RESILIENCE_SPECS = (
    dict(site="reduce.superstep", kind="kill_shard", at=2, shard=1,
         params=(("when", "start"),)),
    dict(site="reduce.superstep", kind="kill_shard", at=4, shard=2,
         params=(("when", "mid"),)),
    dict(site="reduce.superstep", kind="slow_shard", at=3, shard=3,
         params=(("lag", 2.0), ("duration", 2))),
    dict(site="exchange.wire", kind="drop", at=1, shard=0, times=2),
    dict(site="exchange.wire", kind="corrupt", at=2, shard=0,
         params=(("bit", 37),)),
    dict(site="exchange.wire", kind="delay", at=3, shard=0),
    dict(site="harvest.tile", kind="fail_tile", at=3),
)


def resilience(dev, dist: dict, dist_diagrams) -> dict:
    """``dist_path``'s loop-back run (torus4, n = 10,000 at its tau, P = 4,
    ``exchange_every=4``) again under one seeded fault plan: a shard killed
    at the start of superstep 2 and one mid-superstep 4, a slow shard, a
    payload dropped twice, one corrupted, one delayed, and a failed tile.
    The counts are set to 0 just before it.  Gates: every spec fired; the
    filtration equals an unfaulted harvest on the card; the diagrams equal
    ``dist_path``'s loop-back diagrams; two shard deaths, one wire
    corruption, one tile retry, at least two re-deals; find-low and
    scatter-XOR launched.  Then ``kill_shard`` over the 4-entry mesh of
    the card must raise ``ValueError`` at the first superstep, before any
    reduction work (no GF(2) launch)."""
    from repro_torch import compute_ph
    from repro_torch.resilience.faults import FaultPlan, FaultSpec, inject
    from repro_torch.scale.tiles import build_filtration_tiled

    name, points, tau, maxdim = check_cases()[0]
    plan = FaultPlan.of(*[FaultSpec(**s) for s in RESILIENCE_SPECS],
                        seed=23)
    counters = reset_counters()
    filt = FiltrationTap()
    with filt, inject(plan) as inj:
        res, wall = timed(lambda: compute_ph(
            points=points, tau_max=tau, maxdim=maxdim, backend="tiled",
            engine="packed", n_shards=DIST_SHARDS, exchange_every=DIST_EVERY,
            device=dev))
    launches = {k: counters[k].launches for k in PH_KERNELS}
    fired = {(f["site"], f["kind"], f["index"]) for f in inj.fired}
    for spec in RESILIENCE_SPECS:
        if not any(f[:2] == (spec["site"], spec["kind"]) for f in fired):
            raise AssertionError(f"resilience: {spec} never fired")
    clean = build_filtration_tiled(points=points, tau_max=tau, device=dev)
    if not (np.array_equal(filt.edges, clean.edges)
            and np.array_equal(filt.edge_len, clean.edge_len)):
        raise AssertionError("resilience: the faulted harvest differs")
    for d in range(maxdim + 1):
        if not np.array_equal(res.diagrams[d], dist_diagrams[d]):
            raise AssertionError(f"resilience: H{d} differs from the "
                                 "fault-free loop-back run")
    st = res.stats
    counts = {k[len("h1_"):]: v for k, v in st.items()
              if k.startswith("h1_resilience_")}
    want = dict(resilience_n_shard_deaths=2, resilience_n_wire_corruptions=1)
    for k, v in want.items():
        if counts.get(k) != v:
            raise AssertionError(f"resilience: {k} = {counts.get(k)}, "
                                 f"not {v}")
    if counts["resilience_n_redeals"] < 2 or filt.stats.tile_retries != 1:
        raise AssertionError("resilience: re-deals "
                             f"{counts['resilience_n_redeals']}, tile "
                             f"retries {filt.stats.tile_retries}")
    for k in ("gf2_find_low", "gf2_scatter_xor"):
        if launches[k] <= 0:
            raise AssertionError(f"resilience: never launched {k}")
    # an elastic shrink over a mesh: refused at superstep 1
    kill = FaultPlan.of(FaultSpec("reduce.superstep", "kill_shard", at=1,
                                  shard=1))
    mesh_counters = reset_counters()
    with inject(kill):
        try:
            compute_ph(filtration=clean, maxdim=1, engine="packed",
                       mesh=card_mesh(dev), exchange_every=DIST_EVERY)
        except ValueError as exc:
            refusal = str(exc)
        else:
            raise AssertionError("resilience: kill_shard over a mesh ran")
    gf2_work = sum(mesh_counters[k].launches for k in PH_KERNELS)
    if gf2_work:
        raise AssertionError(f"resilience: {gf2_work} launches before the "
                             "mesh refusal")
    out = dict(case=name, n=len(points), tau_max=tau, maxdim=maxdim,
               n_shards=DIST_SHARDS, exchange_every=DIST_EVERY,
               n_e=int(st["n_e"]), wall_s=wall, t_h1=st["t_h1"],
               t_h1_over_dist_path=st["t_h1"] / dist["t_h1"],
               dist_path_t_h1=dist["t_h1"], fired=len(inj.fired),
               **counts, tile_retries=filt.stats.tile_retries,
               launches=launches,
               **{f"h1_{k}": st[f"h1_{k}"]
                  for k in DIST_COUNTS + DIST_SIM + BLOCK_COUNTS},
               mesh_refusal=refusal, diagrams_equal_fault_free=True,
               filtration_equal_fault_free=True)
    emit("resilience", **out)
    return out


class SanitizeTap:
    """Wraps the ``sanitizing`` scope ``compute_ph`` opens for the length
    of a ``with`` block and keeps the last sanitizer it yielded, whose
    ``counts`` name every check that ran."""

    def __enter__(self):
        import contextlib

        import repro_torch.core.homology as homology

        self.real = real = homology.sanitizing
        tap = self

        @contextlib.contextmanager
        def tapped(enabled):
            with real(enabled) as san:
                tap.san = san
                yield san

        homology.sanitizing = tapped
        return self

    def __exit__(self, *exc):
        import repro_torch.core.homology as homology

        homology.sanitizing = self.real


def sanitize(dev, o3_card: dict, o3_p3_s: float) -> dict:
    """``cross_check``'s o3 cloud (n = 1,024, maxdim 2) through
    ``compute_ph(engine="packed", sanitize=True)`` on the card at P = 1
    (as ``cross_check`` ran it) and at P = 3 (as ``dist_check`` ran it).
    Gates: diagrams equal ``cross_check``'s card result and
    ``sanitize_checks`` > 0.  Prints the checks by name and each wall
    beside the unsanitized one."""
    from repro_torch import compute_ph

    name, points, tau, maxdim = check_cases()[1]
    runs = []
    for kw, plain_s in ((dict(), o3_card["card_s"]), (DIST_CHECK_O3, o3_p3_s)):
        counters = reset_counters()
        with SanitizeTap() as tap:
            res, wall = timed(lambda: compute_ph(
                points=points, tau_max=tau, maxdim=maxdim, backend="tiled",
                engine="packed", sanitize=True, device=dev, **kw))
        for d in range(maxdim + 1):
            if not np.array_equal(res.diagrams[d],
                                  o3_card["result"].diagrams[d]):
                raise AssertionError(f"sanitize {kw}: H{d} differs from "
                                     "the unsanitized card run")
        n_checks = res.stats.get("sanitize_checks", 0)
        if n_checks <= 0 or n_checks != sum(tap.san.counts.values()):
            raise AssertionError(f"sanitize {kw}: {n_checks} checks")
        runs.append(dict(n_shards=kw.get("n_shards", 1),
                         mode=kw.get("mode", "explicit"), wall_s=wall,
                         unsanitized_s=plain_s, ratio=wall / plain_s,
                         sanitize_checks=n_checks,
                         checks=dict(sorted(tap.san.counts.items())),
                         launches={k: counters[k].launches
                                   for k in PH_KERNELS}))
    out = dict(case=name, n=len(points), tau_max=tau, maxdim=maxdim,
               runs=runs, diagrams_equal_unsanitized=True)
    emit("sanitize", **out)
    return out


# launch/dryrun.py's ph_round_64k cell: columns per mesh entry, column
# width in keys, pivot-table entries
ROUND_COLS, ROUND_WIDTH, ROUND_PIVOTS = 256, 64, 2**20


def round_inputs(entries: int, seed: int = 0):
    """A pivot table of ``ROUND_PIVOTS`` sorted keys whose row k has low
    ``keys[k]`` and later keys of the table after it, and ``entries x
    ROUND_COLS`` columns of table keys, so that reductions chain through
    the table and cancel."""
    from repro_torch.core.device_engine import EMPTY

    rng = np.random.default_rng(seed)
    keys = np.cumsum(rng.integers(1, 1 << 12, size=ROUND_PIVOTS,
                                  dtype=np.int64))
    w = ROUND_WIDTH
    # row k: itself, then table keys at increasing offsets past k
    idx = np.arange(ROUND_PIVOTS, dtype=np.int64)[:, None] + np.concatenate(
        [np.zeros((ROUND_PIVOTS, 1), dtype=np.int64),
         np.cumsum(rng.integers(1, 64, size=(ROUND_PIVOTS, w - 1)), axis=1)],
        axis=1)
    length = rng.integers(1, w + 1, size=(ROUND_PIVOTS, 1))
    live = (np.arange(w)[None, :] < length) & (idx < ROUND_PIVOTS)
    table = np.where(live, keys[np.minimum(idx, ROUND_PIVOTS - 1)], EMPTY)
    b = entries * ROUND_COLS
    start = rng.integers(0, ROUND_PIVOTS // 2, size=(b, 1))
    cidx = start + np.concatenate(
        [np.zeros((b, 1), dtype=np.int64),
         np.cumsum(rng.integers(1, 4096, size=(b, w - 1)), axis=1)], axis=1)
    clen = rng.integers(1, w + 1, size=(b, 1))
    clive = (np.arange(w)[None, :] < clen) & (cidx < ROUND_PIVOTS)
    cols = np.where(clive, keys[np.minimum(cidx, ROUND_PIVOTS - 1)], EMPTY)
    return cols, keys, table


def device_engine(dev, main_filt, main_n: int, death_edges) -> dict:
    """The torch device engine (``repro_torch.core.device_engine``, the
    reference's ``core/jax_engine.py``) on the card.  ``h0_msf_mask`` on
    the main path's filtration (n = 50,000) must mark exactly the main
    path's union-find death edges.  One ``make_distributed_round`` over
    the 4-entry mesh of the card at ``launch/dryrun.py``'s
    ``ph_round_64k`` shape (256 columns an entry, width 64, 2^20 pivots,
    from a seed) must be bit-identical to the same call on a ``cpu x 4``
    mesh.  Prints the walls and the number of Borůvka rounds."""
    from repro_torch.core import device_engine as de
    from repro_torch.launch.mesh import make_data_mesh

    edges = torch.as_tensor(main_filt[0], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask, rounds = de._boruvka(edges, main_n)
    got = torch.nonzero(mask).flatten().cpu().numpy()
    msf_s = time.perf_counter() - t0
    if not np.array_equal(got, np.sort(death_edges)):
        raise AssertionError("device_engine: the Borůvka forest differs "
                             "from the main path's union-find")
    entries = DIST_SHARDS
    cols, keys, table = round_inputs(entries)
    walls = {}
    out = {}
    for where, mesh in (("cuda", card_mesh(dev, entries)),
                        ("cpu", make_data_mesh(entries,
                                               devices=["cpu"] * entries))):
        fn = de.make_distributed_round(mesh)
        first = mesh.devices.flat[0]
        args = [torch.as_tensor(a, device=first) for a in (cols, keys, table)]
        if where == "cuda":
            fn(*args)                          # warm-up: caches, allocator
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, lows = fn(*args)
        out[where] = (c.cpu().numpy(), lows.cpu().numpy())
        walls[where] = time.perf_counter() - t0
    for a, b in zip(out["cuda"], out["cpu"]):
        if not np.array_equal(a, b):
            raise AssertionError("device_engine: the distributed round "
                                 "differs between the card and the CPU")
    moved = int((out["cuda"][0] != cols).any(axis=1).sum())
    res = dict(n=main_n, n_e=int(edges.shape[0]), msf_s=msf_s,
               boruvka_rounds=rounds, msf_edges=int(mask.sum()),
               msf_equal_union_find=True, round_entries=entries,
               round_cols=ROUND_COLS * entries, round_width=ROUND_WIDTH,
               round_pivots=ROUND_PIVOTS, round_card_s=walls["cuda"],
               round_cpu_s=walls["cpu"], round_rows_changed=moved,
               round_equal_cpu=True)
    emit("device_engine", **res)
    return res


# ---------------------------------------------------------------------------
# phases 16 and 17: the Hi-C pair (paper §6, Fig. 21)
# ---------------------------------------------------------------------------

# benchmarks/suite.py at scale 1.0, as benchmarks/fig21_hic.py runs it.
HIC_SUITE_N, HIC_SUITE_LOOPS, HIC_SUITE_TAU = 350, 24, 0.6
FIG21_THRESHOLDS = (0.02, 0.05, 0.08)
# The regime examples/genome_hic.py documents (50,000 loci, 200 cohesin
# loops, the tiled backend at 2048 x 2048, one tau for both conditions from
# a 128 MiB budget, maxdim 1), cut so that the whole run stays inside its
# time limit.  Halving n alone would not cut the work: the budget sets the
# edge count (auxin's 2.4 M edges at 128 MiB at either n).  So the budget
# is cut too, to a quarter: auxin 0.59 M edges, about a quarter of the
# regime's, at tau 0.0305.
HIC_N, HIC_LOOPS, HIC_BUDGET_MIB, HIC_TILE = 25_000, 200, 32, 2048


def timed(fn):
    """(fn(), seconds): host clock around the call and a synchronise."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def fig21_counts(pd: np.ndarray) -> dict:
    """Features whose persistence exceeds each Fig. 21 threshold, counted
    as ``benchmarks/fig21_hic.py`` counts them: an essential class (death
    infinite) counts at every threshold."""
    pers = pd[:, 1] - pd[:, 0]
    return {str(t): int((pers > t).sum()) for t in FIG21_THRESHOLDS}


def finite_and_essential(pd: np.ndarray) -> dict:
    """The classes above each Fig. 21 threshold, finite deaths and
    essential classes apart."""
    finite = np.isfinite(pd[:, 1])
    pers = pd[:, 1] - pd[:, 0]
    return {str(t): dict(finite=int(((pers > t) & finite).sum()),
                         essential=int(((pers > t) & ~finite).sum()))
            for t in FIG21_THRESHOLDS}


def coo_triplets(iu, ju, lens, n: int, seed: int = 0):
    """Harvested edges as a contact map gives them: every pair also
    reversed, a duplicate of each at a larger value (the shorter
    measurement must win) and diagonal entries, shuffled."""
    rng = np.random.default_rng(seed)
    diag = rng.integers(0, n, size=max(1, n // 100))
    rows = np.concatenate([iu, ju, ju, diag])
    cols = np.concatenate([ju, iu, iu, diag])
    vals = np.concatenate([lens, lens, lens + 1.0, np.zeros(diag.size)])
    perm = rng.permutation(rows.size)
    return rows[perm], cols[perm], vals[perm]


def hic_suite(dev) -> dict:
    """The suite's Hi-C pair on the card, one call after another: each
    condition through the batch engine (as ``fig21_hic.py`` runs it) and the
    packed engine, both on the tiled harvest, and the control also through
    the packed engine over ``build_filtration_coo`` of the card's harvest.
    Every diagram must equal the batch engine's, and H1 at the thresholds
    >= 0.05 must fall under auxin, as ``fig21_hic.py`` gates it."""
    from repro_torch import compute_ph
    from repro_torch.data.pointclouds import hic_pair
    from repro_torch.scale import build_filtration_coo, harvest_edges

    out = {}
    for name, points in zip(("control", "auxin"),
                            hic_pair(HIC_SUITE_N, HIC_SUITE_LOOPS, seed=1)):
        runs = {"batch": dict(points=points, engine="batch",
                              backend="tiled"),
                "packed": dict(points=points, engine="packed",
                               backend="tiled")}
        if name == "control":
            iu, ju, lens = harvest_edges(points=points, tau_max=HIC_SUITE_TAU,
                                         backend="kernel", device=dev)
            runs["packed_coo"] = dict(engine="packed",
                                      filtration=build_filtration_coo(
                                          *coo_triplets(iu, ju, lens,
                                                        len(points)),
                                          n=len(points),
                                          tau_max=HIC_SUITE_TAU))
        results, walls, launches = {}, {}, {}
        for run, kw in runs.items():
            counters = reset_counters()
            results[run], walls[run] = timed(lambda: compute_ph(
                tau_max=HIC_SUITE_TAU, maxdim=2, device=dev, **kw))
            launches[run] = {k: counters[k].launches for k in PH_KERNELS}
            if "points" in kw and launches[run]["pairwise_sq_dists"] <= 0:
                raise AssertionError(f"hic_suite {name} {run}: the tiled "
                                     "harvest never launched the kernel")
        ref = results["batch"]
        check_diagrams(ref, 2, f"hic_suite {name}")
        for run, res in results.items():
            for d in range(3):
                if not np.array_equal(res.diagrams[d], ref.diagrams[d]):
                    raise AssertionError(f"hic_suite {name}: H{d} of {run} "
                                         "differs from the batch engine's")
        out[name] = dict(
            n_e=int(ref.stats["n_e"]), pairs=n_pairs(ref), wall_s=walls,
            launches=launches,
            essential={f"H{d}": int(np.isinf(ref.diagrams[d][:, 1]).sum())
                       for d in (1, 2)},
            counts={f"H{d}": fig21_counts(ref.diagrams[d]) for d in (1, 2)})
    table = [dict(dim=f"H{d}", threshold=t,
                  control=out["control"]["counts"][f"H{d}"][str(t)],
                  auxin=out["auxin"]["counts"][f"H{d}"][str(t)])
             for t in FIG21_THRESHOLDS for d in (1, 2)]
    for row in table:
        row["pct_change"] = (100.0 * (row["auxin"] - row["control"])
                             / max(row["control"], 1))
    emit("hic_suite", n=HIC_SUITE_N, loops=HIC_SUITE_LOOPS,
         tau_max=HIC_SUITE_TAU, maxdim=2, identical=True, fig21=table, **out)
    for row in table:
        if row["dim"] == "H1" and row["threshold"] >= 0.05 \
                and not row["pct_change"] < 0:
            raise AssertionError(f"hic_suite: H1 at {row['threshold']} does "
                                 "not fall under auxin (Fig. 21)")
    return out


def hic_path(dev) -> dict:
    """The example's regime on the card, cut to half its loci and a
    quarter of its budget (``HIC_N``, ``HIC_BUDGET_MIB``): one tau for both conditions (the smaller of
    ``estimate_tau_max`` at the budget of each), each condition
    through ``compute_ph(engine="packed", backend="tiled")`` under the
    profiler, with the counts set to 0 just before it.  At that tau the classes above 0.05 can only be
    essential ones, so the H1 counts are printed finite and essential apart
    and nothing is gated on their direction.  Held: all four PH kernels
    launch on auxin; the auxin harvest equals a harvest through the plain
    pairwise version, and its serial pre-pass inputs replay exactly through
    the kernel and the plain version; the control's card harvest, as COO
    triplets, builds a filtration equal field by field to
    ``build_filtration_tiled``."""
    from repro_torch import compute_ph
    from repro_torch.data.pointclouds import hic_pair
    from repro_torch.scale import (build_filtration_coo,
                                   build_filtration_tiled, estimate_tau_max,
                                   harvest_edges)

    control, auxin = hic_pair(HIC_N, n_loops=HIC_LOOPS, seed=1)
    budget = HIC_BUDGET_MIB * 2**20
    taus = {"control": estimate_tau_max(control, budget),
            "auxin": estimate_tau_max(auxin, budget)}
    tau = min(taus.values())
    if not np.isfinite(tau):
        raise AssertionError("hic_path: the budget does not bind")

    def condition(name, points):
        counters = reset_counters()
        (res, wall), evs = profiled(lambda: timed(lambda: compute_ph(
            points=points, maxdim=1, engine="packed", backend="tiled",
            tile_m=HIC_TILE, tile_n=HIC_TILE, tau_max=tau, device=dev)))
        launches = {k: counters[k].launches
                    for k in PH_KERNELS + OFF_PATH_KERNELS}
        check_diagrams(res, 1, f"hic_path {name}")
        st = res.stats
        return dict(n_e=int(st["n_e"]), wall_s=wall,
                    t_filtration=st["t_filtration"], t_h0=st["t_h0"],
                    t_h1=st["t_h1"], t_h1_share=st["t_h1"] / wall,
                    pairs=n_pairs(res), launches=launches,
                    h1_n_rounds=st["h1_n_rounds"],
                    h1_n_reductions=st["h1_n_reductions"],
                    h1=finite_and_essential(res.diagrams[1]),
                    **path_profile(evs, wall))

    out = {"control": condition("control", control)}
    serial = SerialTap()
    with serial:
        out["auxin"] = condition("auxin", auxin)
    for k in PH_KERNELS:
        if out["auxin"]["launches"][k] <= 0:
            raise AssertionError(f"hic_path auxin never launched {k}")

    harvest_held(dev, auxin, tau, out["auxin"]["n_e"], "hic_path auxin")
    (coo, tiled), coo_s = timed(lambda: (
        build_filtration_coo(*coo_triplets(*harvest_edges(
            points=control, tau_max=tau, tile_m=HIC_TILE, tile_n=HIC_TILE,
            backend="kernel", device=dev), HIC_N), n=HIC_N, tau_max=tau),
        build_filtration_tiled(points=control, tau_max=tau, device=dev)))
    assert_filtrations_equal(coo, tiled, "hic_path: COO against tiled")
    if coo.n_e != out["control"]["n_e"]:
        raise AssertionError("hic_path: the COO edge count differs from "
                             "compute_ph's")
    emit("hic_path", n=HIC_N, loops=HIC_LOOPS, budget_mib=HIC_BUDGET_MIB,
         tile=HIC_TILE, tau_estimates=taus, tau_max=tau, maxdim=1,
         harvest_identical_to_plain=True, coo_equals_tiled=True,
         coo_check_s=coo_s, **out)
    serial_replay(dev, serial, out["auxin"]["launches"]["gf2_serial_reduce"],
                  "hic_serial_replay")
    return out


# ---------------------------------------------------------------------------
# phase 18: the static correctness gates (repro_torch.analyze)
# ---------------------------------------------------------------------------

CANDIDATE_ROUND = "scale.shard._candidate_round_fn"
EXCHANGE_ROUND = "core.packed_reduce._exchange_round_fn"


def analyze(dev) -> dict:
    """``python -m repro_torch.analyze``'s two gates on the card.  The
    port's lint over the checkout: no unjustified finding, the counts by
    rule printed.  ``check_repo(device=dev)``: every registered mesh
    program on ``card_mesh(dev)`` with no violation, each schedule equal to
    the registry's and to the ``cpu x 4`` run's.  The candidate round, with
    the counts set to 0 just before it, launches ``pairwise_sq_dists``
    once an entry (4) and its candidate lists equal the ``cpu x 4`` run's;
    the exchange round gathers the uneven wire buffer bit for bit, and
    ``_make_exchange`` over the card mesh returns the loop-back's
    payloads."""
    from repro_torch.analyze import collectives
    from repro_torch.analyze.lint import _iter_python_files, lint_paths
    from repro_torch.core.packed_reduce import _make_exchange
    from repro_torch.kernels.gf2 import unstack_wire_payloads

    t0 = time.perf_counter()
    files = _iter_python_files(HERE)
    findings = lint_paths(HERE, files=files)
    by_rule: dict = {}
    for f in findings:
        entry = by_rule.setdefault(f.rule, {"allowed": 0, "unjustified": 0})
        entry["allowed" if f.allowed else "unjustified"] += 1
    bad = [f.format() for f in findings if not f.allowed]
    if bad:
        raise AssertionError("analyze: unjustified lint findings:\n"
                             + "\n".join(bad))
    lint_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    schedules, violations = collectives.check_repo(device=dev)
    check_s = time.perf_counter() - t0
    cpu_schedules, cpu_violations = collectives.check_repo(device="cpu")
    if violations or cpu_violations:
        raise AssertionError("analyze: collective violations: " + "; ".join(
            map(str, violations + cpu_violations)))
    signatures = {s.where: s.signature() for s in schedules}
    registry = {p.name: p.expect
                for p in collectives.repo_programs(device=dev)}
    if not (signatures == registry ==
            {s.where: s.signature() for s in cpu_schedules}):
        raise AssertionError(f"analyze: the card's schedules {signatures} "
                             f"differ from the registry's {registry} or the "
                             "cpu x 4 run's")

    card = {p.name: p for p in collectives.repo_programs(device=dev)}
    cpu = {p.name: p for p in collectives.repo_programs(device="cpu")}
    fn, args, _, mesh = card[CANDIDATE_ROUND].build()
    if [str(d) for d in mesh.devices.flat] != \
            [str(d) for d in card_mesh(dev).devices.flat]:
        raise AssertionError(f"analyze: the registry's mesh is {mesh}")
    counters = reset_counters()
    found = fn(*args)
    torch.cuda.synchronize()
    launches = counters["pairwise_sq_dists"].launches
    cpu_fn, cpu_args, _, _ = cpu[CANDIDATE_ROUND].build()
    want = cpu_fn(*cpu_args)
    if launches != len(want) or len(want) != DIST_SHARDS:
        raise AssertionError(f"analyze: the candidate round launched "
                             f"pairwise_sq_dists {launches} times, not once "
                             f"for each of {len(want)} entries")
    if sorted(found) != sorted(want) or not all(
            np.array_equal(a, b) for k in want
            for a, b in zip(found[k], want[k])):
        raise AssertionError("analyze: the candidate round's lists differ "
                             "from the cpu x 4 run's")

    fn, _, alt_args, mesh = card[EXCHANGE_ROUND].build()
    buf = alt_args[0]
    gathered = fn(buf)
    if gathered.device != mesh.devices.flat[0] or not np.array_equal(
            gathered.cpu().numpy().view(np.uint32), buf):
        raise AssertionError("analyze: the exchange round's gathered buffer "
                             "differs from the stacked wire")
    sizes = (0, 1, 7, 1000)
    payloads = [np.arange(n, dtype=np.uint32) % 97 for n in sizes]
    lens = np.array(sizes, dtype=np.int64)
    over_mesh = _make_exchange(mesh)(payloads)
    loop_back = _make_exchange(None)(payloads)
    if not all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in
               zip(over_mesh, loop_back, unstack_wire_payloads(buf, lens))):
        raise AssertionError("analyze: the exchange over the card mesh "
                             "differs from the loop-back")
    out = dict(lint_files=len(files),
               lint_by_rule=by_rule, lint_unjustified=0, lint_s=lint_s,
               programs={k: [[name, list(axes)] for name, axes in v]
                         for k, v in signatures.items()},
               violations=0, check_repo_s=check_s,
               candidate_launches=launches,
               candidate_pairs={str(k): int(len(v[0]))
                                for k, v in sorted(found.items())},
               candidate_equal_cpu=True, exchange_shape=list(buf.shape),
               exchange_payload_words=list(sizes),
               exchange_equal_loopback=True)
    emit("analyze", **out)
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: token serving at full width
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3-0.6b"
SERVE_SLOTS, SERVE_PROMPT, SERVE_S_MAX, SERVE_NEW = 8, 2048, 2112, 32
SERVE_MIN_PROMPT = 1024
SERVE_SPANS = ("serve/prefill", "serve/decode")
# The kernel route and _sdpa_masked round alike (bf16 inputs, float32
# scores and sums, P rounded to bf16 before P.V, one rounding of the
# output) but sum in another order, and the kernel scales its scores in the
# exp2 domain.  Each attention output is held to the bf16 contract of 3e-2
# (tests/test_kernels.py); the prefill logits of the two routes, after 28
# layers, are held to the same relative contract: atol = 3e-2 * max(1,
# max |logits|).
SERVE_CONTRACT = 3e-2


def serve_requests(cfg, n: int, seed: int = 0, lo: int = SERVE_MIN_PROMPT,
                   hi: int = SERVE_PROMPT, max_new: int = SERVE_NEW):
    """``n`` requests of ``lo`` to ``hi`` prompt tokens, ``max_new`` new
    tokens each."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=uid, prompt=rng.integers(
        0, cfg.vocab_size, size=int(rng.integers(lo, hi + 1)),
        dtype=np.int32), max_new=max_new) for uid in range(n)]


def busy_within(intervals, lo: float, hi: float) -> float:
    """Length of the union of sorted (start, end) intervals inside [lo, hi]."""
    total, end = 0.0, lo
    for s, e in intervals:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def by_kernel(evs, spans=None) -> dict:
    """{name: (launches, device µs)} over device events, or over those
    that start inside one of the (start, end) ``spans``."""
    out = {}
    for ev in evs:
        if spans is not None and not any(
                lo <= ev.time_range.start < hi for lo, hi in spans):
            continue
        n, us = out.get(ev.name, (0, 0.0))
        out[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    return out


def profiled_serving(engine, counters, symbol: str = FLASH_SM90) -> dict:
    """Drain ``engine`` under ``torch.profiler``: the window's wall (timed
    inside the profiler), the card's busy and idle share over it and inside
    the ``serve/prefill`` and ``serve/decode`` spans, the flash kernels'
    launches (those of kernel ``symbol`` apart) and device seconds, and the
    kernels with the most device time, over the window and over those that
    start inside a prefill span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import Tracer, tracing

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with tracing(Tracer(bridge=True)):
            engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = prof.events()
    dev = device_events(evs, SERVE_SPANS)
    intervals = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in dev)
    busy_s = busy_us(dev) / 1e6
    phases = {}
    for name in SERVE_SPANS:
        spans = [ev for ev in evs if ev.name == name
                 and ev.device_type == DeviceType.CPU]
        span_us = sum(ev.time_range.elapsed_us() for ev in spans)
        busy = sum(busy_within(intervals, ev.time_range.start,
                               ev.time_range.end) for ev in spans)
        phases[name] = dict(n=len(spans), wall_s=span_us / 1e6,
                            device_busy_s=busy / 1e6,
                            device_idle_share=(1.0 - busy / span_us)
                            if span_us else None)
    prefill = [(ev.time_range.start, ev.time_range.end) for ev in evs
               if ev.name == "serve/prefill"
               and ev.device_type == DeviceType.CPU]
    by_name = by_kernel(dev)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top_prefill = sorted(by_kernel(dev, prefill).items(),
                         key=lambda kv: -kv[1][1])[:10]
    flash = [(k, n, us) for k, (n, us) in by_name.items()
             if "flash_attention" in k and "kernel" in k]
    named = [f for f in flash if symbol in f[0]]
    return dict(
        wall_s=wall, device_busy_s=busy_s,
        device_idle_share=(1.0 - busy_s / wall) if dev else None,
        phases=phases, flash_launches=counters["flash_attention"].launches,
        flash_kernels=[k[:100] for k, _, _ in flash],
        flash_profiled_launches=sum(n for _, n, _ in flash),
        flash_symbol=symbol,
        flash_symbol_launches=sum(n for _, n, _ in named),
        flash_device_s=sum(us for _, _, us in flash) / 1e6,
        top_kernels=[dict(name=k[:100], launches=n, device_s=us / 1e6)
                     for k, (n, us) in top],
        prefill_top_kernels=[dict(name=k[:100], launches=n,
                                  device_s=us / 1e6)
                             for k, (n, us) in top_prefill])


def serve(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import count_params, init_params
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_prefill_step

    cfg = get_config(SERVE_ARCH)
    prefill = make_prefill_step(cfg)
    model = init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(cfg, params=model, max_batch=SERVE_SLOTS,
                         prompt_len=SERVE_PROMPT, s_max=SERVE_S_MAX,
                         device=dev)
    requests = serve_requests(cfg, 16)
    for req in requests:
        engine.submit(req)
    counters = reset_counters()
    tr = Tracer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tracing(tr):
        done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters["flash_attention"].launches
    if launches <= 0:
        raise AssertionError("serving never launched flash_attention")
    if sorted(done) != list(range(16)) or any(
            len(t) != SERVE_NEW or not all(0 <= x < cfg.padded_vocab
                                           for x in t)
            for t in done.values()):
        raise AssertionError("serving returned malformed generations")
    prefill_s = [sp.dur for sp in tr.spans if sp.name == "serve/prefill"]
    decode_s = [sp.dur for sp in tr.spans if sp.name == "serve/decode"]
    n_tokens = sum(len(t) for t in done.values())
    out = dict(
        arch=cfg.name, n_params=count_params(model),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        kv_cache_bytes=cache_bytes(cfg, SERVE_SLOTS, SERVE_S_MAX),
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        requests=16, slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
        s_max=SERVE_S_MAX, max_new=SERVE_NEW, wall_s=wall,
        prefill_s=prefill_s, decode_ms_mean=float(np.mean(decode_s)) * 1e3,
        decode_ms_median=float(np.median(decode_s)) * 1e3,
        n_decode_steps=len(decode_s), generated_tokens=n_tokens,
        tokens_per_s=n_tokens / wall,
        prompt_tokens=sum(min(len(r.prompt), SERVE_PROMPT)
                          for r in requests),
        flash_launches=launches, stats=engine.stats())

    # One more epoch (a prefill and 8 decode steps) under the profiler; the
    # serving spans show in its trace (record_function), so each phase's
    # device busy share is read inside its own spans.
    for req in serve_requests(cfg, SERVE_SLOTS, seed=1):
        req.max_new = 9
        engine.submit(req)
    window = out["profiled_window"] = profiled_serving(engine,
                                                       reset_counters())
    n_prefill = window["phases"]["serve/prefill"]["n"]
    if not (n_prefill >= 1
            and window["flash_launches"] == cfg.n_layers * n_prefill
            and window["flash_symbol_launches"] == window["flash_launches"]
            and window["flash_profiled_launches"]
            == window["flash_launches"]):
        raise AssertionError(
            f"profiled epoch: {window['flash_launches']} flash launches "
            f"counted, {window['flash_symbol_launches']} of "
            f"{window['flash_profiled_launches']} profiled ones the tensor-"
            f"core kernel ({FLASH_SM90}), for {n_prefill} prefills of "
            f"{cfg.n_layers} layers")
    # The first epoch's prefill through the kernel and through _sdpa_masked.
    out["seam"] = prefill_routes(model, prefill, requests, dev, counters,
                                 SERVE_CONTRACT)
    emit("serve", **out)
    check_seam(out["seam"])
    return out


def prefill_routes(model, prefill, requests, dev, counters,
                   contract: float, slots: int = SERVE_SLOTS,
                   prompt: int = SERVE_PROMPT) -> dict:
    """One epoch's prefill (the first ``slots`` requests, left-padded to
    ``prompt``) through the flash kernel as served and through
    ``_sdpa_masked``, each timed after a warm-up; the logits' largest
    difference against ``contract * max(1, max |logits|)``, the positions
    whose logits differ by more, the quantiles of a position's largest
    difference, and the greedy first tokens of both.  On
    a model with MoE blocks, one more untimed prefill a route records each
    block's router top-k a token (:func:`moe_routes`): the tokens whose
    expert set differs between the routes, layer by layer."""
    from repro_torch.serve.steps import sample_greedy

    toks = np.zeros((slots, prompt), dtype=np.int32)
    for i, req in enumerate(requests[:slots]):
        toks[i, -len(req.prompt):] = req.prompt[-prompt:]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    # Explicit positions, though they are arange, take _sdpa_masked.
    seam = dict(batch, positions=torch.arange(
        prompt, device=dev).expand(slots, prompt))

    def timed_prefill(b):
        prefill(model, b)                         # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(model, b)[0]
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    with torch.inference_mode():
        before = counters["flash_attention"].launches
        flash_logits, flash_s = timed_prefill(batch)
        mid = counters["flash_attention"].launches
        sdpa_logits, sdpa_s = timed_prefill(seam)
        if mid == before or counters["flash_attention"].launches != mid:
            raise AssertionError("the seam's prefill routes are not the "
                                 "flash kernel and _sdpa_masked")
        row_diff = (flash_logits - sdpa_logits).abs().amax(-1)
        diff = float(row_diff.max())
        scale = max(1.0, float(sdpa_logits.abs().max()))
        rows_over = int((row_diff > contract * scale).sum())
        row_q = torch.quantile(row_diff.float().flatten(), torch.tensor(
            [0.5, 0.99, 0.999], device=dev)).tolist()
        del row_diff
        flash_tok = sample_greedy(flash_logits)[:, 0]
        sdpa_tok = sample_greedy(sdpa_logits)[:, 0]
        agree = float((flash_tok == sdpa_tok).float().mean())
    del flash_logits, sdpa_logits
    torch.cuda.empty_cache()
    out = dict(prefill_s_flash=flash_s, prefill_s_sdpa=sdpa_s,
               logits_max_abs_diff=diff, logits_max_abs=scale,
               atol=contract * scale, positions_over_atol=rows_over,
               position_diff_q50_q99_q999=row_q,
               positions=int(toks.size), first_token_agreement=agree,
               first_tokens_flash=flash_tok.tolist(),
               first_tokens_sdpa=sdpa_tok.tolist())
    if any(getattr(b, "moe", False) for b in model.blocks):
        flash_top = moe_routes(model, prefill, batch)
        sdpa_top = moe_routes(model, prefill, seam)
        out["moe_tokens_rerouted"] = [
            int((a != b).any(-1).sum()) for a, b in zip(flash_top, sdpa_top)]
    return out


def moe_routes(model, prefill, batch) -> list:
    """Each MoE block's router top-k experts a token (sorted), from forward
    pre-hooks on one prefill of ``batch``, as ``moe_apply`` computes them."""
    tops = []

    def tap(mod, args):
        m = mod.cfg.moe
        h = args[0]
        xf = h.reshape(-1, h.shape[-1]).to(mod.cfg.cdtype)
        probs = torch.softmax(xf.float() @ mod.p["router"].float(), dim=-1)
        tops.append(torch.topk(probs, m.top_k, dim=-1)[1].sort(-1)[0])

    hooks = [b.ffn.register_forward_pre_hook(tap) for b in model.blocks
             if b.moe]
    try:
        with torch.inference_mode():
            prefill(model, batch)
    finally:
        for hk in hooks:
            hk.remove()
    return tops


def check_seam(seam: dict) -> None:
    if not seam["logits_max_abs_diff"] <= seam["atol"]:
        raise AssertionError(
            f"prefill logits: kernel route vs _sdpa_masked differ by "
            f"{seam['logits_max_abs_diff']} > {seam['atol']}")


# The float32 routes differ only in summation order (float32 scores, sums
# and probabilities in both, TF32 off), about 1e-6 of |o| an attention
# output; after 28 layers the logits are held to 1e-3 of their largest.
SERVE_F32_CONTRACT = 1e-3


def serve_f32(dev) -> dict:
    """One epoch of full-width qwen3-0.6b computing in float32: 8 requests
    (prompts left-padded to ``SERVE_PROMPT`` tokens), one prefill and one
    decode step, under the profiler; every flash launch must be the
    float32 SIMT kernel, one a layer.  Then the epoch's prefill through the
    kernel and through ``_sdpa_masked``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_prefill_step

    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              compute_dtype="float32")
    model = init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(cfg, params=model, max_batch=SERVE_SLOTS,
                         prompt_len=SERVE_PROMPT, s_max=SERVE_S_MAX,
                         device=dev)
    requests = serve_requests(cfg, SERVE_SLOTS, seed=2)
    for req in requests:
        req.max_new = 1
        engine.submit(req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window = profiled_serving(engine, reset_counters(), FLASH_F32)
    launches = window["flash_launches"]
    if not (window["phases"]["serve/prefill"]["n"] == 1
            and launches == cfg.n_layers
            and window["flash_symbol_launches"] == launches
            and window["flash_profiled_launches"] == launches):
        raise AssertionError(
            f"float32 epoch: {launches} flash launches counted, "
            f"{window['flash_symbol_launches']} of "
            f"{window['flash_profiled_launches']} profiled ones the float32 "
            f"kernel ({FLASH_F32}), for one prefill of {cfg.n_layers} layers")
    if len(engine.done) != SERVE_SLOTS:
        raise AssertionError("the float32 epoch did not complete every "
                             "request")
    out = dict(arch=cfg.name, compute_dtype=cfg.compute_dtype,
               slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
               flash_launches=launches, profiled_window=window)
    out["seam"] = prefill_routes(model, make_prefill_step(cfg), requests, dev,
                                 reset_counters(), SERVE_F32_CONTRACT)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit("serve_f32", **out)
    check_seam(out["seam"])
    del engine, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: training on one card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-0.6b"
# 4 microbatches, not 2: at 2 the step peaked at 64.04 GB of device memory
# (float32 attention scores and logits saved for the backward pass), over
# the 60 GB the run allows itself beside the serving phases' caches.
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 10, 8, 1024, 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
TRAIN_MAX_PEAK = 60e9
# Card against CPU (float32 compute, TF32 off): the loss and the gradient
# norm within a relative 1e-4.  After one AdamW step from zero moments each
# weight moves by lr * (m̂ / (sqrt(v̂) + eps) + wd * p) with |m̂ / (sqrt(v̂) +
# eps)| <= 1, so a gradient whose sign differs between the devices (one
# near zero) moves a weight 2 lr apart; every other weight agrees to float32
# rounding.  Held: the largest difference at most 2 lr, the 99.9th
# percentile within TRAIN_P999_TOL, the median within TRAIN_MEDIAN_TOL.
TRAIN_REL_TOL = 1e-4
TRAIN_P999_TOL = 1e-6
TRAIN_MEDIAN_TOL = 1e-7
# examples/train_lm.py's learning run and its gate
LEARN_STEPS, LEARN_BATCH, LEARN_SEQ, LEARN_RESUME_TO = 300, 16, 64, 310


def op_group(name: str) -> str:
    """A device operation's kind, from its kernel name: the float32 matrix
    products (``f32f32`` / ``sgemm`` kernels: TF32 is off) and the others
    (the bf16 ones; cuBLAS names its Hopper kernels ``nvjet``), dtype casts
    and copies, the optimizer's multi-tensor kernels, softmax and
    log-sum-exp, and other elementwise work or reductions."""
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul_f32" if ("f32f32" in low or "sgemm" in low) \
            else "matmul_other"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy_cast"
    if "softmax" in low or "logsumexp" in low:
        return "softmax"
    return "elementwise_reduce"


def train_job(cfg, dev, **kw):
    from repro_torch.launch.train import TrainJob

    base = dict(cfg=cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, n_micro=TRAIN_MICRO, lr=TRAIN_LR,
                warmup=TRAIN_WARMUP, log_every=1, device=dev)
    return TrainJob(**dict(base, **kw))


def train_full_width(dev, counters) -> tuple:
    """``launch.train.run`` at the published width and depth, every step
    logged (its metrics read on the host, so each ``train/step`` span holds
    the step's device work), ``tda_monitor`` at step 0; the counts set to 0
    just before it.  Then ``tda_monitor`` held on the card
    (:func:`monitor_routes`) and one more step under ``torch.profiler``."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import ShardedTokenStream
    from repro_torch.launch.train import run
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.train import AdamW, make_train_step, warmup_cosine

    cfg = get_config(TRAIN_ARCH)
    job = train_job(cfg, dev, tda_every=TRAIN_STEPS)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Tracer()
    with tracing(tr), contextlib.redirect_stdout(io.StringIO()):
        out = run(job)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    step_s = [sp.dur for sp in tr.spans if sp.name == "train/step"]
    median_s = float(np.median(step_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        padded_vocab=cfg.padded_vocab, compute_dtype=cfg.compute_dtype,
        steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        n_micro=TRAIN_MICRO, n_params=sum(
            p.numel() for p in out["state"].params.parameters()),
        loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        lr=[h["lr"] for h in hist], step_s=step_s,
        median_step_s=median_s, tokens_per_s=tokens / median_s,
        wall_s=out["wall_s"], peak_device_bytes=peak, launches=launches,
        tda={k: v for k, v in hist[0].items() if k.startswith("tda_")})
    emit("train", **{k: v for k, v in res.items() if k != "profiled_step"})
    if not (len(hist) == TRAIN_STEPS and len(step_s) == TRAIN_STEPS
            and all(np.isfinite(res["loss"] + res["grad_norm"]))):
        raise AssertionError(f"full-width training: {len(hist)} steps "
                             f"logged, losses {res['loss']}, grad norms "
                             f"{res['grad_norm']}")
    if launches["flash_attention"] != cfg.n_layers or len(res["tda"]) != 3:
        raise AssertionError(
            f"tda_monitor: {launches['flash_attention']} flash launches for "
            f"one forward of {cfg.n_layers} layers, values {res['tda']}")
    if peak > TRAIN_MAX_PEAK:
        raise AssertionError(f"full-width training peaked at {peak} bytes "
                             f"> {TRAIN_MAX_PEAK:.0f}")
    stream = ShardedTokenStream(vocab=cfg.vocab_size,
                                global_batch=TRAIN_BATCH, seq=TRAIN_SEQ + 1)
    res["monitor"] = monitor_routes(out["state"].params, cfg,
                                    stream.batch_at(0), counters)

    opt = AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt, n_micro=TRAIN_MICRO)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(TRAIN_STEPS).items()}
    res["profiled_step"], state = profiled_step(step_fn, out["state"],
                                                batch, median_s)
    emit("train_profiled_step", **res["profiled_step"])
    return res, cfg, state, step_fn, stream


def profiled_step(step_fn, state, batch, median_s: float) -> tuple:
    """One train step under ``torch.profiler`` (CUDA activity only): the
    card's busy share, device seconds by kind of operation
    (:func:`op_group`) and the five longest device operations.  Returns
    (the step's profile, the new state)."""

    def one_step():
        nonlocal state
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, float(metrics["loss"])

    (prof_s, prof_loss), evs = profiled(one_step, host=False)
    if not evs:
        raise AssertionError("the profiled train step recorded no device "
                             "work")
    kernels = by_kernel(evs)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    busy = busy_us(evs) / 1e6
    groups = {}
    for k, (n, us) in kernels.items():
        g = op_group(k)
        groups[g] = groups.get(g, 0.0) + us / 1e6
    return dict(
        wall_s=prof_s, loss=prof_loss, device_busy_s=busy,
        device_busy_share=busy / prof_s,
        # the profiler slows the host's dispatch; against the unprofiled
        # median step the same device work is this share of the step
        device_busy_share_of_median_step=busy / median_s,
        device_ops=len(evs), device_s_by_group=groups,
        top_ops=[dict(name=k[:100], launches=n, device_s=us / 1e6)
                 for k, (n, us) in top]), state


def monitor_routes(model, cfg, batch_np, counters) -> dict:
    """``tda_monitor`` held on the card, on the trained model and the
    stream's step-0 batch: its forward (the monitor's sub-batch, 4 x 1,024
    tokens) through the flash kernel, as the monitor runs it, against
    ``_sdpa_masked`` (explicit positions) on the same tokens, the logits
    within ``SERVE_CONTRACT * max(1, max |logits|)``; then the monitor's
    three values against its PH part run on the CPU from the flash route's
    logits, which must agree exactly (the port's diagrams are the same on
    either device)."""
    from repro_torch.launch.train import _tda_summary, tda_monitor
    from repro_torch.models.transformer import forward

    dev = model.device
    toks = torch.from_numpy(batch_np["tokens"][:4, :-1]).to(dev)
    b, s = toks.shape
    seam = {"tokens": toks, "positions": torch.arange(
        s, device=dev).expand(b, s)}
    flash = counters["flash_attention"]
    with torch.no_grad():
        before = flash.launches
        flash_logits = forward(model, {"tokens": toks})[0]
        mid = flash.launches
        sdpa_logits = forward(model, seam)[0]
        route_launches = (mid - before, flash.launches - mid)
        diff = float((flash_logits - sdpa_logits).abs().max())
        scale = max(1.0, float(sdpa_logits.abs().max()))
        x = flash_logits[..., :64].to(torch.float64).cpu().numpy()
    del flash_logits, sdpa_logits
    start = flash.launches
    card = tda_monitor(model, cfg, batch_np)
    monitor_launches = flash.launches - start
    host = _tda_summary(x, "cpu")
    out = dict(tokens=[b, s], logits_max_abs_diff=diff, logits_max_abs=scale,
               atol=SERVE_CONTRACT * scale, card=card, cpu_from_flash=host,
               route_flash_launches=list(route_launches),
               monitor_flash_launches=monitor_launches)
    emit("train_monitor", **out)
    if route_launches != (cfg.n_layers, 0) \
            or monitor_launches != cfg.n_layers:
        raise AssertionError(
            f"tda_monitor's forward: {route_launches} flash launches "
            f"through the prefill route and _sdpa_masked, "
            f"{monitor_launches} in the monitor; {cfg.n_layers} layers")
    if not diff <= out["atol"]:
        raise AssertionError(f"tda_monitor's logits: the flash route and "
                             f"_sdpa_masked differ by {diff} > {out['atol']}")
    if card != host:
        raise AssertionError(f"tda_monitor on the card {card} != its PH "
                             f"part on the CPU {host}")
    return out


def train_checkpoint(dev, state, step_fn, stream) -> dict:
    """The full-width state (float32 params, m and v) through the
    checkpointer: ``save_async`` of the state, one train step while its
    thread writes, ``save`` of the new state, then ``restore`` with
    ``verify``; every leaf must equal the live state bit for bit."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train.train_step import train_state_to_arrays

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(TRAIN_STEPS + 1).items()}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(tmp, keep=2)
        t0 = time.perf_counter()
        ckpt.save_async(1, train_state_to_arrays(state), metadata={"step": 1})
        t1 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ckpt.wait()
        t3 = time.perf_counter()
        live = train_state_to_arrays(state)
        t4 = time.perf_counter()
        ckpt.save(2, live, metadata={"step": 2})
        t5 = time.perf_counter()
        restored, meta = ckpt.restore(live, verify=True)
        t6 = time.perf_counter()
        from repro_torch.dist.sharding import tree_flatten_with_path

        got = tree_flatten_with_path(restored)[0]
        want = tree_flatten_with_path(live)[0]
        unequal = [tuple(str(k) for k in kp) for (kp, a), (_, b)
                   in zip(want, got) if a.dtype != b.dtype
                   or not np.array_equal(a, b)]
        n_bytes = sum(a.nbytes for _, a in want)
        disk = sum(os.path.getsize(os.path.join(tmp, d, f))
                   for d in os.listdir(tmp)
                   for f in os.listdir(os.path.join(tmp, d)))
        steps = ckpt.all_steps()
    out = dict(leaves=len(want), state_bytes=n_bytes, disk_bytes=disk,
               async_host_copy_s=t1 - t0, step_while_writing_s=t2 - t1,
               async_wait_after_step_s=t3 - t2, host_copy_s=t4 - t3,
               save_s=t5 - t4, restore_verify_s=t6 - t5,
               total_s=t6 - t0, steps=steps, meta=meta)
    emit("train_checkpoint", **out)
    if unequal or len(got) != len(want) or meta != {"step": 2} \
            or steps != [1, 2]:
        raise AssertionError(f"checkpoint round trip: leaves {unequal[:5]} "
                             f"differ, {len(got)} of {len(want)} restored, "
                             f"metadata {meta}, steps {steps}")
    return out


def train_card_vs_cpu(dev, cfg, tokens=(1, 65), n_micro: int = 1,
                      line: str = "train_card_vs_cpu") -> dict:
    """One train step of ``cfg`` in float32 compute (TF32 off) on a batch
    of ``tokens`` (1 x 65 for the full-width model), in ``n_micro``
    microbatches, on the card and on the CPU from the card's weights
    (``params_to_arrays``); printed as ``line``."""
    from repro_torch.models.transformer import (params_from_arrays,
                                                params_to_arrays)
    from repro_torch.train import (AdamW, TrainState, init_train_state,
                                   make_train_step, warmup_cosine)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    step_fn = make_train_step(cfg32, opt, n_micro=n_micro)
    card = init_train_state(cfg32, opt, seed=0, device=dev)
    host_model = params_from_arrays(cfg32, params_to_arrays(card.params),
                                    "cpu").requires_grad_(True)
    host = TrainState(params=host_model,
                      opt=opt.init(dict(host_model.named_parameters())))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=tokens).astype(np.int32)
    t0 = time.perf_counter()
    card, card_m = step_fn(card, {"tokens": torch.from_numpy(toks).to(dev)})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host, host_m = step_fn(host, {"tokens": torch.from_numpy(toks)})
    t2 = time.perf_counter()
    lr = float(host_m["lr"])
    d = torch.cat([(a.detach() - b.detach().to(dev)).abs().flatten()
                   for a, b in zip(card.params.parameters(),
                                   host.params.parameters())])
    n = d.numel()
    worst = int(torch.argmax(d))
    out = dict(
        tokens=list(toks.shape), card_step_s=t1 - t0, cpu_step_s=t2 - t1,
        loss=(float(card_m["loss"]), float(host_m["loss"])),
        grad_norm=(float(card_m["grad_norm"]), float(host_m["grad_norm"])),
        lr=lr, weights=n,
        weight_diff_median=float(torch.kthvalue(d, (n + 1) // 2).values),
        weight_diff_p999=float(torch.kthvalue(d, math.ceil(0.999 * n))
                               .values),
        weight_diff_max=float(d[worst]),
        weights_over_1e_6=int((d > 1e-6).sum()))
    rel = [abs(a - b) / abs(b) for a, b in (out["loss"], out["grad_norm"])]
    out["rel_loss"], out["rel_grad_norm"] = rel
    out["aux_loss"] = (float(card_m["aux_loss"]), float(host_m["aux_loss"]))
    emit(line, **out)
    if not (max(rel) <= TRAIN_REL_TOL
            and out["weight_diff_max"] <= 2 * lr * (1 + 1e-3)
            and out["weight_diff_p999"] <= TRAIN_P999_TOL
            and out["weight_diff_median"] <= TRAIN_MEDIAN_TOL):
        raise AssertionError(f"card against CPU: {out}")
    return out


def train_learning(dev) -> dict:
    """``examples/train_lm.py``'s run on the card (reduced qwen3: 4 layers,
    d_model 256, 8 heads, d_ff 1,024, vocab 512; 300 steps of 16 x 64,
    n_micro 2, lr 1e-3, warmup 30), checkpointing every 100 steps; its gate
    ``final < first - 0.5``; then ``run(restore=True)`` to 310 steps must
    resume at step 300."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainJob, run

    cfg = get_config(TRAIN_ARCH).reduced(n_layers=4, d_model=256, n_heads=8,
                                         d_ff=1024, vocab=512)
    with tempfile.TemporaryDirectory() as tmp:
        job = TrainJob(cfg=cfg, steps=LEARN_STEPS, global_batch=LEARN_BATCH,
                       seq_len=LEARN_SEQ, n_micro=2, lr=1e-3, warmup=30,
                       ckpt_dir=tmp, ckpt_every=100, log_every=20,
                       device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            out = run(job)
            resumed = run(dataclasses.replace(job, steps=LEARN_RESUME_TO),
                          restore=True)
        steps = sorted(os.listdir(tmp))
    first, final = out["history"][0]["loss"], out["final_loss"]
    res = dict(arch=cfg.name, n_params=sum(
        p.numel() for p in out["state"].params.parameters()),
        first_loss=first, final_loss=final, wall_s=out["wall_s"],
        steps_per_s=LEARN_STEPS / out["wall_s"],
        resumed_steps=[h["step"] for h in resumed["history"]],
        resumed_final_loss=resumed["final_loss"], checkpoints=steps)
    emit("train_learning", **res)
    if not final < first - 0.5:
        raise AssertionError(f"loss did not drop: {first} -> {final}")
    if res["resumed_steps"][0] != LEARN_STEPS:
        raise AssertionError(f"restore=True resumed at "
                             f"{res['resumed_steps'][0]}, not {LEARN_STEPS}")
    return res


def train(dev) -> dict:
    """Phase 6: training on the card (``repro_torch.launch.train``)."""
    counters = kernel_counters()
    t0 = time.perf_counter()
    full, cfg, state, step_fn, stream = train_full_width(dev, counters)
    t1 = time.perf_counter()
    ckpt = train_checkpoint(dev, state, step_fn, stream)
    t2 = time.perf_counter()
    del state, step_fn
    torch.cuda.empty_cache()
    versus = train_card_vs_cpu(dev, cfg)
    t3 = time.perf_counter()
    torch.cuda.empty_cache()
    learn = train_learning(dev)
    t4 = time.perf_counter()
    out = dict(full_width=full, checkpoint=ckpt, card_vs_cpu=versus,
               learning=learn,
               part_s=dict(full_width=t1 - t0, checkpoint=t2 - t1,
                           card_vs_cpu=t3 - t2, learning=t4 - t3))
    emit("train_done", part_s=out["part_s"], phase_s=t4 - t0)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 6b and 6c: the MoE, MLA and larger dense architectures
# ---------------------------------------------------------------------------

# (arch, param_dtype, slots, prompt_len): two epochs of requests, the
# second warm.  deepseek-v2-lite-16b, glm4-9b and granite-34b keep their
# parameters in bfloat16 (the reference ModelConfig's own param_dtype
# setting): in float32 they take 62.8, 37.6 and 135.8 GB.  granite-34b's
# 67.9 GB leave about 15 GiB of the card, so it serves 2 slots of 512
# prompt tokens.
LM_ARCHS = (("granite-moe-1b-a400m", "float32", 8, 2048),
            ("deepseek-v2-lite-16b", "bfloat16", 8, 2048),
            ("glm4-9b", "bfloat16", 8, 2048),
            ("granite-34b", "bfloat16", 2, 512))
LM_EPOCHS = 2
# The profiled epoch: a prefill and one decode step.  The profiler's host
# side costs 2.5-5.5 s a decode step at these depths (a full epoch of 15
# took 40-86 s an architecture).
LM_PROFILED_NEW = 2
LM_NEW = 16
LM_MAX_PEAK = 76 * 2**30      # past this granite-34b's depth would be cut
LM_MAX_ALLOCATED = 2 * 2**30  # what earlier phases may leave on the card
LM_SAMPLE_ARCH = "granite-moe-1b-a400m"
# Training (phase 6c): full-width granite-moe-1b-a400m, 8 x 1,024 tokens a
# step (TRAIN_BATCH x TRAIN_SEQ) in 4 microbatches, tda_monitor at step 0.
TRAIN_MOE_ARCH = "granite-moe-1b-a400m"
TRAIN_MOE_STEPS, TRAIN_MOE_MICRO = 4, 4


def cache_bytes(cfg, slots: int, s_max: int) -> int:
    """The decode cache: MLA's latent and rotary key, ``(r + d_rope) ·
    layers · slots · S_max`` elements, or K and V, ``2 · layers · slots ·
    S_max · KV · head_dim``; in the compute dtype."""
    if cfg.mla is not None:
        per = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    else:
        per = 2 * cfg.n_kv_heads * cfg.head_dim_
    return per * cfg.n_layers * slots * s_max * cfg.cdtype.itemsize


def sample_on_card(model, cfg, dev) -> dict:
    """``sample_temperature`` on the card, on the model's logits for 8 x 64
    tokens: twice from one seed (equal), and at ``T = 1e-7`` (equal to
    ``sample_greedy``)."""
    from repro_torch.models.transformer import forward
    from repro_torch.serve.steps import sample_greedy, sample_temperature

    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 64)), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        logits = forward(model, {"tokens": toks})[0]
        draws = [sample_temperature(logits, torch.Generator(
            device=dev).manual_seed(7), 1.0) for _ in range(2)]
        other = sample_temperature(logits, torch.Generator(
            device=dev).manual_seed(8), 1.0)
        greedy = sample_greedy(logits)
        cold = sample_temperature(logits, torch.Generator(
            device=dev).manual_seed(7), 1e-7)
    out = dict(arch=cfg.name, rows=8, same_seed_equal=bool(
        torch.equal(draws[0], draws[1])),
        other_seed_equal=bool(torch.equal(draws[0], other)),
        t1_equal_greedy=int((draws[0] == greedy).sum()),
        cold_equal_greedy=bool(torch.equal(cold, greedy)),
        dtype=str(draws[0].dtype), shape=list(draws[0].shape))
    if not (out["same_seed_equal"] and out["cold_equal_greedy"]
            and out["shape"] == [8, 1] and draws[0].dtype == torch.int32):
        raise AssertionError(f"sample_temperature on the card: {out}")
    return out


def flash_launch_bound(cfg, window: dict, slots: int, prompt: int) -> dict:
    """The profiled prefill's mean flash launch against the least time of
    the function it computes: q and k at the query-key width, v and the
    output at the value width (MLA: 192 and 128; the kernel's zero-padded
    value columns are not work), read and written once in bf16, and
    ``2 (d_qk + d_v)`` operations an attended pair at the bf16 peak."""
    m = cfg.mla
    d_qk = m.nope_head_dim + m.rope_head_dim if m else cfg.head_dim_
    d_v = m.v_head_dim if m else cfg.head_dim_
    bh = slots * cfg.n_heads
    pairs = np.mean([attended_pairs(prompt, True, cfg.window_for_layer(i)
                                    or -1) for i in range(cfg.n_layers)])
    ms = window["flash_device_s"] * 1e3 / window["flash_profiled_launches"]
    b_ms, b_by = bound(2 * bh * prompt * (2 * d_qk + 2 * d_v),
                       2 * bh * pairs * (d_qk + d_v), BF16_TC_FLOPS_PER_S)
    return dict(shape=[bh, prompt, d_qk, d_v], ms=ms, bound_ms=b_ms,
                bound_by=b_by, bound_share=b_ms / ms)


def lm_arch(dev, arch: str, param_dtype: str, slots: int,
            prompt: int) -> dict:
    """One architecture at its published width through ``ServeEngine`` on
    the card, the counts set to 0 just before ``run``: ``LM_EPOCHS``
    epochs of ``slots`` requests, every request served with ``LM_NEW``
    tokens, one flash launch a layer a prefill (the bf16 kernel's
    ``launches``).  Then one more epoch, a prefill and one decode step,
    under ``torch.profiler`` (:func:`profiled_serving`): every flash
    launch the tensor-core kernel, the card's busy share in prefill and
    decode, the longest kernels.  Last, the first epoch's prefill through
    the flash kernel and through ``_sdpa_masked`` (:func:`prefill_routes`),
    the logits held to ``SERVE_CONTRACT``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import count_params, init_params
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_prefill_step

    cfg = dataclasses.replace(get_config(arch), param_dtype=param_dtype)
    # earlier phases' models can outlive their phase in reference cycles
    # until the collector runs (qwen3's training model, 2.68 GB, has)
    gc.collect()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    if allocated > LM_MAX_ALLOCATED:
        raise AssertionError(f"{arch}: {allocated} bytes still allocated "
                             f"by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s_max = prompt + LM_NEW
    engine = ServeEngine(cfg, params=model, max_batch=slots,
                         prompt_len=prompt, s_max=s_max, device=dev)
    n_req = LM_EPOCHS * slots
    requests = serve_requests(cfg, n_req, seed=3, lo=prompt // 2,
                              hi=prompt, max_new=LM_NEW)
    for req in requests:
        engine.submit(req)
    counters = reset_counters()
    tr = Tracer()
    t0 = time.perf_counter()
    with tracing(tr):
        done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    n_prefills = int(engine.stats()["serve_n_prefills"])
    prefill_s = [sp.dur for sp in tr.spans if sp.name == "serve/prefill"]
    decode_s = [sp.dur for sp in tr.spans if sp.name == "serve/decode"]
    n_tokens = sum(len(t) for t in done.values())
    held = sum(t.numel() * t.element_size()
               for layer in engine._cache["layers"] for t in layer)
    out = dict(
        arch=cfg.name, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_params=count_params(model),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        cache_bytes=cache_bytes(cfg, slots, s_max), cache_bytes_held=held,
        allocated_before=allocated, init_s=init_s, requests=n_req,
        slots=slots, prompt_len=prompt, s_max=s_max, max_new=LM_NEW,
        prompt_tokens=sum(min(len(r.prompt), prompt) for r in requests),
        wall_s=wall, prefills=n_prefills, prefill_s=prefill_s,
        decode_ms_mean=float(np.mean(decode_s)) * 1e3,
        decode_ms_median=float(np.median(decode_s)) * 1e3,
        n_decode_steps=len(decode_s), generated_tokens=n_tokens,
        tokens_per_s=n_tokens / wall, launches=launches)
    if sorted(done) != list(range(n_req)) or any(
            len(t) != LM_NEW or not all(0 <= x < cfg.padded_vocab
                                        for x in t)
            for t in done.values()):
        raise AssertionError(f"{arch}: malformed generations {done}")
    if launches["flash_attention"] != cfg.n_layers * n_prefills \
            or n_prefills < 1:
        raise AssertionError(f"{arch}: {launches['flash_attention']} flash "
                             f"launches for {n_prefills} prefills of "
                             f"{cfg.n_layers} layers")
    if held != out["cache_bytes"]:
        raise AssertionError(f"{arch}: the engine's cache holds {held} "
                             f"bytes, the formula {out['cache_bytes']}")
    for req in serve_requests(cfg, slots, seed=4, lo=prompt // 2, hi=prompt,
                              max_new=LM_PROFILED_NEW):
        engine.submit(req)
    window = out["profiled_window"] = profiled_serving(engine,
                                                       reset_counters())
    n_prof = window["phases"]["serve/prefill"]["n"]
    if not (n_prof == 1 and window["flash_launches"] == cfg.n_layers
            and window["flash_symbol_launches"] == cfg.n_layers
            and window["flash_profiled_launches"] == cfg.n_layers):
        raise AssertionError(
            f"{arch} profiled epoch: {window['flash_launches']} flash "
            f"launches counted, {window['flash_symbol_launches']} of "
            f"{window['flash_profiled_launches']} profiled ones the tensor-"
            f"core kernel, for {n_prof} prefills of {cfg.n_layers} layers")
    out["flash_launch"] = flash_launch_bound(cfg, window, slots, prompt)
    out["seam"] = prefill_routes(model, make_prefill_step(cfg), requests,
                                 dev, counters, SERVE_CONTRACT, slots, prompt)
    if arch == LM_SAMPLE_ARCH:
        out["sample_temperature"] = sample_on_card(model, cfg, dev)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit("lm_archs", **out)
    check_seam(out["seam"])
    if out["peak_device_bytes"] > LM_MAX_PEAK:
        raise AssertionError(f"{arch}: peak {out['peak_device_bytes']} "
                             f"bytes > {LM_MAX_PEAK}")
    del engine, model
    torch.cuda.empty_cache()
    return out


def lm_archs(dev) -> dict:
    """Phase 6b: the four architectures of the MoE/MLA slice, one after
    another, each freed before the next."""
    t0 = time.perf_counter()
    out = {arch: lm_arch(dev, arch, *rest) for arch, *rest in LM_ARCHS}
    emit("lm_archs_done", phase_s=time.perf_counter() - t0,
         flash_launches={a: r["launches"]["flash_attention"]
                         for a, r in out.items()})
    return out


def train_moe(dev) -> dict:
    """Phase 6c: ``launch.train.run`` on full-width granite-moe-1b-a400m
    (float32 parameters, bf16 compute, seed 0), ``TRAIN_MOE_STEPS`` steps
    of 8 x 1,024 tokens in ``TRAIN_MOE_MICRO`` microbatches, every step
    logged, ``tda_monitor`` at step 0 (one bf16 flash launch a layer); the
    counts set to 0 just before it.  Gates: finite losses and gradient
    norms, a positive aux loss every step, the peak under
    ``TRAIN_MAX_PEAK``.  Then one step of the reduced copy in float32 on
    the card and on the CPU, under ``train_card_vs_cpu``'s gates."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.obs.trace import Tracer, tracing

    from repro_torch.data.tokens import ShardedTokenStream
    from repro_torch.train import AdamW, make_train_step, warmup_cosine

    cfg = get_config(TRAIN_MOE_ARCH)
    job = train_job(cfg, dev, steps=TRAIN_MOE_STEPS, n_micro=TRAIN_MOE_MICRO,
                    tda_every=TRAIN_MOE_STEPS)
    torch.cuda.empty_cache()
    counters = reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Tracer()
    with tracing(tr), contextlib.redirect_stdout(io.StringIO()):
        out = run(job)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    step_s = [sp.dur for sp in tr.spans if sp.name == "train/step"]
    median_s = float(np.median(step_s[1:]))
    res = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
        compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
        steps=TRAIN_MOE_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        n_micro=TRAIN_MOE_MICRO, n_params=sum(
            p.numel() for p in out["state"].params.parameters()),
        loss=[h["loss"] for h in hist], aux=[h["aux_loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist], step_s=step_s,
        median_step_s=median_s, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
        / median_s, wall_s=out["wall_s"], peak_device_bytes=peak,
        launches=launches,
        tda={k: v for k, v in hist[0].items() if k.startswith("tda_")})
    emit("train_moe", **res)
    if not (len(hist) == TRAIN_MOE_STEPS
            and all(np.isfinite(res["loss"] + res["grad_norm"]))
            and all(a > 0 for a in res["aux"])):
        raise AssertionError(f"granite-moe training: losses {res['loss']}, "
                             f"aux {res['aux']}, grad norms "
                             f"{res['grad_norm']}")
    if launches["flash_attention"] != cfg.n_layers or len(res["tda"]) != 3:
        raise AssertionError(f"granite-moe tda_monitor: "
                             f"{launches['flash_attention']} flash launches "
                             f"for {cfg.n_layers} layers")
    if peak > TRAIN_MAX_PEAK:
        raise AssertionError(f"granite-moe training peaked at {peak} bytes "
                             f"> {TRAIN_MAX_PEAK:.0f}")
    stream = ShardedTokenStream(vocab=cfg.vocab_size,
                                global_batch=TRAIN_BATCH, seq=TRAIN_SEQ + 1)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(TRAIN_MOE_STEPS).items()}
    step_fn = make_train_step(cfg, AdamW(lr=warmup_cosine(
        TRAIN_LR, TRAIN_WARMUP, TRAIN_MOE_STEPS)), n_micro=TRAIN_MOE_MICRO)
    res["profiled_step"], _ = profiled_step(step_fn, out["state"], batch,
                                            median_s)
    emit("train_moe_profiled_step", **res["profiled_step"])
    del out, batch, step_fn
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = train_card_vs_cpu(
        dev, get_config(TRAIN_MOE_ARCH, reduced=True), tokens=(4, 65),
        n_micro=2, line="train_moe_card_vs_cpu")
    res["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return res


def f32_sass_check(_build, ptxas) -> dict:
    """The float32 flash library holds IEEE FFMA products only: its SASS
    (``cuobjdump -sass``) has no matrix-multiply opcode (HMMA, HGMMA, IMMA,
    ...: any opcode ending in MMA; ``HFMA2.MMA`` is a half-precision FMA
    that ptxas uses to zero registers), and no instantiation spills."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass",
                           str(_build.library_path("flash_attention"))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = {}
    opcode = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9]*)")
    for op in opcode.findall(sass):
        ops[op] = ops.get(op, 0) + 1
    mma = {op: n for op, n in ops.items() if op.endswith("MMA")}
    spills = [ln for ln in ptxas if "spill" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    entries = sum("Compiling entry" in ln for ln in ptxas)
    if mma or spills or entries != 4 or not ops.get("FFMA"):
        raise AssertionError(f"flash_attention.cu: matrix opcodes {mma}, "
                             f"spills {spills}, {entries} instantiations")
    return dict(ffma=ops["FFMA"], matrix_opcodes=0, spill_free=entries,
                instructions=sum(ops.values()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script (it "
              "runs from the root of a checkout); nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    build_s = _build.build()
    ptxas = {src: [ln.strip() for ln in _build.build_log(src).splitlines()
                   if any(w in ln for w in ("registers", "Compiling entry",
                                            "spill", "C75"))]
             for src in _build.SOURCES}
    emit("build", seconds=build_s, wall_s=time.perf_counter() - t0,
         sources=[f"{CSRC}/{s}.cu" for s in _build.SOURCES], ptxas=ptxas,
         flash_f32_sass=f32_sass_check(_build, ptxas["flash_attention"]))

    summary = check_kernels(dev)
    served = serve(dev)
    served_f32 = serve_f32(dev)
    trained = train(dev)
    archs = lm_archs(dev)
    moe_trained = train_moe(dev)
    tap, serial = RoundTap(CAPTURED_ROUNDS), SerialTap()
    path, main_res, main_filt, main_deaths = main_path(dev, MAIN_PATH_N, tap,
                                                       serial)
    round_step(dev, tap)
    cards = cross_check(dev)
    serial_replay(dev, serial, path["launches"]["gf2_serial_reduce"])
    del tap, serial
    meshed = mesh_path(dev, MAIN_PATH_N, main_res, main_filt,
                       path["tau_max"])
    del main_res
    dist, dist_diagrams = dist_path(dev, cards)
    checked = dist_check(dev, cards)
    o3_card = cards["o3"]
    del cards
    sph = serve_ph(dev)
    resil = resilience(dev, dist, dist_diagrams)
    sanitize(dev, o3_card, checked["o3"])
    device_engine(dev, main_filt, MAIN_PATH_N, main_deaths)
    del main_filt, main_deaths
    hic_suite(dev)
    hic = hic_path(dev)
    analyze(dev)
    launches = dict(path["launches"],
                    flash_attention_bf16=served["flash_launches"],
                    flash_attention_f32=served_f32["flash_launches"])
    def bf16(counted):
        # these runs compute in bf16: their flash launches (prefills and
        # tda_monitor's forward) are the bf16 kernel's
        out = dict(counted)
        out.update(flash_attention_bf16=out.pop("flash_attention"),
                   flash_attention_f32=0)
        return out

    train_launches = bf16(trained["full_width"]["launches"])
    lm_launches = {a: bf16(r["launches"]) for a, r in archs.items()}
    moe_train_launches = bf16(moe_trained["launches"])

    replaces = {
        "pairwise_sq_dists": ("csrc/pairwise_dist.cu",
                              "src/repro/kernels/pairwise_dist.py:38"),
        "gf2_find_low": ("csrc/gf2.cu", "src/repro/kernels/gf2.py:230"),
        "gf2_scatter_xor": ("csrc/gf2.cu", "src/repro/kernels/gf2.py:323"),
        "gf2_parallel_xor": ("csrc/gf2.cu", "src/repro/kernels/gf2.py:323"),
        "gf2_serial_reduce": ("csrc/gf2.cu", "src/repro/kernels/gf2.py:290"),
        "flash_attention_bf16": ("csrc/flash_attention_sm90.cu",
                                 "src/repro/kernels/flash_attention.py:72"),
        "flash_attention_f32": ("csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:72"),
    }
    def first(*xs):
        return next((x for x in xs if x is not None), None)

    kernels = []
    for kname, (src, ref) in replaces.items():
        e = summary[kname]
        # Device times from the profiler where it recorded them; else the
        # per-call times, which ``times_from`` then names.
        kernels.append(dict(
            name=kname, route="cuda",
            source="src/repro_torch/kernels/" + src, replaces=ref,
            launches=launches[kname], max_abs_err=e["max_abs_err"],
            ms=first(e["kernel_ms"], e["wrapper_ms"]),
            plain_ms=first(e["plain_ms"], e["plain_wall_ms"]),
            bound_ms=e["bound_ms"], bound_by=e["bound_by"],
            library_ms=first(e["library_ms"], e["library_wall_ms"]),
            times_from=("profiler" if e["kernel_ms"] is not None
                        else "per-call wall"),
            hic_launches={c: hic[c]["launches"].get(kname)
                          for c in ("control", "auxin")},
            dist_launches=dist["launches"].get(kname),
            mesh_launches=meshed["launches"].get(kname),
            serve_ph_launches=sph["launches"].get(kname),
            resilience_launches=resil["launches"].get(kname),
            train_launches=train_launches[kname],
            lm_archs_launches={a: n[kname] for a, n in lm_launches.items()},
            train_moe_launches=moe_train_launches[kname],
            wrapper_ms=e["wrapper_ms"], shape=e["shape"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
