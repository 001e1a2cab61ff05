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
   (``train_profiled_step``).  Then ``dryrun_check`` (phase 19).  (The
   full-width state's checkpoint round trip, ``save_async`` while a step
   runs and a verified ``restore``, was cut for time: ``train_mesh``
   writes and restores the meshed full-width state bit for bit, and
   ``tests/test_torch_checkpoint.py`` holds the unmeshed train state's
   round trip on the CPU.)
   One step of the same model cut to 4 of its 28 layers
   (``TRAIN_VS_CPU_LAYERS``) in float32 compute (TF32 off) on 1 x 65
   tokens on the card and on the CPU from the card's weights: loss and
   gradient norm within 1e-4 relative, the updated weights as
   ``TRAIN_*_TOL`` states (``train_card_vs_cpu``).  Then
   ``examples/train_lm.py``'s run cut from 300 steps to 100 (reduced
   qwen3, 16 x 64, checkpoints every 50): its gate ``final < first -
   0.5``, and ``run(restore=True)`` to 110 steps resuming at step 100
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
6f. ``train_mesh`` — the sharded trainer over the port's ``Mesh``
   (``MESH_*``), run after ``train_moe``: full-width qwen3-0.6b (float32
   parameters, bf16 compute) with ``TrainJob(mesh_shape=(4, 2))`` over
   ``["cuda:0"] * 8``, 2 steps of 8 x 512 tokens in 2 microbatches (one
   sequence a data entry, heads and MLP split in two), a checkpoint at
   every step (``save_async``), ``tda_monitor`` at step 0 (the counts set
   to 0 just before ``run``: one bf16 flash launch a layer and the PH
   kernels); then its last checkpoint restored onto a (2, 2) mesh
   (``restore(shardings=)``, every leaf bit for bit) and 1 more step.
   Beside it the unmeshed step at the same shape from the same seed.
   Printed: step s, tokens/s, peak bytes, the largest entry's bytes of
   parameters and moments, each collective's count and bytes a step, the
   restore's seconds, each number beside the card's name and power limit.
   Gates: finite losses, the first meshed loss within 1e-2 of the
   unmeshed one, the restored state equal to the saved one and resuming
   at step 2, the peak under 60
   GB.  Then full-width granite-moe-1b-a400m on (4, 2), 2 steps
   (``train_mesh_moe``: aux loss > 0, ``_moe_a2a`` on every MoE layer of
   every microbatch); then the other five families at published width on
   (4, 2), 2 steps of 8 rows in 2 microbatches, each cut in depth
   (``MESH_FAMILIES`` says how and why) and its counts set to 0 just
   before it (``train_mesh_families``, one line a model: step s, tokens/s,
   peak bytes, the largest entry's state bytes, each collective's count
   and bytes a step): deepseek-v2-lite-16b (3 layers, MLA, ``_moe_a2a`` on
   every MoE layer of every microbatch, aux loss > 0), recurrentgemma-9b
   (3 blocks, ``tda_monitor`` at step 0: one bf16 flash launch, its
   ``local_attn`` layer's) and xlstm-1.3b (8 blocks, 256 tokens) through
   ``TrainJob(mesh_shape=)``, qwen2-vl-2b (4 layers, 512 positions with a
   1 x 16 x 16 image grid) and whisper-small (12 + 12 layers, 1,500
   frames, 224 tokens) through the meshed step on their own batches;
   gates: finite losses and gradient norms, the peak under 60 GB.  Last,
   each reduced copy (qwen3, gemma3, granite-moe and the five) meshed on
   the card against meshed on the CPU in float32 under
   ``train_card_vs_cpu``'s gates (``train_mesh_card_vs_cpu``).
6g. ``serve_mesh`` — serving over the port's ``Mesh`` (``SERVE_MESH_*``),
   run after ``train_mesh``: full-width qwen3-0.6b (float32 parameters,
   bf16 compute, seed 0) through ``make_prefill_step``, ``extend_cache``
   and ``make_decode_step`` over (data 4, model 2) entries of the card
   (``["cuda:0"] * 8``; the parameters laid out by ``shard_params(...,
   fsdp=False)``, the activation rules bound): 8 rows of 1,024 prompt
   tokens, then 16 decode steps against a 1,040-slot cache whose
   sequence lies over ``model``.  The counts are set to 0 just before the
   meshed run and read just after: the prefill launches the bf16 flash
   kernel once a layer and (data, model) entry (28 x 8), and nothing
   else.  The same weights through the unmeshed steps first; the meshed
   decode is teacher-forced on the unmeshed greedy tokens, and the
   prefill's and every step's logits must lie within ``SERVE_CONTRACT *
   max(1, max |logits|)`` of the unmeshed ones (the greedy tokens that
   agree are printed).  Printed: prefill s, ``extend_cache`` s, decode ms
   a step, the largest entry's cache bytes, each collective's count and
   bytes in the prefill, ``extend_cache`` and a decode step, the peak,
   and one profiled decode step's busy share (``serve_mesh``).  Then
   full-width granite-moe-1b-a400m, one prefill and 4 decode steps held
   the same way, at a capacity factor of ``n_experts / top_k`` where
   neither dispatch drops a routing (``serve_mesh_moe``); last, qwen3 cut
   to 4 layers in float32 compute, 8 rows of 32 tokens and 4 decode
   steps, meshed on the card (the float32 flash kernel, 4 x 8 launches)
   against meshed on the CPU, within ``1e-4 * max |logits|``
   (``serve_mesh_card_vs_cpu``).
6d. ``ssm_archs`` — the recurrent blocks (``repro_torch.models.ssm``):
   xlstm-1.3b (cut to 8 of its 48 layers: 7 mLSTM, 1 sLSTM; 8 slots
   of 1,024-2,048 tokens left-padded to 2,048) and recurrentgemma-9b (26
   RG-LRU, 12 ``local_attn`` at window 2,048; 4 slots of 2,048-4,096
   tokens left-padded to 4,096) at published width, float32
   parameters, bf16 compute, seed 0, as ``lm_archs`` serves: one flash
   launch a ``local_attn`` layer a prefill (12; xlstm 0), the cache of
   each kind's state, recurrentgemma's seam; xlstm's profiled prefill
   records the CUDA activity alone (its sLSTM loop's host events would
   take minutes), its decode step host and card.  Each recurrent kind's
   block alone, and the RG-LRU scan, timed with its device launches
   (``recurrent_parts``).  Then each reduced copy card against CPU in
   float32: the forward's logits within ``1e-4 · max(1, max |logits|)``
   (``ssm_card_vs_cpu_forward``) and one train step of 1 x 65 tokens
   under ``train_card_vs_cpu``'s gates (``ssm_card_vs_cpu_train``).
6e. ``vlm_audio`` — the last two families: qwen2-vl-2b (M-RoPE, embedding
   inputs; 8 slots of a 2,048-position prompt of 16 text positions, one
   image of 1 x 32 x 32 merged patches and text, 16 new tokens) and
   whisper-small (the encoder-decoder; 8 slots of 1,500 encoder frames,
   224-token decoder prompts, 32 new tokens, ``s_max`` 256) at published
   width and depth, float32 parameters, bf16 compute, seed 0, served
   through ``make_prefill_step``, ``extend_cache`` and
   ``make_decode_step``: a cold and a warm prefill, each one bf16 flash
   launch an attention layer (qwen2-vl 28 causal; whisper 12 not causal
   over the frames, 12 causal over the prompt), greedy decode, the cache
   the formula's bytes (whisper's cross K/V left at 1,500 frames), a
   profiled prefill and decode step (busy shares, each flash launch
   group's ms against its bound), the seam under ``SERVE_CONTRACT``;
   then each reduced copy card against CPU in float32, a forward and one
   train step (``vlm_audio_card_vs_cpu_forward``, ``_train``).
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
   (packed engine, a 4 MiB admission account, 256 MiB of tenant cache, 4
   clouds a batch) on the card, in the shape of the reference launcher's
   ``run_ph`` traffic, under ``torch.profiler`` with the counts set to 0
   just before it: a cold wave of 4 clouds of 1,500 points
   (``rng.normal``, seed 0) at the 0.5 % quantile of pair lengths
   (``sample_pair_lengths``, seed 0), served as one union batch; an
   update wave of 4 requests alternating tau growth to 1.5x and the
   arrival of 64 points, each on its own cached cloud and served warm
   (the request at 3x tau that admission clamped was cut for time; the
   clamp is held on the CPU).  Every request at maxdim 1 (the
   service's default 2, cut for time).  Every response's path must be the
   planned one; the 4 warm responses and 2 of the cold wave must equal
   (H0, H1) a cold ``compute_ph`` on the card at the granted tau; ``gf2_find_low``
   and ``gf2_scatter_xor`` must launch.  A checkpoint saved and reloaded
   keeps its ``content_hash``; under a ``resume.load`` bit flip the
   reload raises ``CheckpointCorruption`` and a cold reduction through
   the engine's reducer gives the cached diagrams.  It prints the walls
   of both waves, requests/s, the cache-hit
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
    tau 0.6; the control at maxdim 2, auxin cut to maxdim 1), on the
    card, one call after another: each condition through the batch engine
    and the packed engine on the tiled harvest, and the control also
    through the packed engine over ``build_filtration_coo`` of the card's
    harvest (every pair also reversed, a duplicate at a larger value,
    diagonal entries).  Every diagram ``np.array_equal`` to the batch
    engine's; each run's wall and launches; the Fig. 21 table (H1
    features with persistence above 0.02, 0.05 and 0.08, auxin against
    control; the control's H2 counts beside it); H1 at 0.05 and 0.08 must
    fall under auxin, as ``fig21_hic.py`` gates it.
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
19. ``dryrun`` — ``repro_torch.launch.dryrun`` on fake CUDA tensors (the
    card's routes, nothing allocated): ``run_cell`` for qwen3-0.6b at its
    published width and depth on ``mesh_kind="card"`` for ``train_4k``
    (one microbatch traced, weighted by its 256), ``prefill_32k`` (one
    flash custom operator a layer) and ``decode_32k``, each line its peak,
    three roofline terms, dominant term, useful-FLOP ratio and trace
    seconds; ``long_500k`` a skip; then ``run_ph_cell("ph_round_64k",
    "entries")``.  Its check, ``dryrun_check``, runs inside phase 6 where
    the training state is alive: the trace of the ``train`` step (8 x
    1,024 tokens, 4 microbatches) must count the FLOPs that
    ``FlopCounterMode`` counts around a real step, exactly, and its peak
    (beside what else the card holds) must lie within 10 % of
    ``max_memory_allocated`` over one.  ``dryrun_done`` prints the
    phase's seconds, the check's included.

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
``lm_archs`` architecture, ``train_moe``, ``train_mesh``'s qwen3 run,
``serve_mesh``'s qwen3 run (its float32 check's for the float32 kernel),
each ``ssm_archs`` and each
``vlm_audio`` architecture) and, last, ``{"ok": true,
"device": ...}``.  Any failed
check raises and the script exits non-zero; without a card it exits 2,
and without ``src/repro_torch`` beside it (the script copied alone) it
exits 1, printing no result either way.  It imports nothing of the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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


# The profiler drops the first device launches of a window.  After phase
# 3's kernel checks, 94-99 of 102 windows of 10 _flash_prefill calls lost
# their first 2 launches, a flash launch in 3 of them, whether or not
# they idled 20 ms at each end; led by 16 launches of
# ``torch.cuda._sleep(0)``, none of 102 lost a launch of its own
# (tools/profiler_window_probe.py --after-kernels).  Every profiled window
# idles PROFILE_PAD_S at each end and opens with PROFILE_LEAD spin launches
# (:func:`open_window`), outside the walls it times; device_events and
# raw_device_events leave the spin kernels out.
PROFILE_PAD_S = 0.02
PROFILE_LEAD = 16
LEAD_KERNEL = "spin_kernel"


def open_window() -> None:
    """The start of a profiled window: idle, then the lead launches that
    the profiler may drop in place of the window's own."""
    time.sleep(PROFILE_PAD_S)
    for _ in range(PROFILE_LEAD):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def profiled(fn, host: bool = True):
    """Run ``fn`` under ``torch.profiler`` (host and CUDA activity, or the
    CUDA activity alone without ``host``) in a window opened by
    :func:`open_window` and padded at its end; return its result and the
    device-side events (kernels, copies, memsets)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        open_window()
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return out, device_events(prof.events())


def device_events(evs, annotations=()):
    """The device-side events (kernels, copies, memsets) of a profile,
    without the device-lane copies of ``record_function`` ranges (named in
    ``annotations``), which span a whole annotated region and are no device
    work, and without the window's lead launches (``LEAD_KERNEL``)."""
    from torch.autograd import DeviceType

    return [ev for ev in evs if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name not in annotations and LEAD_KERNEL not in ev.name]


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


FLASH_SM90 = "flash_attention_kernel_sm90"   # the bf16 kernel's symbol
FLASH_F32 = "flash_attention_f32_kernel"     # the f32 kernel's symbol
FLASH_SYMBOL = {torch.bfloat16: FLASH_SM90, torch.float32: FLASH_F32}
# Correctness-only bfloat16 cases: (BH, S, d, causal, window).
# (64, 1024, 128) is tda_monitor's forward in the training phase: 4 x 1,024
# tokens, 16 heads; (16, 2048, 192) MLA's prefill width (nope 128 + rope 64,
# the values zero-padded to it), run at the kernel's D = 256; then the
# lm_archs prefills: granite-moe-1b-a400m (8 x 16 heads, d = 64), glm4-9b
# (8 x 32, d = 128) and granite-34b (2 x 48 heads of 512 tokens); last,
# recurrentgemma-9b's local attention (4 x 16 heads, KV repeated from one,
# d = 256, 4,096 tokens, window 2,048); last, vlm_audio's prefills:
# qwen2-vl-2b (8 x 12 heads of 2,048 positions, d = 128, KV repeated from
# 2), whisper-small's encoder (8 x 12 heads over its 1,500 frames, not
# causal: a ragged last tile of 92 queries and keys) and its decoder's
# 224-token prompt.
FLASH_BF16_EDGES = ((8, 1000, 128, True, -1), (8, 1000, 128, False, -1),
                    (8, 1000, 128, True, 1), (16, 1000, 64, True, -1),
                    (16, 1000, 40, True, 256), (1, 2048, 128, True, -1),
                    (64, 1024, 128, True, -1), (16, 2048, 192, True, -1),
                    (128, 2048, 64, True, -1), (256, 2048, 128, True, -1),
                    (96, 512, 128, True, -1), (64, 4096, 256, True, 2048),
                    (96, 2048, 128, True, -1), (96, 1500, 64, False, -1),
                    (96, 224, 64, True, -1))
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
    from repro_torch.kernels.flash_attention import (attended_pairs,
                                                     flash_attention,
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
    counter = kernel_counters()["flash_attention"]
    _flash_prefill(q, k, v, -1, True)
    torch.cuda.synchronize()

    def take(attempt):
        counter.launches = 0
        _, evs = profiled(lambda: [_flash_prefill(q, k, v, -1, True)
                                   for _ in range(iters)])
        flash = [ev for ev in evs
                 if "flash_attention" in ev.name and "kernel" in ev.name]
        return dict(evs=evs, prefills=iters, flash_symbol=FLASH_SM90,
                    flash_launches=counter.launches,
                    flash_profiled_launches=len(flash),
                    flash_symbol_launches=sum(FLASH_SM90 in ev.name
                                              for ev in flash))

    window = whole_profile(take, lambda w: iters, "_flash_prefill")
    kern = [ev for ev in window["evs"] if FLASH_SM90 in ev.name]
    rest = [ev for ev in window["evs"] if FLASH_SM90 not in ev.name]
    by_name = by_kernel(rest)
    return dict(
        short_windows=window["short_windows"],
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
# card: 4 clouds of 1,500 points (about 5,700 edges each at the 0.5 %
# quantile of pair lengths), a 4 MiB admission account, 256 MiB of tenant
# cache, the packed engine; maxdim 1, cut from the service's default 2.
# At the 1 % quantile (about 11,000 edges a cloud) the phase took 64.1 s
# on an H100, more than the 60 s it may take of the run; at 0.5 %, 37.3 s.
# 8 clouds took 38.1 s on an H100; cut to 4 to leave the script room for
# train_mesh_families.
SERVE_PH_N, SERVE_PH_CLOUDS, SERVE_PH_Q = 1500, 4, 0.005
SERVE_PH_BUDGET, SERVE_PH_STORE = 4 << 20, 256 << 20
SERVE_PH_ARRIVALS = 64


def serve_ph_traffic(rng, clouds, tau: float):
    """The update wave: 4 requests, even uids grow tau to 1.5x on one
    cached cloud, odd uids bring 64 new points to another.  Returns (uid,
    dataset, points, tau, expected path) rows.  (A request at 3x tau that
    admission clamps was cut for the run's time limit;
    ``tests/test_torch_serve_ph.py::test_admission_clamps_and_rejects``
    holds the clamp against the reference.)"""
    rows = []
    for k in range(SERVE_PH_CLOUDS):
        uid = SERVE_PH_CLOUDS + k
        if k % 2 == 0:
            rows.append((uid, f"ds{k}", clouds[k], 1.5 * tau, "warm_tau"))
        else:
            grown = np.concatenate(
                [clouds[k], rng.normal(size=(SERVE_PH_ARRIVALS, 3))], axis=0)
            rows.append((uid, f"ds{k}", grown, tau, "warm_points"))
    return rows


def serve_ph(dev) -> dict:
    """``PHServeEngine(engine="packed", device=dev)`` under the profiler,
    the counts set to 0 just before it: a cold wave of 4 clouds served as
    one union batch and an update wave of 4 warm requests (tau growth,
    point arrival).  Gates: every path as planned; 4 warm and 2 cold
    responses equal (H0, H1) to a cold ``compute_ph`` on the card at the
    granted tau; find-low and scatter-XOR launched; a checkpoint saved
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
        for uid, ds, p, t, _ in updates:
            engine.submit(PHRequest(uid=uid, points=p, tau_max=t,
                                    dataset=ds, maxdim=1))
        _, walls["update_wave_s"] = timed(engine.run)
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
        tau_max=tau, budget_bytes=SERVE_PH_BUDGET,
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


ROUND_SHAPE = "ph_round_64k"


def round_shape() -> tuple:
    """``launch/dryrun.py``'s ``ph_round_64k`` cell: columns per mesh
    entry, column width in keys, pivot-table entries."""
    from repro_torch.launch.dryrun import PH_SHAPES

    p = PH_SHAPES[ROUND_SHAPE]
    return p["b_per_dev"], p["width"], p["n_pivots"]


def round_inputs(entries: int, seed: int = 0):
    """A pivot table of ``n_pivots`` sorted keys whose row k has low
    ``keys[k]`` and later keys of the table after it, and ``entries x
    b_per_dev`` columns of table keys (:func:`round_shape`), so that
    reductions chain through the table and cancel."""
    from repro_torch.core.device_engine import EMPTY

    n_cols, w, n_piv = round_shape()
    rng = np.random.default_rng(seed)
    keys = np.cumsum(rng.integers(1, 1 << 12, size=n_piv,
                                  dtype=np.int64))
    # row k: itself, then table keys at increasing offsets past k
    idx = np.arange(n_piv, dtype=np.int64)[:, None] + np.concatenate(
        [np.zeros((n_piv, 1), dtype=np.int64),
         np.cumsum(rng.integers(1, 64, size=(n_piv, w - 1)), axis=1)],
        axis=1)
    length = rng.integers(1, w + 1, size=(n_piv, 1))
    live = (np.arange(w)[None, :] < length) & (idx < n_piv)
    table = np.where(live, keys[np.minimum(idx, n_piv - 1)], EMPTY)
    b = entries * n_cols
    start = rng.integers(0, n_piv // 2, size=(b, 1))
    cidx = start + np.concatenate(
        [np.zeros((b, 1), dtype=np.int64),
         np.cumsum(rng.integers(1, 4096, size=(b, w - 1)), axis=1)], axis=1)
    clen = rng.integers(1, w + 1, size=(b, 1))
    clive = (np.arange(w)[None, :] < clen) & (cidx < n_piv)
    cols = np.where(clive, keys[np.minimum(cidx, n_piv - 1)], EMPTY)
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
    n_cols, width, n_piv = round_shape()
    res = dict(n=main_n, n_e=int(edges.shape[0]), msf_s=msf_s,
               boruvka_rounds=rounds, msf_edges=int(mask.sum()),
               msf_equal_union_find=True, round_entries=entries,
               round_cols=n_cols * entries, round_width=width,
               round_pivots=n_piv, round_card_s=walls["cuda"],
               round_cpu_s=walls["cpu"], round_rows_changed=moved,
               round_equal_cpu=True)
    emit("device_engine", **res)
    return res


# ---------------------------------------------------------------------------
# phases 16 and 17: the Hi-C pair (paper §6, Fig. 21)
# ---------------------------------------------------------------------------

# benchmarks/suite.py at scale 1.0, as benchmarks/fig21_hic.py runs it.
HIC_SUITE_N, HIC_SUITE_LOOPS, HIC_SUITE_TAU = 350, 24, 0.6
# The suite's maxdim is 2.  The auxin runs at maxdim 2 took 124.4 s of the
# phase's 137.0 s on a slow host, so auxin runs at maxdim 1: the Fig. 21
# gate reads H1 only, and H2 stays held on the control (three routes, one
# diagram).
HIC_SUITE_MAXDIM = {"control": 2, "auxin": 1}
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
    the packed engine over ``build_filtration_coo`` of the card's harvest;
    the control at maxdim 2, auxin at maxdim 1 (``HIC_SUITE_MAXDIM``).
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
        maxdim = HIC_SUITE_MAXDIM[name]
        results, walls, launches = {}, {}, {}
        for run, kw in runs.items():
            counters = reset_counters()
            results[run], walls[run] = timed(lambda: compute_ph(
                tau_max=HIC_SUITE_TAU, maxdim=maxdim, device=dev, **kw))
            launches[run] = {k: counters[k].launches for k in PH_KERNELS}
            if "points" in kw and launches[run]["pairwise_sq_dists"] <= 0:
                raise AssertionError(f"hic_suite {name} {run}: the tiled "
                                     "harvest never launched the kernel")
        ref = results["batch"]
        check_diagrams(ref, maxdim, f"hic_suite {name}")
        for run, res in results.items():
            for d in range(maxdim + 1):
                if not np.array_equal(res.diagrams[d], ref.diagrams[d]):
                    raise AssertionError(f"hic_suite {name}: H{d} of {run} "
                                         "differs from the batch engine's")
        dims = range(1, maxdim + 1)
        out[name] = dict(
            maxdim=maxdim, n_e=int(ref.stats["n_e"]), pairs=n_pairs(ref),
            wall_s=walls, launches=launches,
            essential={f"H{d}": int(np.isinf(ref.diagrams[d][:, 1]).sum())
                       for d in dims},
            counts={f"H{d}": fig21_counts(ref.diagrams[d]) for d in dims})
    table = [dict(dim="H1", threshold=t,
                  control=out["control"]["counts"]["H1"][str(t)],
                  auxin=out["auxin"]["counts"]["H1"][str(t)])
             for t in FIG21_THRESHOLDS]
    for row in table:
        row["pct_change"] = (100.0 * (row["auxin"] - row["control"])
                             / max(row["control"], 1))
    emit("hic_suite", n=HIC_SUITE_N, loops=HIC_SUITE_LOOPS,
         tau_max=HIC_SUITE_TAU, maxdim=HIC_SUITE_MAXDIM, identical=True,
         fig21=table, **out)
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
# phase 19: the dry-run tooling (launch/dryrun.py) on fake tensors
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "qwen3-0.6b"
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRYRUN_PH = ("ph_round_64k", "entries")
# The traced peak, beside what else the card holds, against
# max_memory_allocated over the same step
DRYRUN_PEAK_TOL = 0.10


def dryrun_check(dev, cfg, state, stream) -> tuple:
    """``launch/dryrun.py``'s ``trace_step`` held to the card on the
    ``train`` phase's own step (full-width qwen3-0.6b, 8 x 1,024 tokens in
    4 microbatches), where its state is alive.  One real step after
    ``reset_peak_memory_stats()`` gives the card's
    ``max_memory_allocated()``, one more under ``FlopCounterMode`` its
    FLOPs; the
    trace runs the step built for one microbatch on fake CUDA tensors of
    the same shapes, weighted by 4.  Its FLOPs must equal the card's, and
    its peak plus what the card held beside the step's arguments
    (``other_bytes``) must lie within 10 % of the card's peak.  Returns
    (the check's line, the state after the two steps)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import _storages, trace_step
    from repro_torch.launch.specs import first_micro
    from repro_torch.train import AdamW, make_train_step, warmup_cosine
    from repro_torch.train.train_step import init_train_state

    t0 = time.perf_counter()
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt, n_micro=TRAIN_MICRO)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(TRAIN_STEPS + 2).items()}
    torch.cuda.synchronize()
    gc.collect()
    other = torch.cuda.memory_allocated() - sum(
        _storages((state, batch)).values())
    torch.cuda.reset_peak_memory_stats()
    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated()
    # FlopCounterMode's module tracker keeps tensors of the step alive
    # past it: counted after the peak's step, and let go before going on
    with FlopCounterMode(display=False) as fc:
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    card_flops = float(fc.get_total_flops())
    del fc
    gc.collect()
    card_s = time.perf_counter() - t0

    mode = FakeTensorMode()
    with mode:
        fake_state = init_train_state(cfg, opt, 0, dev)
        fake_batch = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                      for k, v in batch.items()}
    tr = trace_step(make_train_step(cfg, opt, n_micro=1),
                    (fake_state, first_micro(fake_batch, TRAIN_MICRO)),
                    mode, n_micro=TRAIN_MICRO)
    ratio = (tr.peak_bytes + other) / card_peak
    out = dict(arch=cfg.name, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
               n_micro=TRAIN_MICRO, trace_flops=tr.total_flops,
               card_flops=card_flops,
               flops_ratio=tr.total_flops / card_flops,
               trace_flops_by_dtype=tr.flops,
               trace_peak_bytes=tr.peak_bytes, card_peak_bytes=card_peak,
               other_bytes=other, peak_ratio=ratio,
               trace_peak_over_card_peak=tr.peak_bytes / card_peak,
               trace_argument_bytes=tr.argument_bytes,
               trace_traffic_bytes=tr.traffic_bytes, trace_s=tr.seconds,
               card_steps_s=card_s, check_s=time.perf_counter() - t0)
    emit("dryrun_check", **out)
    if tr.total_flops != card_flops or abs(ratio - 1) > DRYRUN_PEAK_TOL:
        raise AssertionError(
            f"dryrun_check: traced {tr.total_flops} FLOPs against the "
            f"card's {card_flops}; traced peak {tr.peak_bytes} + "
            f"{other} beside the step against the card's {card_peak} "
            f"(ratio {ratio:.4f}, tolerance {DRYRUN_PEAK_TOL})")
    return out, state


def dryrun_line(rec: dict) -> dict:
    """A dry-run record's summary: the peak, the three terms, the dominant
    one, the useful-FLOP ratio and the trace's seconds."""
    if rec["status"] == "skip":
        return dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                    status="skip", skip_reason=rec["skip_reason"])
    r = rec["roofline"]
    return dict(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                status=rec["status"], kind=rec["kind"],
                peak_gib=rec["memory"]["peak_bytes"] / 2**30,
                compute_s=r["compute_s"], memory_s=r["memory_s"],
                collective_s=r["collective_s"], dominant=r["dominant"],
                useful_flop_ratio=r["useful_flop_ratio"],
                trace_s=rec["lower_s"], n_micro=rec["meta"].get("n_micro"),
                entries=rec["meta"]["entries"],
                flops=rec["cost"]["per_device_flops"],
                flops_by_dtype=rec["cost"].get("flops_by_dtype"),
                traffic_bytes=rec["cost"]["per_device_bytes"],
                collectives={k: v for k, v in rec["collectives"].items()
                             if v})


def dryrun(dev, check: dict) -> dict:
    """``launch/dryrun.py`` on the card: ``run_cell`` for qwen3-0.6b at its
    published width and depth on ``mesh_kind="card"``, traced on fake CUDA
    tensors (the card's routes: prefill's attention through the flash
    kernel's custom operator, whose fake implementation allocates nothing),
    for ``train_4k``, ``prefill_32k`` and ``decode_32k``; ``long_500k``
    must be a skip (full attention).  Then ``run_ph_cell("ph_round_64k",
    "entries")``.  Gates: every record ``ok`` with finite positive terms
    and a positive peak, on ``cuda``; ``train_4k`` weighted by its 256
    microbatches; one flash operator a layer in the prefill; the PH round's
    collectives present.  The phase's seconds include
    :func:`dryrun_check`'s."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr

    t0 = time.perf_counter()
    cfg = get_config(DRYRUN_ARCH)
    lines = {}
    for shape in DRYRUN_SHAPES:
        rec = dr.run_cell(DRYRUN_ARCH, shape, "card", device=dev)
        line = dryrun_line(rec)
        emit("dryrun", **line)
        lines[shape] = line
        if shape == "long_500k":
            if rec["status"] != "skip":
                raise AssertionError(f"dryrun: long_500k is {rec['status']}"
                                     ", not a skip, on a full-attention arch")
            continue
        terms = [line[k] for k in ("compute_s", "memory_s")]
        if rec["status"] != "ok" or not all(
                math.isfinite(t) and t > 0 for t in terms) \
                or line["peak_gib"] <= 0 \
                or not rec["meta"]["device"].startswith("cuda"):
            raise AssertionError(f"dryrun: {shape}: {line}")
        if shape == "train_4k" and line["n_micro"] != 256:
            raise AssertionError(f"dryrun: train_4k took {line['n_micro']} "
                                 "microbatches, not 256")
        if shape == "prefill_32k" and rec["collectives"].get(
                "count_flash_attention") != cfg.n_layers:
            raise AssertionError(f"dryrun: prefill_32k traced "
                                 f"{rec['collectives']} flash operators, not"
                                 f" one a layer ({cfg.n_layers})")
    rec = dr.run_ph_cell(*DRYRUN_PH, device=dev)
    line = dryrun_line(rec)
    emit("dryrun", **line)
    lines["ph"] = line
    if rec["status"] != "ok" or rec["memory"]["peak_bytes"] <= 0 \
            or rec["collectives"]["total"] <= 0:
        raise AssertionError(f"dryrun: {DRYRUN_PH}: {line}")
    own_s = time.perf_counter() - t0
    out = dict(cells=lines, check=check, own_s=own_s,
               check_s=check["check_s"], phase_s=own_s + check["check_s"])
    emit("dryrun_done", own_s=own_s, check_s=check["check_s"],
         phase_s=out["phase_s"])
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


def top_kernels(evs, n: int = 10, spans=None) -> list:
    """The ``n`` kernels with the most device time over ``evs`` (those
    that start inside one of ``spans``, if given): name, launches and
    device seconds."""
    top = sorted(by_kernel(evs, spans).items(), key=lambda kv: -kv[1][1])
    return [dict(name=k[:100], launches=c, device_s=us / 1e6)
            for k, (c, us) in top[:n]]


def device_summary(evs, wall: float, n_top: int = 10) -> dict:
    """The card over a profiled window of ``wall`` seconds: its busy
    seconds, busy and idle share, device launches and the ``n_top``
    kernels with the most device time."""
    busy = busy_us(evs) / 1e6
    return dict(wall_s=wall, device_busy_s=busy,
                device_busy_share=busy / wall,
                device_idle_share=1.0 - busy / wall,
                device_launches=len(evs), top_kernels=top_kernels(evs, n_top))


def profiled_serving(engine, counters, symbol: str = FLASH_SM90,
                     d_v: Optional[int] = None) -> dict:
    """Drain ``engine`` under ``torch.profiler``: the window's wall (timed
    inside the profiler), the card's busy and idle share over it and inside
    the ``serve/prefill`` and ``serve/decode`` spans, the flash kernels'
    launches (those of kernel ``symbol`` apart) and device seconds, and the
    kernels with the most device time, over the window and over those that
    start inside a prefill span.  For the bf16 kernel, its launches
    grouped by shape against their bounds (:func:`flash_groups`; ``d_v``
    the value width where it is narrower than q and k)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import Tracer, tracing

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            flash_calls() as calls:
        open_window()
        t0 = time.perf_counter()
        with tracing(Tracer(bridge=True)):
            engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    evs = prof.events()
    dev = device_events(evs, SERVE_SPANS)
    intervals = sorted((ev.time_range.start, ev.time_range.end)
                       for ev in dev)
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
    flash = [(k, n, us) for k, (n, us) in by_kernel(dev).items()
             if "flash_attention" in k and "kernel" in k]
    named = [f for f in flash if symbol in f[0]]
    out = dict(
        device_summary(dev, wall),
        phases=phases, flash_launches=counters["flash_attention"].launches,
        flash_kernels=[k[:100] for k, _, _ in flash],
        flash_profiled_launches=sum(n for _, n, _ in flash),
        flash_symbol=symbol,
        flash_symbol_launches=sum(n for _, n, _ in named),
        flash_device_s=sum(us for _, _, us in flash) / 1e6,
        prefill_top_kernels=top_kernels(dev, 10, prefill))
    if symbol == FLASH_SM90:
        out["flash_groups"] = flash_groups(
            calls, [ev for ev in dev if symbol in ev.name], d_v)
    return out


# Before its windows had lead launches (open_window) the profiler lost
# flash launches: 87 of the 88 of granite-34b's profiled epoch, once, and 9
# of the 10 of :func:`prefill_copies`, once, every launch counted by the
# wrapper.  A window short in just that way is still profiled once more.
PROFILE_ATTEMPTS = 2
FLASH_COUNTS = ("flash_launches", "flash_symbol_launches",
                "flash_profiled_launches")


def whole_profile(take, expected, what: str) -> dict:
    """A profiled window that holds every flash launch: ``take(attempt)``
    profiles one and returns it with ``prefills`` (what it ran),
    ``flash_launches`` (the wrapper's count), ``flash_profiled_launches``
    (the profiled flash kernels) and ``flash_symbol_launches`` (those of
    them the kernel named ``flash_symbol``); ``expected(window)`` is the
    launches the window should hold, None where it ran something else.  A
    window in which every launch was counted and every profiled one is the
    named kernel, but fewer were profiled than counted, is taken once more
    (its counts kept under ``short_windows``); any other mismatch, or a
    second short window, fails."""
    shorts = []
    for attempt in range(PROFILE_ATTEMPTS):
        window = take(attempt)
        want = expected(window)
        launched, named, profiled_n = (window[k] for k in FLASH_COUNTS)
        if not (attempt + 1 < PROFILE_ATTEMPTS and want is not None
                and launched == want and named == profiled_n < want):
            break
        shorts.append({k: window[k] for k in FLASH_COUNTS})
    if want is None or not launched == named == profiled_n == want:
        raise AssertionError(
            f"{what}: {launched} flash launches counted, {named} of "
            f"{profiled_n} profiled ones {window['flash_symbol']}, in "
            f"{window['prefills']} prefills, {want} expected")
    window["short_windows"] = shorts
    return window


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
    def take(attempt):
        for req in serve_requests(cfg, SERVE_SLOTS, seed=1 + attempt):
            req.max_new = 9
            engine.submit(req)
        window = profiled_serving(engine, reset_counters())
        window["prefills"] = window["phases"]["serve/prefill"]["n"]
        return window

    out["profiled_window"] = whole_profile(
        take, lambda w: cfg.n_layers * w["prefills"] if w["prefills"] >= 1
        else None, f"profiled epoch of {cfg.n_layers} layers")
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
    toks = np.zeros((slots, prompt), dtype=np.int32)
    for i, req in enumerate(requests[:slots]):
        toks[i, -len(req.prompt):] = req.prompt[-prompt:]
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    out = route_seam(model, prefill, batch, dev, counters, contract)
    if any(getattr(b, "moe", False) for b in model.blocks):
        # Explicit positions, though they are arange, take _sdpa_masked.
        seam = dict(batch, positions=torch.arange(
            prompt, device=dev).expand(slots, prompt))
        flash_top = moe_routes(model, prefill, batch)
        sdpa_top = moe_routes(model, prefill, seam)
        out["moe_tokens_rerouted"] = [
            int((a != b).any(-1).sum()) for a, b in zip(flash_top, sdpa_top)]
    return out


def route_seam(model, prefill, batch, dev, counters,
               contract: float) -> dict:
    """``batch``'s prefill through the flash kernel (no ``positions``: the
    positions are ``arange(S)``) and through ``_sdpa_masked`` (the same
    batch with explicit ``arange(S)`` positions), each timed after a
    warm-up; the logits' largest difference against ``contract * max(1,
    max |logits|)``, compared a slot at a time, the positions whose logits
    differ by more, the quantiles of a position's largest difference, and
    the greedy first tokens of both."""
    from repro_torch.serve.steps import sample_greedy

    ref = batch["tokens"] if "tokens" in batch else batch["embeds"]
    slots, prompt = ref.shape[:2]
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
        # a slot at a time: recurrentgemma's float32 logits are 16.8 GB a
        # route, and a whole-batch difference would be a third copy
        row_diff = torch.stack([(f - g).abs().amax(-1) for f, g
                                in zip(flash_logits, sdpa_logits)])
        diff = float(row_diff.max())
        scale = max(1.0, max(float(g.abs().max()) for g in sdpa_logits))
        rows_over = int((row_diff > contract * scale).sum())
        row_q = torch.quantile(row_diff.float().flatten(), torch.tensor(
            [0.5, 0.99, 0.999], device=dev)).tolist()
        del row_diff
        flash_tok = sample_greedy(flash_logits)[:, 0]
        sdpa_tok = sample_greedy(sdpa_logits)[:, 0]
        agree = float((flash_tok == sdpa_tok).float().mean())
    del flash_logits, sdpa_logits
    torch.cuda.empty_cache()
    return dict(prefill_s_flash=flash_s, prefill_s_sdpa=sdpa_s,
                logits_max_abs_diff=diff, logits_max_abs=scale,
                atol=contract * scale, positions_over_atol=rows_over,
                position_diff_q50_q99_q999=row_q,
                positions=slots * prompt, first_token_agreement=agree,
                first_tokens_flash=flash_tok.tolist(),
                first_tokens_sdpa=sdpa_tok.tolist())


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
    requests = serve_requests(cfg, SERVE_SLOTS, seed=2, max_new=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def take(attempt):
        for req in (serve_requests(cfg, SERVE_SLOTS, seed=2 + attempt,
                                   max_new=1) if attempt else requests):
            engine.submit(req)
        window = profiled_serving(engine, reset_counters(), FLASH_F32)
        window["prefills"] = window["phases"]["serve/prefill"]["n"]
        return window

    window = whole_profile(
        take, lambda w: cfg.n_layers if w["prefills"] == 1 else None,
        f"float32 epoch of {cfg.n_layers} layers")
    launches = window["flash_launches"]
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
# examples/train_lm.py's learning run and its gate, cut from 300 steps to
# 100 (and its resume from 310 to 110) to leave the script room for
# train_mesh: on an H100 the loss fell from 9.24 to 1.04 in 300 steps and
# to 1.02 in 100, against the gate's drop of 0.5
LEARN_STEPS, LEARN_BATCH, LEARN_SEQ, LEARN_RESUME_TO = 100, 16, 64, 110
LEARN_CKPT_EVERY = 50
# The full-width card-against-CPU step, cut in depth from 28 layers to 4
# to leave the script room for train_mesh (the host CPU of an H100 machine
# took 15.5 s for the step of 28 layers, 3.2 s for 4)
TRAIN_VS_CPU_LAYERS = 4


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


def train_card_vs_cpu(dev, cfg, tokens=(1, 65), n_micro: int = 1,
                      line: str = "train_card_vs_cpu",
                      batch: Optional[dict] = None) -> dict:
    """One train step of ``cfg`` in float32 compute (TF32 off) on a batch
    of ``tokens`` (1 x 65 for the full-width model), or on ``batch`` (numpy
    arrays by key: an embedding-input or encoder-decoder model's), in
    ``n_micro`` microbatches, on the card and on the CPU from the card's
    weights (``params_to_arrays``); printed as ``line``."""
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
    if batch is None:
        batch = {"tokens": np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=tokens).astype(np.int32)}
    t0 = time.perf_counter()
    card, card_m = step_fn(card, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host, host_m = step_fn(host, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    t2 = time.perf_counter()
    lr = float(host_m["lr"])
    d = torch.cat([(a.detach() - b.detach().to(dev)).abs().flatten()
                   for a, b in zip(card.params.parameters(),
                                   host.params.parameters())])
    n = d.numel()
    worst = int(torch.argmax(d))
    out = dict(
        tokens=list(batch["tokens"].shape) if "tokens" in batch else None,
        batch={k: list(v.shape) for k, v in batch.items()},
        card_step_s=t1 - t0, cpu_step_s=t2 - t1,
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
    d_model 256, 8 heads, d_ff 1,024, vocab 512; ``LEARN_STEPS`` steps of
    16 x 64, n_micro 2, lr 1e-3, warmup 30), checkpointing every
    ``LEARN_CKPT_EVERY`` steps; its gate ``final < first - 0.5``; then
    ``run(restore=True)`` to ``LEARN_RESUME_TO`` steps must resume at step
    ``LEARN_STEPS``."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainJob, run

    cfg = get_config(TRAIN_ARCH).reduced(n_layers=4, d_model=256, n_heads=8,
                                         d_ff=1024, vocab=512)
    with tempfile.TemporaryDirectory() as tmp:
        job = TrainJob(cfg=cfg, steps=LEARN_STEPS, global_batch=LEARN_BATCH,
                       seq_len=LEARN_SEQ, n_micro=2, lr=1e-3, warmup=30,
                       ckpt_dir=tmp, ckpt_every=LEARN_CKPT_EVERY,
                       log_every=20,
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
    check, state = dryrun_check(dev, cfg, state, stream)
    t2 = time.perf_counter()
    del state, step_fn
    torch.cuda.empty_cache()
    versus = train_card_vs_cpu(dev, dataclasses.replace(
        cfg, n_layers=TRAIN_VS_CPU_LAYERS))
    t3 = time.perf_counter()
    torch.cuda.empty_cache()
    learn = train_learning(dev)
    t4 = time.perf_counter()
    out = dict(full_width=full, card_vs_cpu=versus,
               learning=learn, dryrun_check=check,
               part_s=dict(full_width=t1 - t0, dryrun_check=t2 - t1,
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


def cache_bytes(cfg, slots: int, s_max: int, s_enc: int = 0) -> int:
    """The decode cache, layer by layer of the plan (``layer_slots``):
    MLA's latent and rotary key, ``(r + d_rope) · slots · S_max``
    elements, or K and V, ``2 · slots · S_max · KV · head_dim``, a decoder
    layer's cross K and V beside them at the encoder's length, ``2 · slots
    · s_enc · H · head_dim``, an encoder layer nothing, in the
    compute dtype; the recurrent states, which do not grow with S_max, in
    float32 (mLSTM's C and n, ``slots · nh · (hd² + hd)``; sLSTM's c, n and
    h, ``3 · slots · d``; RG-LRU's h, ``slots · d_rnn``) beside the convs'
    ``slots · (cw - 1) · width`` trailing inputs in the compute dtype."""
    from repro_torch.models.transformer import layer_slots

    cd = cfg.cdtype.itemsize
    total = 0
    for slot in layer_slots(cfg):
        if slot.kind == "mlstm":
            di = int(cfg.d_model * cfg.xlstm.proj_factor)
            nh = cfg.n_heads
            hd = di // nh
            total += slots * (nh * (hd * hd + hd) * 4
                              + (cfg.xlstm.conv_width - 1) * di * cd)
        elif slot.kind == "slstm":
            total += 3 * slots * cfg.d_model * 4
        elif slot.kind == "rglru":
            dr = cfg.rglru.d_rnn or cfg.d_model
            total += slots * dr * (4 + (cfg.rglru.conv_width - 1) * cd)
        elif cfg.mla is not None:
            total += (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) \
                * slots * s_max * cd
        elif slot.kind != "enc_attn_mlp":
            total += 2 * slots * s_max * cfg.n_kv_heads * cfg.head_dim_ * cd
            if slot.kind == "dec_attn_mlp":
                total += 2 * slots * s_enc * cfg.n_heads * cfg.head_dim_ * cd
    return total


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


def lm_arch(dev, arch: str, param_dtype: str, slots: int,
            prompt: int, layers: Optional[int] = None,
            line: str = "lm_archs") -> dict:
    """One architecture at its published width (and depth, or ``layers``
    of it) through ``ServeEngine`` on
    the card, the counts set to 0 just before ``run``: ``LM_EPOCHS``
    epochs of ``slots`` requests, every request served with ``LM_NEW``
    tokens, one flash launch an attention layer of the plan a prefill (the
    bf16 kernel's ``launches``; none for xlstm).  Then one more epoch, a
    prefill and one decode step, under ``torch.profiler``
    (:func:`profiled_serving`; a model with sLSTM layers profiles its
    prefill's CUDA activity alone, :func:`profiled_recurrent`): every
    flash launch the tensor-core kernel, each launch group's ms against
    its bound (:func:`flash_groups`), the card's busy share in prefill and
    decode, the longest kernels; a profile that lost launches the counter
    saw is taken once more.  A model with recurrent layers times
    each recurrent kind's block alone (:func:`recurrent_parts`).  Last,
    for a model with attention, the first epoch's prefill through the
    flash kernel and through ``_sdpa_masked`` (:func:`prefill_routes`),
    the logits held to ``SERVE_CONTRACT``.  Printed as ``line``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (RECURRENT, count_params,
                                                init_params, is_attention,
                                                layer_slots)
    from repro_torch.obs.trace import Tracer, tracing
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_prefill_step

    cfg = dataclasses.replace(get_config(arch), param_dtype=param_dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    kinds = [sl.kind for sl in layer_slots(cfg)]
    n_attn = sum(is_attention(k) for k in kinds)
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
        layer_kinds={k: kinds.count(k) for k in sorted(set(kinds))},
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
    if launches["flash_attention"] != n_attn * n_prefills \
            or n_prefills < 1:
        raise AssertionError(f"{arch}: {launches['flash_attention']} flash "
                             f"launches for {n_prefills} prefills of "
                             f"{n_attn} attention layers")
    if held != out["cache_bytes"]:
        raise AssertionError(f"{arch}: the engine's cache holds {held} "
                             f"bytes, the formula {out['cache_bytes']}")
    if "slstm" in kinds:
        profile = profiled_recurrent
    else:
        # MLA's values are 128 wide beside q and k's 192 (zero-padded to it)
        profile = functools.partial(profiled_serving, d_v=cfg.mla and
                                    cfg.mla.v_head_dim)
    def take(attempt):
        for req in serve_requests(cfg, slots, seed=4 + attempt,
                                  lo=prompt // 2, hi=prompt,
                                  max_new=LM_PROFILED_NEW):
            engine.submit(req)
        n_before = int(engine.stats()["serve_n_prefills"])
        window = profile(engine, reset_counters())
        window["prefills"] = (int(engine.stats()["serve_n_prefills"])
                              - n_before)
        return window

    out["profiled_window"] = whole_profile(
        take, lambda w: n_attn if w["prefills"] == 1 else None,
        f"{arch} profiled epoch of {n_attn} attention layers")
    if any(k in RECURRENT for k in kinds):
        out["recurrent_parts"] = recurrent_parts(model, cfg, dev, slots,
                                                 prompt)
    if n_attn:
        out["seam"] = prefill_routes(model, make_prefill_step(cfg), requests,
                                     dev, counters, SERVE_CONTRACT, slots,
                                     prompt)
    if arch == LM_SAMPLE_ARCH:
        out["sample_temperature"] = sample_on_card(model, cfg, dev)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit(line, **out)
    if n_attn:
        check_seam(out["seam"])
    if out["peak_device_bytes"] > LM_MAX_PEAK:
        raise AssertionError(f"{arch}: peak {out['peak_device_bytes']} "
                             f"bytes > {LM_MAX_PEAK}")
    del engine, model
    torch.cuda.empty_cache()
    return out


def profiled_recurrent(engine, counters) -> dict:
    """The profiled epoch of a model with sLSTM layers: its prefill (the
    engine's admission) under the profiler's CUDA activity alone, since
    the sLSTM loop's host events would take minutes to record; then the
    decode step under :func:`profiled_serving`, whose fields it returns
    with the prefill's under ``prefill`` (:func:`device_summary`, and the
    seconds spent reading the events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_window()
        t0 = time.perf_counter()
        with torch.inference_mode():
            engine._admit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    t1 = time.perf_counter()
    evs = raw_device_events(prof)
    prefill = dict(device_summary(evs, wall),
                   events_read_s=time.perf_counter() - t1)
    del prof, evs
    return dict(profiled_serving(engine, counters), prefill=prefill)


class RawEvent:
    """A device event read straight from the profiler's kineto results,
    with the ``name`` and ``time_range`` (µs) that :func:`busy_us` and
    :func:`by_kernel` read."""
    __slots__ = ("name", "time_range")

    def __init__(self, name: str, start_us: float, end_us: float):
        from torch.autograd.profiler_util import Interval

        self.name = name
        self.time_range = Interval(start_us, end_us)


def raw_device_events(prof) -> list:
    """The device-side events of a finished ``torch.profiler.profile``,
    from its raw kineto results: ``prof.events()`` builds the host-side
    event tree first, which took 43 s for the 276,173 launches of
    xlstm-1.3b's prefill; the window's lead launches left out."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or LEAD_KERNEL in ev.name():
            continue
        start = ev.start_ns() / 1e3
        out.append(RawEvent(ev.name(), start, start + ev.duration_ns() / 1e3))
    return out


def recurrent_parts(model, cfg, dev, slots: int, prompt: int) -> dict:
    """The first block of each recurrent kind of the plan alone, on a
    random (slots, prompt, d_model) input in the compute dtype, as a
    prefill runs it: its wall (host clock, synchronised) and, under the
    profiler's CUDA activity, its device launches, device seconds and the
    card's busy share over the wall.  For RG-LRU, the Hillis–Steele scan
    (``ssm._linear_scan``) alone too, on float32 (slots, prompt, d_rnn)."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import RECURRENT

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((slots, prompt, cfg.d_model), generator=gen,
                    device=dev).to(cfg.cdtype)
    seen = {}
    parts = []
    for blk in model.blocks:
        if blk.kind not in RECURRENT or blk.kind in seen:
            continue
        seen[blk.kind] = blk
        parts.append((blk.kind, lambda b=blk: b.ssm(x)))
    if "rglru" in seen:
        dr = cfg.rglru.d_rnn or cfg.d_model
        a = torch.rand((slots, prompt, dr), generator=gen, device=dev)
        bx = torch.randn((slots, prompt, dr), generator=gen, device=dev)
        parts.append(("rglru_scan", lambda: ssm._linear_scan(a, bx)))
    out = {}
    with torch.inference_mode():
        for name, fn in parts:
            fn()                                    # warm-up
            torch.cuda.synchronize()
            _, wall = timed(fn)
            (_, wall_prof), evs = profiled(lambda: timed(fn), host=False)
            dev_s = sum(ev.time_range.elapsed_us() for ev in evs) / 1e6
            out[name] = dict(shape=[slots, prompt], wall_s=wall,
                             profiled_wall_s=wall_prof,
                             device_launches=len(evs), device_s=dev_s,
                             device_busy_share=busy_us(evs) / 1e6 / wall_prof)
            del evs
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


# ---------------------------------------------------------------------------
# phase 6d: the recurrent and hybrid architectures
# ---------------------------------------------------------------------------

# (arch, param_dtype, slots, prompt_len, layers), served as lm_archs
# serves, with the configs' own float32 parameters (13.71 and 29.93 GB at
# full depth).  xlstm-1.3b's prompts are left-padded to 2,048, a multiple
# of its chunk of 64; recurrentgemma-9b's to 4,096, so that its local
# attention's window of 2,048 masks inside the prompt.  xlstm is cut from
# 48 layers to 8 (one superblock of 7 mLSTM and 1 sLSTM, the published
# slstm_every) to leave the script room for train_mesh_families: on an
# H100 it took 43.6 s of the phase at full depth, most of it its six sLSTM
# loops over 2,048 tokens, and 28.4 s at 16 layers on a slower host.
SSM_ARCHS = (("xlstm-1.3b", "float32", 8, 2048, 8),
             ("recurrentgemma-9b", "float32", 4, 4096, None))
# The reduced copies' float32 forward, card against CPU (TF32 off): the
# logits within 1e-4 of max(1, their largest).
SSM_CARD_VS_CPU_TOL = 1e-4


def ssm_card_vs_cpu(dev, arch: str) -> dict:
    """The reduced copy of ``arch`` (float32 compute, TF32 off) on the card
    and on the CPU from the card's weights: one forward of 2 x 64 tokens,
    its logits within ``SSM_CARD_VS_CPU_TOL · max(1, max |logits|)``, one
    flash launch an attention layer on the card (the float32 kernel: the
    copy computes in float32); then one train step under
    :func:`train_card_vs_cpu`'s gates on 1 x 65 tokens (64 positions, a
    multiple of xlstm's reduced chunk of 8)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import (forward, init_params,
                                                is_attention, layer_slots,
                                                params_from_arrays,
                                                params_to_arrays)

    cfg = get_config(arch, reduced=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = init_params(cfg, seed=0, device=dev)
    host = params_from_arrays(cfg, params_to_arrays(card), "cpu")
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32)
    n_attn = sum(is_attention(sl.kind) for sl in layer_slots(cfg))
    before = flash_attention.launches
    with torch.inference_mode():
        got = forward(card, {"tokens": toks.to(dev)})[0]
        torch.cuda.synchronize()
        launched = flash_attention.launches - before
        want = forward(host, {"tokens": toks})[0]
    diff = float((got.cpu() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    out = dict(arch=cfg.name, tokens=list(toks.shape),
               compute_dtype=cfg.compute_dtype, logits_max_abs_diff=diff,
               logits_max_abs=scale, atol=SSM_CARD_VS_CPU_TOL * scale,
               flash_launches=launched, attention_layers=n_attn)
    emit("ssm_card_vs_cpu_forward", **out)
    if not (diff <= out["atol"] and launched == n_attn):
        raise AssertionError(f"{arch} reduced forward, card against CPU: "
                             f"{out}")
    del card, host
    out["train"] = train_card_vs_cpu(dev, cfg, tokens=(1, 65),
                                     line="ssm_card_vs_cpu_train")
    return out


def ssm_archs(dev) -> dict:
    """Phase 6d: xlstm-1.3b and recurrentgemma-9b at published width (xlstm
    at 8 of its 48 layers, ``SSM_ARCHS``) through :func:`lm_arch`, one
    after another, each freed before the
    next; then each reduced copy card against CPU
    (:func:`ssm_card_vs_cpu`)."""
    t0 = time.perf_counter()
    out = {arch: lm_arch(dev, arch, *rest, line="ssm_archs")
           for arch, *rest in SSM_ARCHS}
    t1 = time.perf_counter()
    for arch, *_ in SSM_ARCHS:
        out[arch]["card_vs_cpu"] = ssm_card_vs_cpu(dev, arch)
    emit("ssm_archs_done", phase_s=time.perf_counter() - t0,
         card_vs_cpu_s=time.perf_counter() - t1,
         flash_launches={a: r["launches"]["flash_attention"]
                         for a, r in out.items()})
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6e: the vision-language and encoder-decoder architectures
# ---------------------------------------------------------------------------

# qwen2-vl-2b: 8 slots of a 2,048-position prompt laid out as Qwen2-VL lays
# one out (arXiv:2409.12191 §2.1, M-RoPE): 16 text positions, one image of
# 1,024 merged patches on a 1 x 32 x 32 grid (an 896 x 896 image at 14-pixel
# patches, 2 x 2 merged), text to fill; 16 greedy tokens.
VLM_ARCH = "qwen2-vl-2b"
VLM_SLOTS, VLM_PROMPT, VLM_NEW = 8, 2048, 16
VLM_TEXT_BEFORE, VLM_GRID = 16, (1, 32, 32)
# whisper-small: 8 slots of 1,500 encoder frames (its 30-second window,
# n_audio_ctx), decoder prompts of 224 tokens, 32 new tokens, s_max 256.
AUDIO_ARCH = "whisper-small"
AUDIO_SLOTS, AUDIO_FRAMES, AUDIO_PROMPT = 8, 1500, 224
AUDIO_NEW, AUDIO_S_MAX = 32, 256


def vlm_positions3(slots: int, prompt: int, before: int, grid) -> tuple:
    """Qwen2-VL's (3, slots, prompt) M-RoPE grids for ``before`` text
    positions, one image of ``grid`` = (t, h, w) merged patches and text to
    fill: text takes one index on all three axes; the image's tokens
    (start + t, start + h, start + w); the text after it resumes at the
    largest index + 1.  Returns the grids and the next text index."""
    t, h, w = grid
    n_img = t * h * w
    p = np.empty((3, prompt), dtype=np.int64)
    p[:, :before] = np.arange(before)
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    for axis, idx in enumerate((ti, hi, wi)):
        p[axis, before:before + n_img] = before + idx.ravel()
    nxt = int(p[:, :before + n_img].max()) + 1
    rest = prompt - before - n_img
    p[:, before + n_img:] = nxt + np.arange(rest)
    return np.broadcast_to(p[:, None], (3, slots, prompt)).copy(), nxt + rest


@contextlib.contextmanager
def flash_calls():
    """Records each call of ``ops.attention`` from the models, as
    ``(BH, S, d, causal, window)``, and passes it on unchanged."""
    from repro_torch.models import attention

    calls = []
    real = attention.ops.attention

    def tap(q, k, v, causal=True, window=-1):
        calls.append((*q.shape, bool(causal), int(window)))
        return real(q, k, v, causal=causal, window=window)

    attention.ops.attention = tap
    try:
        yield calls
    finally:
        attention.ops.attention = real


def flash_groups(calls, evs, d_v: Optional[int] = None) -> dict:
    """A profiled window's flash launches grouped by shape and mask, in
    launch order (``calls`` from :func:`flash_calls`, ``evs`` the bf16
    kernel's device events of the same window): each group's launches,
    mean ms a launch and the least time of the function it computes: q
    and k at their width d, v and the output at ``d_v`` (default d; MLA:
    192 and 128, the kernel's zero-padded value columns are not work),
    read and written once in bf16, and ``2 (d + d_v)`` operations an
    attended pair at the bf16 peak.  The groups are null where the
    profiler recorded another number of launches than were made (it has
    dropped events of short sessions after long ones), since the order
    then pairs them wrongly."""
    from repro_torch.kernels.flash_attention import attended_pairs

    evs = sorted(evs, key=lambda ev: ev.time_range.start)
    out = dict(calls=len(calls), profiled_launches=len(evs), groups=None)
    if len(evs) != len(calls):
        return out
    groups = {}
    for call, ev in zip(calls, evs):
        groups.setdefault(call, []).append(ev.time_range.elapsed_us() / 1e3)
    out["groups"] = []
    for (bh, s, d, causal, window), ms in groups.items():
        dv = d_v or d
        pairs = attended_pairs(s, causal, window)
        b_ms, b_by = bound(2 * bh * s * (2 * d + 2 * dv),
                           2 * bh * pairs * (d + dv), BF16_TC_FLOPS_PER_S)
        mean = float(np.mean(ms))
        out["groups"].append(dict(
            shape=[bh, s, d, dv], causal=causal, window=window,
            launches=len(ms), ms=mean, bound_ms=b_ms, bound_by=b_by,
            bound_share=b_ms / mean))
    return out


def profiled_share(fn) -> dict:
    """``fn`` under the profiler (host and CUDA activity):
    :func:`device_summary` over its wall, and the bf16 flash kernel's
    device events under ``flash``."""
    (_, wall), evs = profiled(lambda: timed(fn))
    return dict(device_summary(evs, wall, 6),
                flash=[ev for ev in evs if FLASH_SM90 in ev.name])


def vlm_batch(model, cfg, dev) -> tuple:
    """qwen2-vl's prefill batch: the embeddings of random text tokens
    (rows of the tied table) with one image's patch embeddings drawn from
    seed 0 in their place (the vision frontend is a stub in the
    reference), its ``positions3`` and the next text index."""
    p3, nxt = vlm_positions3(VLM_SLOTS, VLM_PROMPT, VLM_TEXT_BEFORE,
                             VLM_GRID)
    rng = np.random.default_rng(0)
    text = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (VLM_SLOTS, VLM_PROMPT)), device=dev)
    n_img = int(np.prod(VLM_GRID))
    img = torch.as_tensor(rng.standard_normal(
        (VLM_SLOTS, n_img, cfg.d_model), dtype=np.float32), device=dev)
    with torch.no_grad():
        embeds = model.embed[text]
        embeds[:, VLM_TEXT_BEFORE:VLM_TEXT_BEFORE + n_img] = img
    return {"embeds": embeds,
            "positions3": torch.as_tensor(p3, device=dev)}, nxt


def audio_batch(cfg, dev) -> dict:
    """whisper's prefill batch: 224 random decoder tokens and 1,500 encoder
    frames drawn from seed 0 (the conv stem is a stub in the reference)."""
    rng = np.random.default_rng(0)
    return {"tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (AUDIO_SLOTS, AUDIO_PROMPT)),
                dtype=torch.int32, device=dev),
            "enc_embeds": torch.as_tensor(rng.standard_normal(
                (AUDIO_SLOTS, AUDIO_FRAMES, cfg.d_model), dtype=np.float32),
                device=dev)}


def vlm_audio_arch(dev, arch: str) -> dict:
    """One of the two models at published width and depth (float32
    parameters, bf16 compute, seed 0) through ``make_prefill_step``,
    ``extend_cache`` and ``make_decode_step``, as the reference serves them
    (the engine serves token decoders): the counts set to 0, a cold and a
    warm prefill, each launching the bf16 flash kernel once an
    attention layer (qwen2-vl 28 causal at d = 128; whisper 12 not causal
    over the encoder's frames, then 12 causal over the decoder's prompt,
    at d = 64; cross-attention takes ``_sdpa_masked``), then greedy decode
    (qwen2-vl feeds the table row of the last token, its ``positions3``
    going on from the text index on all three axes).  Then a prefill and
    a decode step under the profiler (busy shares; each launch group's ms
    against its bound), and the first prefill through the kernel and
    through ``_sdpa_masked`` (:func:`route_seam`, ``SERVE_CONTRACT``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (count_params, init_params,
                                                layer_slots)
    from repro_torch.serve.steps import (extend_cache, make_decode_step,
                                         make_prefill_step, sample_greedy)

    cfg = get_config(arch)
    vlm = arch == VLM_ARCH
    slots, prompt, new = (VLM_SLOTS, VLM_PROMPT, VLM_NEW) if vlm \
        else (AUDIO_SLOTS, AUDIO_PROMPT, AUDIO_NEW)
    s_max = prompt + new if vlm else AUDIO_S_MAX
    s_enc = 0 if vlm else AUDIO_FRAMES
    n_attn = len(layer_slots(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated()
    if allocated > LM_MAX_ALLOCATED:
        raise AssertionError(f"{arch}: {allocated} bytes still allocated "
                             f"by earlier phases")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, seed=0, device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    if vlm:
        batch, next_pos = vlm_batch(model, cfg, dev)
    else:
        batch = audio_batch(cfg, dev)
    counters = reset_counters()
    with torch.inference_mode(), flash_calls() as calls:
        _, cold_s = timed(lambda: prefill(model, batch))
        per_prefill = counters["flash_attention"].launches
        calls.clear()
        (logits, cache), warm_s = timed(lambda: prefill(model, batch))
        prefill_calls = list(calls)
        cache = extend_cache(cfg, cache, prompt, s_max)
        tok = sample_greedy(logits)
        del logits
        steps, generated = [], [tok]
        for i in range(new - 1):
            step = {"cache_pos": prompt + i}
            if vlm:
                step.update(embeds=model.embed[tok.long()],
                            positions3=torch.full((3, slots, 1), next_pos + i,
                                                  device=dev))
            else:
                step["tokens"] = tok
            (logits, cache), dt = timed(lambda: decode(model, cache, step))
            tok = sample_greedy(logits)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"{arch}: non-finite decode logits")
            steps.append(dt)
            generated.append(tok)
    launches = {k: fn.launches for k, fn in counters.items()}
    toks = torch.cat(generated, dim=1).cpu()
    held = sum(t.numel() * t.element_size()
               for layer in cache["layers"] for t in layer)
    causal = [c[3] for c in prefill_calls]
    out = dict(
        arch=cfg.name, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, n_layers=cfg.n_layers,
        n_enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
        n_params=count_params(model),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        cache_bytes=cache_bytes(cfg, slots, s_max, s_enc),
        cache_bytes_held=held, allocated_before=allocated, slots=slots,
        prompt_len=prompt, encoder_frames=s_enc or None, s_max=s_max,
        max_new=new, prefill_s_cold=cold_s, prefill_s_warm=warm_s,
        decode_ms_median=float(np.median(steps)) * 1e3,
        decode_ms_mean=float(np.mean(steps)) * 1e3,
        n_decode_steps=len(steps), generated_tokens=int(toks.numel()),
        tokens_per_s=toks.numel() / (warm_s + sum(steps)),
        launches=launches, flash_per_prefill=per_prefill,
        flash_causal=sum(causal), flash_not_causal=len(causal) - sum(causal),
        flash_calls=sorted({str(c) for c in prefill_calls}))
    if vlm:
        out.update(image_grid=list(VLM_GRID), text_before=VLM_TEXT_BEFORE,
                   next_text_index=next_pos)
    else:
        cross = {tuple(layer[2].shape) for layer, sl in
                 zip(cache["layers"], layer_slots(cfg))
                 if sl.kind == "dec_attn_mlp"}
        out["cross_kv_shapes"] = sorted(list(c) for c in cross)
        if cross != {(slots, s_enc, cfg.n_heads, cfg.head_dim_)}:
            raise AssertionError(f"{arch}: cross K/V {cross} after "
                                 f"extend_cache")
    want_causal = n_attn - cfg.n_enc_layers
    if not (per_prefill == n_attn == len(prefill_calls)
            and launches["flash_attention"] == 2 * n_attn
            and sum(causal) == want_causal):
        raise AssertionError(
            f"{arch}: {per_prefill} flash launches a prefill "
            f"({prefill_calls}), {launches['flash_attention']} in all, for "
            f"{n_attn} attention layers, {want_causal} of them causal")
    if held != out["cache_bytes"]:
        raise AssertionError(f"{arch}: the cache holds {held} bytes, the "
                             f"formula {out['cache_bytes']}")
    if not (toks.shape == (slots, new) and bool((toks >= 0).all())
            and bool((toks < cfg.padded_vocab).all())):
        raise AssertionError(f"{arch}: malformed generations {toks}")

    # One prefill and one decode step under the profiler.
    with torch.inference_mode(), flash_calls() as calls:
        pro = profiled_share(lambda: prefill(model, batch))
        out["profiled_prefill"] = dict(pro, flash=flash_groups(
            calls, pro["flash"]))
        step = {"cache_pos": prompt + new - 1}
        if vlm:
            step.update(embeds=model.embed[tok.long()],
                        positions3=torch.full((3, slots, 1),
                                              next_pos + new - 1, device=dev))
        else:
            step["tokens"] = tok
        pro = profiled_share(lambda: decode(model, cache, step))
        del pro["flash"]
        out["profiled_decode"] = pro
    del cache
    out["seam"] = route_seam(model, prefill, batch, dev, counters,
                             SERVE_CONTRACT)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit("vlm_audio", **out)
    check_seam(out["seam"])
    if out["peak_device_bytes"] > LM_MAX_PEAK:
        raise AssertionError(f"{arch}: peak {out['peak_device_bytes']} "
                             f"bytes > {LM_MAX_PEAK}")
    del model, batch
    torch.cuda.empty_cache()
    return out


def vlm_audio_card_vs_cpu(dev, arch: str) -> dict:
    """The reduced copy of ``arch`` (float32 compute, TF32 off) on the card
    and on the CPU from the card's weights: one forward, its logits within
    ``SSM_CARD_VS_CPU_TOL · max(1, max |logits|)``, one flash launch a
    self-attention layer on the card (the float32 kernel); then one train
    step under :func:`train_card_vs_cpu`'s gates.  qwen2-vl: 2 x 64
    embeddings with a 1 x 4 x 4 image grid after 4 text positions (the
    step: 1 x 64 with labels); whisper: 2 x 64 tokens over 48 encoder
    frames (the step: 1 x 65 tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import (forward, init_params,
                                                layer_slots,
                                                params_from_arrays,
                                                params_to_arrays)

    cfg = get_config(arch, reduced=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = init_params(cfg, seed=0, device=dev)
    host = params_from_arrays(cfg, params_to_arrays(card), "cpu")
    rng = np.random.default_rng(10)
    if arch == VLM_ARCH:
        p3, _ = vlm_positions3(2, 64, 4, (1, 4, 4))
        batch = {"embeds": rng.standard_normal((2, 64, cfg.d_model),
                                               dtype=np.float32),
                 "positions3": p3}
        train = {"embeds": batch["embeds"][:1],
                 "positions3": np.ascontiguousarray(p3[:, :1]),
                 "labels": rng.integers(0, cfg.vocab_size, (1, 64)).astype(
                     np.int32)}
    else:
        frames = rng.standard_normal((2, 48, cfg.d_model), dtype=np.float32)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(
            np.int32), "enc_embeds": frames}
        train = {"tokens": rng.integers(0, cfg.vocab_size, (1, 65)).astype(
            np.int32), "enc_embeds": frames[:1]}
    n_attn = len(layer_slots(cfg))
    before = flash_attention.launches
    with torch.inference_mode():
        got = forward(card, {k: torch.as_tensor(v, device=dev)
                             for k, v in batch.items()})[0]
        torch.cuda.synchronize()
        launched = flash_attention.launches - before
        want = forward(host, {k: torch.as_tensor(v)
                              for k, v in batch.items()})[0]
    diff = float((got.cpu() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    out = dict(arch=cfg.name, batch={k: list(v.shape)
                                     for k, v in batch.items()},
               compute_dtype=cfg.compute_dtype, logits_max_abs_diff=diff,
               logits_max_abs=scale, atol=SSM_CARD_VS_CPU_TOL * scale,
               flash_launches=launched, attention_layers=n_attn)
    emit("vlm_audio_card_vs_cpu_forward", **out)
    if not (diff <= out["atol"] and launched == n_attn):
        raise AssertionError(f"{arch} reduced forward, card against CPU: "
                             f"{out}")
    del card, host
    out["train"] = train_card_vs_cpu(dev, cfg, line="vlm_audio_card_vs_cpu_"
                                     "train", batch=train)
    return out


def vlm_audio(dev) -> dict:
    """Phase 6e: qwen2-vl-2b and whisper-small at published width and
    depth (:func:`vlm_audio_arch`), each freed before the next; then each
    reduced copy card against CPU (:func:`vlm_audio_card_vs_cpu`)."""
    t0 = time.perf_counter()
    out = {arch: vlm_audio_arch(dev, arch)
           for arch in (VLM_ARCH, AUDIO_ARCH)}
    t1 = time.perf_counter()
    for arch in (VLM_ARCH, AUDIO_ARCH):
        out[arch]["card_vs_cpu"] = vlm_audio_card_vs_cpu(dev, arch)
    emit("vlm_audio_done", phase_s=time.perf_counter() - t0,
         card_vs_cpu_s=time.perf_counter() - t1,
         flash_launches={a: r["launches"]["flash_attention"]
                         for a, r in out.items()})
    torch.cuda.empty_cache()
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


# ---------------------------------------------------------------------------
# phase 6f: the sharded trainer over the port's Mesh
# ---------------------------------------------------------------------------

# (a) full-width qwen3-0.6b on a (data 4, model 2) mesh of one card's
# entries: 8 x 512 tokens a step in 2 microbatches, so each microbatch is 4
# sequences, one a data entry, with heads and MLP split in two; a
# checkpoint at every step; then restored onto (2, 2) for more steps.
# (b) full-width granite-moe-1b-a400m on (4, 2), _moe_a2a on every MoE
# layer.  (c) the reduced copies, meshed, card against CPU in float32.
MESH_ARCH, MESH_MOE_ARCH = "qwen3-0.6b", "granite-moe-1b-a400m"
MESH_SHAPE, MESH_REMESH = (4, 2), (2, 2)
MESH_BATCH, MESH_SEQ, MESH_MICRO = 8, 512, 2
# Cut from 3 steps and 2 more after the restore to 2 and 1 (one 7.15 GB
# checkpoint write fewer) to leave the script room for
# train_mesh_families; the re-mesh case stays held bit for bit on the CPU
# (tests/test_torch_train_mesh.py).
MESH_STEPS, MESH_MORE, MESH_MOE_STEPS = 2, 1, 2
MESH_UNMESHED_REL = 1e-2   # first meshed loss against the unmeshed one
MESH_REDUCED = ("qwen3-0.6b", "gemma3-1b", "granite-moe-1b-a400m",
                "deepseek-v2-lite-16b", "xlstm-1.3b", "recurrentgemma-9b",
                "qwen2-vl-2b", "whisper-small")
# (d) train_mesh_families: the other five families at published width on
# (4, 2), 2 steps of 8 rows in 2 microbatches (one sequence a data entry a
# microbatch), seed 0, each cut in depth for the phase's time and the
# card's memory: deepseek to 3 of 27 layers (its dense layer and 2 MoE
# layers of 64 experts: 1.67 G parameters, 20 GB of parameters and
# moments; at 4 layers the AdamW step's new state beside the old would
# pass TRAIN_MAX_PEAK), recurrentgemma to one block pattern (RG-LRU,
# RG-LRU, local_attn) of 38 layers (1.55 G parameters, most of them the
# 256,000-row table), xlstm to one superblock of 48 layers (7 mLSTM, 1
# sLSTM: the published slstm_every; its sLSTM loops over every token of
# every data entry, a launch each op) at 256 tokens, qwen2-vl to 4 of 28
# layers; whisper-small whole (12 + 12 layers).  Rows: (arch, layers,
# decoder positions).
MESH_FAMILIES = (("deepseek-v2-lite-16b", 3, 512),
                 ("recurrentgemma-9b", 3, 512),
                 ("xlstm-1.3b", 8, 256),
                 ("qwen2-vl-2b", 4, 512),
                 ("whisper-small", 12, 224))
MESH_FAMILY_STEPS = 2
# qwen2-vl's 512 positions as vlm_audio lays out its prompts: 16 text, one
# image of 1 x 16 x 16 merged patches, text; whisper's 1,500 frames
MESH_VLM_TEXT_BEFORE, MESH_VLM_GRID = 16, (1, 16, 16)
MESH_AUDIO_FRAMES = 1500


class CollectiveCount:
    """The mesh's collective hook: each collective's count and bytes (its
    rows' bytes, one row an entry)."""

    def __init__(self):
        self.seen = {}

    def __call__(self, name, mesh, axis, rows):
        n, b = self.seen.get(name, (0, 0))
        self.seen[name] = (n + 1, b + sum(r.numel() * r.element_size()
                                          for r in rows))

    def per_step(self, steps: int) -> dict:
        return {k: {"count": n / steps, "bytes": b / steps}
                for k, (n, b) in sorted(self.seen.items())}


def entry_state_bytes(state) -> int:
    """The largest mesh entry's bytes of the ``ShardedTensor``s of ``state``
    (parameters and optimizer state, or a decode cache):
    each entry's blocks of every leaf (a block several entries hold counts
    for each of them)."""
    from repro_torch.dist.sharding import ShardedTensor, tree_flatten_with_path

    leaves = [x for _, x in tree_flatten_with_path(state)[0]
              if isinstance(x, ShardedTensor)]
    n = leaves[0].sharding.mesh.devices.size
    return max(sum(st.blocks[i].numel() * st.blocks[i].element_size()
                   for st in leaves) for i in range(n))


def unmeshed_reference(dev, cfg, stream) -> dict:
    """The unmeshed step at the meshed run's shape, from the same seed and
    on its first batch: its first loss, and the seconds of the next
    step."""
    from repro_torch.train import (AdamW, init_train_state, make_train_step,
                                   warmup_cosine)

    opt = AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, MESH_STEPS))
    step_fn = make_train_step(cfg, opt, n_micro=MESH_MICRO)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    losses, secs = [], []
    for step in range(2):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    del state
    torch.cuda.empty_cache()
    return dict(first_loss=losses[0], losses=losses, step_s=secs,
                timed_step_s=secs[1])


def meshed_run(dev, cfg, shape, steps: int, ckpt_dir=None, restore=False,
               ckpt_every: int = 1, seq_len: Optional[int] = None,
               **kw) -> tuple:
    """``launch.train.run`` with ``mesh_shape=shape`` on the card, traced,
    every step logged, its collectives counted; returns (its output, its
    times: the step seconds, the seconds before the first step (the
    shard or the restore), the rest of the loop (checkpoints,
    ``tda_monitor``); its peak device bytes, the mesh it printed, the
    collectives a step)."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import run
    from repro_torch.obs.trace import Tracer, tracing

    job = train_job(cfg, dev, steps=steps, global_batch=MESH_BATCH,
                    seq_len=seq_len or MESH_SEQ, n_micro=MESH_MICRO,
                    mesh_shape=shape,
                    ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Tracer()
    printed = io.StringIO()
    count = CollectiveCount()
    t0 = time.perf_counter()
    with tracing(tr), contextlib.redirect_stdout(printed), \
            mesh_mod.recording(count):
        out = run(job, restore=restore)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    step_s = [sp.dur for sp in tr.spans if sp.name == "train/step"]
    lines = printed.getvalue().splitlines()
    if not lines or not lines[0].startswith("Mesh("):
        raise AssertionError(f"run did not print its mesh: {lines[:1]}")
    times = dict(step_s=step_s, setup_s=total - out["wall_s"],
                 loop_other_s=out["wall_s"] - sum(step_s))
    return (out, times, torch.cuda.max_memory_allocated(), lines[0],
            count.per_step(max(len(step_s), 1)))


def remeshed_restore(dev, cfg, ckpt_dir, saved, stream) -> tuple:
    """The meshed run's last checkpoint restored onto a ``MESH_REMESH``
    mesh of the card as ``run(restore=True)`` restores it
    (``restore(shardings=)``), every leaf equal to the run's final state
    ``saved`` bit for bit, then ``MESH_MORE`` steps from it with the step
    the launcher builds for that mesh, on the stream's next batches.  The
    launcher's resumed run would also write a final 7.15 GB checkpoint
    that nothing reads; its whole cycle is held across the packages on
    the CPU (``tests/test_torch_train_mesh.py``).  Returns (the steps'
    metrics, their seconds and the restore's, the peak device bytes)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.dist.sharding import (activation_rules,
                                           bind_activation_rules,
                                           shardings_from_specs,
                                           tree_flatten_with_path)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import AdamW, make_train_step, warmup_cosine
    from repro_torch.train.train_step import (train_state_specs,
                                              train_state_template)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(MESH_REMESH, ("data", "model"),
                     devices=[dev] * int(np.prod(MESH_REMESH)))
    t0 = time.perf_counter()
    state, meta = Checkpointer(ckpt_dir).restore(
        train_state_template(cfg), shardings=shardings_from_specs(
            train_state_specs(cfg, mesh)[0], mesh))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for (path, got), (_, want) in zip(tree_flatten_with_path(state)[0],
                                      tree_flatten_with_path(saved)[0]):
        if not torch.equal(got.unshard(), want.unshard()):
            raise AssertionError(f"the (2, 2) restore of {path} differs "
                                 f"from the saved state")
    total = MESH_STEPS + MESH_MORE
    step_fn = bind_activation_rules(make_train_step(
        cfg, AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, total)),
        n_micro=MESH_MICRO, micro_batch_axes=("data",)),
        activation_rules(cfg, mesh))
    hist, secs = [], []
    for step in range(int(meta["step"]) + 1, total):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(step).items()}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        hist.append(dict(step=step, **{k: float(v) for k, v in m.items()}))
        secs.append(time.perf_counter() - t0)
    return (hist, dict(step_s=secs, setup_s=restore_s),
            torch.cuda.max_memory_allocated())


def mesh_card_vs_cpu(dev, arch: str, smi: str) -> dict:
    """One meshed step of reduced ``arch`` on (4, 2) in float32 (TF32 off)
    on the card and on a CPU mesh from the same weights, on 8 rows of 64
    positions of its input kind (:func:`family_batch`: qwen2-vl with a
    1 x 4 x 4 image grid, whisper with 40 frames): loss and gradient norm
    within ``TRAIN_REL_TOL``, the weights under ``train_card_vs_cpu``'s
    gates."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (activation_rules,
                                           bind_activation_rules,
                                           tree_flatten_with_path)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import (AdamW, init_train_state, make_train_step,
                                   warmup_cosine)
    from repro_torch.train.train_step import (shard_train_state,
                                              train_state_to_arrays)

    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    n = int(np.prod(MESH_SHAPE))
    batch = family_batch(cfg, 8, 64, np.random.default_rng(0),
                         grid=(1, 4, 4), frames=40)
    got = {}
    for where in (dev, torch.device("cpu")):
        mesh = make_mesh(MESH_SHAPE, ("data", "model"), devices=[where] * n)
        step_fn = bind_activation_rules(make_train_step(
            cfg, opt, n_micro=2, micro_batch_axes=("data",)),
            activation_rules(cfg, mesh))
        state = shard_train_state(init_train_state(cfg, opt, seed=0,
                                                   device="cpu"), mesh)
        t0 = time.perf_counter()
        state, m = step_fn(state, {k: torch.from_numpy(v).to(where)
                                   for k, v in batch.items()})
        metrics = {k: float(v) for k, v in m.items()}
        got[where.type] = (metrics, time.perf_counter() - t0,
                           [np.asarray(a) for _, a in tree_flatten_with_path(
                               train_state_to_arrays(state).params)[0]])
    (cm, cs, cw), (hm, hs, hw) = got["cuda"], got["cpu"]
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(cw, hw)])
    lr = hm["lr"]
    out = dict(card=smi, arch=cfg.name, mesh=list(MESH_SHAPE),
               card_step_s=cs,
               cpu_step_s=hs, loss=(cm["loss"], hm["loss"]),
               grad_norm=(cm["grad_norm"], hm["grad_norm"]),
               aux_loss=(cm["aux_loss"], hm["aux_loss"]), lr=lr,
               weight_diff_median=float(np.median(d)),
               weight_diff_p999=float(np.quantile(d, 0.999)),
               weight_diff_max=float(d.max()))
    out["rel_loss"], out["rel_grad_norm"] = (
        abs(a - b) / abs(b) for a, b in (out["loss"], out["grad_norm"]))
    emit("train_mesh_card_vs_cpu", **out)
    if not (max(out["rel_loss"], out["rel_grad_norm"]) <= TRAIN_REL_TOL
            and out["weight_diff_max"] <= 2 * lr * (1 + 1e-3)
            and out["weight_diff_p999"] <= TRAIN_P999_TOL
            and out["weight_diff_median"] <= TRAIN_MEDIAN_TOL):
        raise AssertionError(f"meshed card against CPU: {out}")
    return out


def family_batch(cfg, rows: int, positions: int, rng, grid=MESH_VLM_GRID,
                 frames: int = MESH_AUDIO_FRAMES) -> dict:
    """A training batch of ``cfg``'s input kind as numpy arrays, drawn from
    ``rng``: ``tokens`` of ``positions + 1`` (the step shifts them);
    whisper's ``enc_embeds`` of ``frames`` beside them; qwen2-vl's
    ``embeds`` and ``labels`` of ``positions`` with ``positions3`` laid
    out as ``vlm_audio`` lays them out (16 text positions, one image of
    ``grid`` merged patches, text)."""
    if cfg.input_kind != "tokens":
        p3, _ = vlm_positions3(rows, positions, MESH_VLM_TEXT_BEFORE, grid)
        return {"embeds": rng.standard_normal(
                    (rows, positions, cfg.d_model), dtype=np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (rows, positions)).astype(np.int32),
                "positions3": p3}
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, positions + 1)).astype(np.int32)}
    if cfg.enc_dec:
        out["enc_embeds"] = rng.standard_normal(
            (rows, frames, cfg.d_model), dtype=np.float32)
    return out


def meshed_steps(dev, cfg, batch: dict, steps: int) -> tuple:
    """``make_train_step(micro_batch_axes=("data",))`` bound to
    ``activation_rules`` on a ``MESH_SHAPE`` mesh of the card, ``steps``
    steps on ``batch`` (the launcher feeds tokens only, so the
    embedding-input and encoder-decoder models train here, as the
    reference's do), each ending in a synchronise, its collectives
    counted.  Returns (the metrics of each step, the step seconds, the peak
    device bytes, the largest entry's state bytes, the collectives a
    step)."""
    from repro_torch.dist.sharding import (activation_rules,
                                           bind_activation_rules)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.train import (AdamW, init_train_state, make_train_step,
                                   warmup_cosine)
    from repro_torch.train.train_step import shard_train_state

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh = mesh_mod.make_mesh(MESH_SHAPE, ("data", "model"),
                              devices=[dev] * int(np.prod(MESH_SHAPE)))
    opt = AdamW(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, steps))
    step_fn = bind_activation_rules(make_train_step(
        cfg, opt, n_micro=MESH_MICRO, micro_batch_axes=("data",)),
        activation_rules(cfg, mesh))
    state = shard_train_state(init_train_state(cfg, opt, seed=0,
                                               device=dev), mesh)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    hist, secs = [], []
    count = CollectiveCount()
    with mesh_mod.recording(count):
        for _ in range(steps):
            t0 = time.perf_counter()
            state, m = step_fn(state, on_card)
            hist.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    state_bytes = entry_state_bytes(state)
    del state
    return (hist, secs, torch.cuda.max_memory_allocated(), state_bytes,
            count.per_step(steps))


def train_mesh_families(dev, smi: str) -> dict:
    """``MESH_FAMILIES`` at published width on ``MESH_SHAPE``, one after
    another, each freed before the next, the counts set to 0 just before
    each and read just after: deepseek, recurrentgemma and xlstm through
    ``TrainJob(mesh_shape=)`` (recurrentgemma's ``tda_monitor`` at step 0,
    whose forward takes the bf16 flash kernel at its ``local_attn``
    layer, window 2,048), qwen2-vl and whisper through the meshed step on
    their own batches (:func:`meshed_steps`).  One line each
    (``train_mesh_families``).  Gates: finite losses and gradient norms,
    the peak under ``TRAIN_MAX_PEAK``, deepseek's aux loss > 0 and
    ``_moe_a2a`` on every MoE layer of every microbatch, recurrentgemma's
    flash launches its ``local_attn`` layers'."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import layer_slots

    out = {}
    for arch, layers, positions in MESH_FAMILIES:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        kinds = [s.kind for s in layer_slots(cfg)]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        calls = []
        real_a2a = moe_mod._moe_a2a

        def counted(*a, **k):
            calls.append(1)
            return real_a2a(*a, **k)

        moe_mod._moe_a2a = counted
        counters = reset_counters()
        try:
            if cfg.input_kind == "tokens" and not cfg.enc_dec:
                run, times, peak, _, coll = meshed_run(
                    dev, cfg, MESH_SHAPE, MESH_FAMILY_STEPS,
                    seq_len=positions,
                    tda_every=MESH_FAMILY_STEPS if cfg.rglru else 0)
                hist, step_s = run["history"], times["step_s"]
                state_bytes = entry_state_bytes(run["state"])
                del run
            else:
                batch = family_batch(cfg, MESH_BATCH, positions,
                                     np.random.default_rng(0))
                hist, step_s, peak, state_bytes, coll = meshed_steps(
                    dev, cfg, batch, MESH_FAMILY_STEPS)
                times = dict(step_s=step_s)
        finally:
            moe_mod._moe_a2a = real_a2a
        launches = {k: fn.launches for k, fn in counters.items()}
        torch.cuda.empty_cache()
        median_s = float(np.median(step_s[1:]))
        tokens = MESH_BATCH * positions
        n_moe = sum(k.endswith("_moe") for k in kinds)
        res = dict(
            card=smi, arch=cfg.name, layers=layers, kinds=kinds,
            mesh=list(MESH_SHAPE), param_dtype=cfg.param_dtype,
            compute_dtype=cfg.compute_dtype, global_batch=MESH_BATCH,
            positions=positions, n_micro=MESH_MICRO,
            enc_frames=MESH_AUDIO_FRAMES if cfg.enc_dec else None,
            loss=[h["loss"] for h in hist],
            grad_norm=[h["grad_norm"] for h in hist],
            aux_loss=[h["aux_loss"] for h in hist], times=times,
            median_step_s=median_s, tokens_per_s=tokens / median_s,
            peak_device_bytes=peak, entry_state_bytes=state_bytes,
            collectives_one_step=coll, moe_a2a_calls=len(calls),
            moe_a2a_expected=n_moe * MESH_MICRO * MESH_FAMILY_STEPS,
            launches=launches,
            tda={k: v for k, v in hist[0].items() if k.startswith("tda_")},
            sub_phase_s=time.perf_counter() - t0)
        emit("train_mesh_families", **res)
        if not (len(hist) == MESH_FAMILY_STEPS
                and all(np.isfinite(res["loss"] + res["grad_norm"]))
                and peak <= TRAIN_MAX_PEAK):
            raise AssertionError(f"meshed {arch}: {res}")
        if cfg.moe is not None and not (
                all(a > 0 for a in res["aux_loss"])
                and len(calls) == res["moe_a2a_expected"]):
            raise AssertionError(f"meshed {arch}'s MoE: {res}")
        if cfg.rglru is not None and not (
                len(res["tda"]) == 3 and launches["flash_attention"]
                == kinds.count("local_attn")):
            raise AssertionError(f"meshed {arch}'s tda_monitor: {res}")
        out[arch] = res
    return out


def train_mesh(dev) -> dict:
    """Phase 6f: the sharded trainer (module constants ``MESH_*``).  The
    counts are set to 0 just before the full-width qwen3 run, whose
    ``tda_monitor`` (step 0) launches the bf16 flash kernel and the PH
    kernels, and read just after.  Gates: finite losses; the first meshed
    loss within ``MESH_UNMESHED_REL`` of the unmeshed step's on the same
    weights and batch; its checkpoint restored onto (2, 2) bit for bit,
    resuming at step ``MESH_STEPS`` (:func:`remeshed_restore`); the peak
    under ``TRAIN_MAX_PEAK``; granite-moe's aux loss > 0 and ``_moe_a2a``
    on every MoE layer of every microbatch; the other five families
    (:func:`train_mesh_families`); the reduced copies card against
    CPU."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import ShardedTokenStream
    from repro_torch.models import moe as moe_mod

    smi = nvidia_smi()
    t0 = time.perf_counter()
    cfg = get_config(MESH_ARCH)
    stream = ShardedTokenStream(vocab=cfg.vocab_size, global_batch=MESH_BATCH,
                                seq=MESH_SEQ + 1)
    torch.cuda.empty_cache()
    flat = unmeshed_reference(dev, cfg, stream)
    counters = reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        out, times, peak, mesh_line, coll = meshed_run(
            dev, cfg, MESH_SHAPE, MESH_STEPS, ckpt_dir=tmp,
            tda_every=MESH_STEPS)
        launches = {k: fn.launches for k, fn in counters.items()}
        hist = out["history"]
        state_bytes = entry_state_bytes(out["state"])
        # its checkpoint: the one its last step wrote
        more_hist, more_times, more_peak = remeshed_restore(
            dev, cfg, tmp, out["state"], stream)
        del out
    torch.cuda.empty_cache()
    tokens = MESH_BATCH * MESH_SEQ
    step_s = times["step_s"]
    median_s = float(np.median(step_s[1:]))
    dense = dict(
        card=smi, arch=cfg.name, mesh=list(MESH_SHAPE), mesh_repr=mesh_line,
        n_layers=cfg.n_layers, d_model=cfg.d_model,
        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype,
        global_batch=MESH_BATCH, seq_len=MESH_SEQ, n_micro=MESH_MICRO,
        rows_per_data_entry=MESH_BATCH // (MESH_MICRO * MESH_SHAPE[0]),
        loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist], times=times,
        median_step_s=median_s, tokens_per_s=tokens / median_s,
        peak_device_bytes=peak, entry_state_bytes=state_bytes,
        collectives_one_step=coll,
        all_to_all_calls=coll.get("all_to_all", {}).get("count", 0),
        unmeshed=flat, rel_first_loss=abs(hist[0]["loss"]
                                          - flat["first_loss"])
        / abs(flat["first_loss"]),
        launches=launches,
        tda={k: v for k, v in hist[0].items() if k.startswith("tda_")},
        remesh=dict(mesh=list(MESH_REMESH),
                    steps=[h["step"] for h in more_hist],
                    loss=[h["loss"] for h in more_hist], times=more_times,
                    restore_s=more_times["setup_s"],
                    peak_device_bytes=more_peak))
    emit("train_mesh", **dense)
    if not (len(hist) == MESH_STEPS and all(np.isfinite(
            dense["loss"] + dense["grad_norm"]))):
        raise AssertionError(f"meshed qwen3: {dense['loss']}, "
                             f"{dense['grad_norm']}")
    if dense["rel_first_loss"] > MESH_UNMESHED_REL:
        raise AssertionError(f"meshed first loss {hist[0]['loss']} against "
                             f"unmeshed {flat['first_loss']}")
    if dense["remesh"]["steps"] != list(range(MESH_STEPS,
                                              MESH_STEPS + MESH_MORE)) \
            or not all(np.isfinite(dense["remesh"]["loss"])):
        raise AssertionError(f"the (2, 2) restore: {dense['remesh']}")
    if max(peak, more_peak) > TRAIN_MAX_PEAK:
        raise AssertionError(f"meshed training peaked at "
                             f"{max(peak, more_peak)} bytes")
    if len(dense["tda"]) != 3 or launches["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"meshed tda_monitor: {dense['tda']}, "
                             f"{launches['flash_attention']} flash launches")

    moe_cfg = get_config(MESH_MOE_ARCH)
    calls = []
    real_a2a = moe_mod._moe_a2a

    def counted(*a, **k):
        calls.append(1)
        return real_a2a(*a, **k)

    moe_mod._moe_a2a = counted
    try:
        mo, mo_times, mo_peak, _, mo_coll = meshed_run(
            dev, moe_cfg, MESH_SHAPE, MESH_MOE_STEPS)
    finally:
        moe_mod._moe_a2a = real_a2a
    mh = mo["history"]
    del mo
    torch.cuda.empty_cache()
    want_calls = moe_cfg.n_layers * MESH_MICRO * MESH_MOE_STEPS
    moe_res = dict(
        card=smi, arch=moe_cfg.name, mesh=list(MESH_SHAPE),
        loss=[h["loss"] for h in mh], aux=[h["aux_loss"] for h in mh],
        grad_norm=[h["grad_norm"] for h in mh], times=mo_times,
        median_step_s=float(np.median(mo_times["step_s"][1:])),
        tokens_per_s=tokens / float(np.median(mo_times["step_s"][1:])),
        peak_device_bytes=mo_peak, moe_a2a_calls=len(calls),
        moe_a2a_expected=want_calls, collectives_one_step=mo_coll,
        all_to_all_calls=mo_coll.get("all_to_all", {}).get("count", 0))
    emit("train_mesh_moe", **moe_res)
    if not (all(np.isfinite(moe_res["loss"] + moe_res["grad_norm"]))
            and all(a > 0 for a in moe_res["aux"])
            and len(calls) == want_calls and mo_peak <= TRAIN_MAX_PEAK):
        raise AssertionError(f"meshed granite-moe: {moe_res}")

    families = train_mesh_families(dev, smi)
    versus = {a: mesh_card_vs_cpu(dev, a, smi) for a in MESH_REDUCED}
    res = dict(dense=dense, moe=moe_res, families=families,
               card_vs_cpu=versus, phase_s=time.perf_counter() - t0)
    emit("train_mesh_done", card=smi, phase_s=res["phase_s"])
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6g: serving over the port's Mesh
# ---------------------------------------------------------------------------

# qwen3-0.6b at full width and depth on (data 4, model 2) entries of the
# card: 8 requests of 1,024 prompt tokens (one sequence pair a data
# entry), then 16 greedy decode steps against a 1,040-slot cache (the
# sequence over model: 520 slots an entry).  granite-moe-1b-a400m at full
# width: one prefill and 4 decode steps.  Its capacity factor is raised to
# n_experts / top_k (4.0) for this phase alone, where neither the meshed
# _moe_a2a (per-shard capacity) nor the unmeshed dispatch (global
# capacity) drops a routing: at the published 1.25 the two drop different
# routings by design (ROADMAP.md §3 item 6), and the meshed drops are held
# to the reference's on the CPU (tests/test_torch_serve_mesh.py).  In
# bf16 its logits are printed against the seam contract, not gated: the
# two paths round the residual stream differently (the meshed wo partials
# are summed in bf16), and at these random weights a token's top-8 of 32
# experts flips under such a rounding (the share of flipped routings a
# layer is printed), which moves its logits past the contract (1.11x of
# it on an H100 at seed 0).  The gate is the same run in float32 compute
# (TF32 off), within SERVE_F32_CONTRACT.
SERVE_MESH_SHAPE = (4, 2)
SERVE_MESH_ARCH, SERVE_MESH_MOE = "qwen3-0.6b", "granite-moe-1b-a400m"
SERVE_MESH_ROWS, SERVE_MESH_PROMPT = 8, 1024
SERVE_MESH_NEW, SERVE_MESH_MOE_NEW = 16, 4
SERVE_MESH_PROFILED = 8      # the decode step profiled (not timed)
# The f32 check: qwen3 cut to 4 of 28 layers in float32 compute (TF32
# off), 8 rows of 32 prompt tokens and 4 decode steps, meshed on the card
# against meshed on the CPU.
SERVE_MESH_F32_LAYERS, SERVE_MESH_F32_PROMPT = 4, 32
SERVE_MESH_F32_TOL = 1e-4
# (d) serve_mesh_families: the other five families at published width on
# (4, 2), cut in depth as train_mesh_families cuts them (MESH_FAMILIES),
# 8 rows each and 4 decode steps, held to their unmeshed steps as qwen3 is.
# Prompts (decoder positions): deepseek 512; recurrentgemma 2,304, past
# its 2,048 window so that the window masks in the flash prefill and
# across the decode cache's blocks, but short of 3,072, where the two
# float32 logits of its 256,000-row vocabulary (unmeshed and meshed, 25 GB
# each) would hold most of the card; xlstm 256, a multiple of its 64-token
# chunk; qwen2-vl 512 laid out as MESH_VLM_* lays them out; whisper 224
# over MESH_AUDIO_FRAMES.  deepseek runs at a capacity factor of
# n_experts / top_k.  SERVE_MESH_F32_GATED's bf16 logits are printed
# against the contract and their float32 run (TF32 off) is the gate, as
# granite-moe's: deepseek's top-6 of 64 experts may flip under bf16
# rounding; xlstm's bf16 prefill logits on the card move by about the
# same as the meshed ones when the unmeshed prefill runs a data entry's
# 2 rows a call in place of all 8 (the GEMMs' row count changes their
# bf16 rounding, which its exponential gates amplify;
# tools/serve_mesh_rounding_probe.py).  (e) The five reduced
# copies (float32) join the f32 check, card against CPU: 8 rows of 32
# prompt positions (qwen2-vl with a 1 x 4 x 4 image after 4 text
# positions, whisper over 40 frames), 4 decode steps.
SERVE_MESH_FAMILY_PROMPT = {"deepseek-v2-lite-16b": 512,
                            "recurrentgemma-9b": 2304,
                            "xlstm-1.3b": 256,
                            "qwen2-vl-2b": 512,
                            "whisper-small": 224}
SERVE_MESH_FAMILY_NEW = 4
SERVE_MESH_F32_GATED = ("deepseek-v2-lite-16b", "xlstm-1.3b")
SERVE_MESH_F32_REDUCED = ("deepseek-v2-lite-16b", "xlstm-1.3b",
                          "recurrentgemma-9b", "qwen2-vl-2b",
                          "whisper-small")


def serve_mesh_params(cfg, model, mesh):
    """``model``'s weights as the reference's tree of ``ShardedTensor``s
    laid out for serving (``shard_params(..., fsdp=False)``)."""
    from repro_torch.dist.sharding import (shard_params, shard_tree,
                                           shardings_from_specs)
    from repro_torch.models.transformer import arrays_from_named

    tree = arrays_from_named(dict(model.named_parameters()), cfg,
                             on_device=True)
    specs, _ = shard_params(tree, mesh, fsdp=False, heads={
        "q": cfg.n_heads, "kv": cfg.n_kv_heads})
    return shard_tree(tree, shardings_from_specs(specs, mesh))


def serve_mesh_steps(cfg, mesh, rows: int):
    from repro_torch.dist.sharding import (activation_rules,
                                           bind_activation_rules)
    from repro_torch.serve.steps import make_decode_step, make_prefill_step

    return (bind_activation_rules(make_prefill_step(cfg), activation_rules(
        cfg, mesh, batch=rows)),
        bind_activation_rules(make_decode_step(cfg), activation_rules(
            cfg, mesh, decode=True, batch=rows)))


def token_prompts(cfg, dev, rows: int, prompt: int):
    """:func:`serve_mesh_model`'s default inputs: ``rows`` prompts of
    ``prompt`` random tokens (seed 0); each decode step feeds the greedy
    token."""
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (rows, prompt), dtype=np.int32)).to(dev)
    return lambda model: ({"tokens": toks}, lambda tok, pos: {"tokens": tok})


def serve_mesh_model(dev, cfg, n_new: int, smi: str, counters=None,
                     profile: bool = False, contract: float = SERVE_CONTRACT,
                     gate: bool = True, prompt: int = SERVE_MESH_PROMPT,
                     inputs=None) -> dict:
    """Phase 6g's run of one model: the unmeshed prefill and ``n_new``
    greedy decode steps first, then the meshed steps over
    ``SERVE_MESH_SHAPE`` of the card from the same weights, teacher-forced
    on the unmeshed tokens (the counts set to 0 just before the meshed
    run and read just after, where ``counters`` are given).  Each meshed
    logits (the prefill's and every step's) within ``contract * max(1,
    max |logits|)`` of the unmeshed ones where ``gate``, else printed
    against it; the greedy tokens that agree are printed, not gated.  An
    MoE model's prefill routings are compared token by token.
    ``inputs(model)`` gives the prefill batch of ``SERVE_MESH_ROWS`` rows
    of ``prompt`` positions and a function of (the greedy token, its
    position) to the decode step's batch (:func:`token_prompts` by
    default); the meshed run takes the unmeshed run's decode batches."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.steps import (extend_cache, make_decode_step,
                                         make_prefill_step, sample_greedy)

    rows = SERVE_MESH_ROWS
    s_max = prompt + n_new
    t_start = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    batch, to_step = (inputs or token_prompts(cfg, dev, rows, prompt))(model)
    worst = []

    def hold(got, want, what):
        diff = sharded_max_diff(got, want)
        lo, hi = torch.aminmax(want)   # no |want| copy of large logits
        atol = contract * max(1.0, -float(lo), float(hi))
        worst.append(diff / atol)
        if gate and not diff <= atol:
            raise AssertionError(f"meshed {cfg.name} {what}: logits "
                                 f"{diff} from the unmeshed > {atol}")

    real_route, routes = moe_mod._route, []

    def route(*a, **k):
        out = real_route(*a, **k)
        routes.append(torch.sort(out[2], dim=-1).values.cpu())
        return out

    moe_mod._route = route
    try:
        with torch.no_grad():
            u_logits, u_cache = make_prefill_step(cfg)(model, batch)
    finally:
        moe_mod._route = real_route
    u_routes, routes = routes, []
    with torch.no_grad():
        u_cache = extend_cache(cfg, u_cache, prompt, s_max)
        want_tokens = [sample_greedy(u_logits)]
        u_steps, steps_in = [], []
        decode = make_decode_step(cfg)
        for i in range(n_new):
            steps_in.append(dict(to_step(want_tokens[-1].to(dev),
                                         prompt + i), cache_pos=prompt + i))
            lg, u_cache = decode(model, u_cache, steps_in[-1])
            u_steps.append(lg)
            want_tokens.append(sample_greedy(lg))
        del u_cache, to_step       # to_step may hold the model
    torch.cuda.empty_cache()
    t_unmeshed = time.perf_counter()

    n = int(np.prod(SERVE_MESH_SHAPE))
    mesh = make_mesh(SERVE_MESH_SHAPE, ("data", "model"),
                     devices=[dev] * n)
    params = serve_mesh_params(cfg, model, mesh)
    del model
    torch.cuda.empty_cache()
    prefill, step = serve_mesh_steps(cfg, mesh, rows)
    torch.cuda.synchronize()
    t_sharded = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if counters is not None:
        for fn in counters.values():
            fn.launches = 0
    pre_count, ext_count, dec_count = (CollectiveCount() for _ in range(3))
    t0 = time.perf_counter()
    moe_mod._route = route
    try:
        with mesh_mod.recording(pre_count):
            logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
    finally:
        moe_mod._route = real_route
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with mesh_mod.recording(ext_count):
        cache = extend_cache(cfg, cache, prompt, s_max)
    torch.cuda.synchronize()
    extend_s = time.perf_counter() - t0
    hold(logits, u_logits, "prefill")
    del u_logits
    agree = [int((sample_greedy(logits) == want_tokens[0]).sum())]
    del logits
    step_s, profile_out = [], None
    del batch
    for i in range(n_new):
        if profile and i == SERVE_MESH_PROFILED:
            profile_out = profiled_decode(step, params, cache, steps_in[i])
            lg = profile_out.pop("logits")
        else:
            t0 = time.perf_counter()
            with mesh_mod.recording(dec_count):
                lg, cache = step(params, cache, steps_in[i])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        hold(lg, u_steps[i], f"decode step {i}")
        agree.append(int((sample_greedy(lg) == want_tokens[i + 1]).sum()))
    launches = {k: fn.launches for k, fn in counters.items()} \
        if counters is not None else None
    peak = torch.cuda.max_memory_allocated()
    out = dict(
        card=smi, arch=cfg.name, mesh=list(SERVE_MESH_SHAPE),
        n_layers=cfg.n_layers, d_model=cfg.d_model,
        compute_dtype=cfg.compute_dtype, rows=rows, prompt=prompt,
        s_max=s_max, decode_steps=n_new, prefill_s=prefill_s,
        extend_cache_s=extend_s, decode_ms=[t * 1e3 for t in step_s],
        decode_ms_median=float(np.median(step_s)) * 1e3,
        largest_entry_cache_bytes=entry_state_bytes(cache),
        peak_device_bytes=peak,
        collectives_prefill=pre_count.per_step(1),
        collectives_extend_cache=ext_count.per_step(1),
        collectives_decode_step=dec_count.per_step(len(step_s)),
        greedy_agree=agree, greedy_of=rows,
        worst_logits_share_of_contract=max(worst), launches=launches,
        profiled_decode_step=profile_out,
        part_s=dict(unmeshed=t_unmeshed - t_start,
                    shard=t_sharded - t_unmeshed,
                    meshed=time.perf_counter() - t_sharded))
    if cfg.moe is not None:
        # each layer's routings: one call unmeshed, one a data entry
        # meshed (rows in order)
        per = len(routes) // len(u_routes)
        flipped = [float((torch.cat(routes[i * per:(i + 1) * per])
                          != u).any(dim=-1).float().mean())
                   for i, u in enumerate(u_routes)]
        out.update(capacity_factor=cfg.moe.capacity_factor,
                   tokens_with_flipped_routing_by_layer=flipped,
                   contract=contract, gated=gate)
    del cache, params
    torch.cuda.empty_cache()
    return out


def sharded_max_diff(got, want: torch.Tensor) -> float:
    """The largest ``|got - want|``, ``got`` a tensor or a meshed step's
    ``ShardedTensor``, taken a distinct block and a row at a time (no
    whole copy of logits that may hold tens of GB)."""
    if isinstance(got, torch.Tensor):
        return float((got - want).abs().max())
    worst, done = 0.0, set()
    for i, blk in enumerate(got.blocks):
        key = got.sharding.block_index(i)
        if key in done:
            continue
        done.add(key)
        w = want[got.sharding.block_slices(got.shape, i)]
        for r in range(blk.shape[0]):
            worst = max(worst, float((blk[r] - w[r]).abs().max()))
    return worst


def profiled_decode(step, params, cache, batch) -> dict:
    """One meshed decode step under ``torch.profiler`` (CUDA activity
    alone: the host's some 40,000 events a step would take longer to
    collect than the step): its wall (timed inside the profiler), the
    card's busy and idle share over it, and its longest kernels; the
    step's logits under ``logits``."""
    ((lg, _), wall), evs = profiled(lambda: timed(
        lambda: step(params, cache, batch)), host=False)
    return dict(device_summary(evs, wall, 6), logits=lg)


def family_prompts(cfg, dev, rows: int, prompt: int):
    """:func:`serve_mesh_model`'s inputs for ``cfg``'s input kind, drawn
    from seed 0: tokens (:func:`token_prompts`), with whisper's
    ``MESH_AUDIO_FRAMES`` encoder frames (seed 1) beside them; qwen2-vl's
    embeddings of random text tokens (rows of the tied table) with one
    image of ``MESH_VLM_GRID`` merged patches after
    ``MESH_VLM_TEXT_BEFORE`` text positions, and their ``positions3``
    (:func:`vlm_positions3`), each decode step feeding the table row of
    the greedy token at the next text index on all three axes."""
    if cfg.input_kind == "tokens":
        make = token_prompts(cfg, dev, rows, prompt)
        if not cfg.enc_dec:
            return make
        frames = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (rows, MESH_AUDIO_FRAMES, cfg.d_model), dtype=np.float32),
            device=dev)

        def with_frames(model):
            batch, step = make(model)
            return dict(batch, enc_embeds=frames), step
        return with_frames
    p3, nxt = vlm_positions3(rows, prompt, MESH_VLM_TEXT_BEFORE,
                             MESH_VLM_GRID)
    rng = np.random.default_rng(0)
    text = torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, prompt)),
                           device=dev)
    n_img = int(np.prod(MESH_VLM_GRID))
    img = torch.as_tensor(rng.standard_normal(
        (rows, n_img, cfg.d_model), dtype=np.float32), device=dev)

    def make(model):
        with torch.no_grad():
            embeds = model.embed[text]
            embeds[:, MESH_VLM_TEXT_BEFORE:MESH_VLM_TEXT_BEFORE + n_img] = img

        def step(tok, pos):
            with torch.no_grad():
                return {"embeds": model.embed[tok.long()],
                        "positions3": torch.full((3, rows, 1),
                                                 nxt + pos - prompt,
                                                 device=dev)}
        return {"embeds": embeds,
                "positions3": torch.as_tensor(p3, device=dev)}, step
    return make


def serve_mesh_families(dev, smi: str, counters) -> dict:
    """Phase 6g (d): ``SERVE_MESH_FAMILY_PROMPT``'s five families through
    :func:`serve_mesh_model`, one after another, each freed before the
    next, the counts set to 0 just before each meshed run and read just
    after.  One line each (``serve_mesh_families``).  Gates: the logits
    within the seam contract (``SERVE_MESH_F32_GATED``: the float32 run
    within ``SERVE_F32_CONTRACT``, the bf16 run printed), one flash
    launch an attention layer (whisper's encoder layers too) and (data,
    model) entry of each meshed prefill (the bf16 kernel's; a float32
    run's, the float32 kernel's), no PH kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import is_attention, layer_slots

    depth = {arch: layers for arch, layers, _ in MESH_FAMILIES}
    n = int(np.prod(SERVE_MESH_SHAPE))
    out = {}
    for arch, prompt in SERVE_MESH_FAMILY_PROMPT.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=depth[arch])
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        kinds = [sl.kind for sl in layer_slots(cfg)]
        want = sum(is_attention(k) for k in kinds) * n
        inputs = family_prompts(cfg, dev, SERVE_MESH_ROWS, prompt)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        f32_gate = arch in SERVE_MESH_F32_GATED
        runs = [("bf16", serve_mesh_model(
            dev, cfg, SERVE_MESH_FAMILY_NEW, smi, counters,
            gate=not f32_gate, prompt=prompt, inputs=inputs))]
        if f32_gate:
            torch.backends.cuda.matmul.allow_tf32 = False
            runs.append(("f32", serve_mesh_model(
                dev, dataclasses.replace(cfg, compute_dtype="float32"),
                SERVE_MESH_FAMILY_NEW, smi, counters,
                contract=SERVE_F32_CONTRACT, prompt=prompt, inputs=inputs)))
        res = dict(runs[0][1], kinds=kinds, flash_expected=want,
                   enc_frames=MESH_AUDIO_FRAMES if cfg.enc_dec else None,
                   sub_phase_s=time.perf_counter() - t0)
        if len(runs) > 1:
            res["f32"] = runs[1][1]
        emit("serve_mesh_families", **res)
        for what, run in runs:
            got = run["launches"]
            if got["flash_attention"] != want or any(
                    got[k] for k in PH_KERNELS + OFF_PATH_KERNELS):
                raise AssertionError(f"meshed {arch} serving ({what}) "
                                     f"launched {got}, not {want} flash "
                                     f"launches alone")
        out[arch] = res
        torch.cuda.empty_cache()
    return out


def seq_part(key: str, v: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Positions ``[lo, hi)`` of a serving input (``positions3`` (3, B, S);
    ``tokens`` and ``embeds`` (B, S, ...))."""
    return v[:, :, lo:hi] if key == "positions3" else v[:, lo:hi]


def serve_mesh_f32(dev, smi: str, arch: Optional[str] = None) -> dict:
    """The meshed prefill and 4 decode steps in float32 compute (TF32 off)
    on (4, 2) of the card (the float32 flash kernel on each entry's
    heads) and on a CPU mesh, from the same weights and inputs (seed 1);
    every logits within ``SERVE_MESH_F32_TOL * max |logits|``.  The model:
    qwen3 cut to ``SERVE_MESH_F32_LAYERS`` layers, or the reduced copy of
    ``arch`` (qwen2-vl's embeddings with a 1 x 4 x 4 image grid in
    ``positions3``; whisper's 40 encoder frames)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import (init_params, is_attention,
                                                layer_slots)
    from repro_torch.serve.steps import extend_cache

    if arch is None:
        cfg = dataclasses.replace(get_config(SERVE_MESH_ARCH),
                                  n_layers=SERVE_MESH_F32_LAYERS,
                                  compute_dtype="float32")
    else:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    prompt, n_new, rows = SERVE_MESH_F32_PROMPT, 4, SERVE_MESH_ROWS
    rng = np.random.default_rng(1)
    if cfg.input_kind == "tokens":
        seq = {"tokens": rng.integers(0, cfg.vocab_size,
                                      (rows, prompt + n_new), dtype=np.int32)}
    else:
        seq = {"embeds": rng.standard_normal(
                   (rows, prompt + n_new, cfg.d_model), dtype=np.float32),
               "positions3": vlm_positions3(rows, prompt + n_new, 4,
                                            (1, 4, 4))[0]}
    fixed = {"enc_embeds": rng.standard_normal(
        (rows, 40, cfg.d_model), dtype=np.float32)} if cfg.enc_dec else {}

    def part(lo, hi, where, **more):
        out = {k: torch.from_numpy(np.ascontiguousarray(
            seq_part(k, v, lo, hi))).to(where) for k, v in seq.items()}
        return dict(out, **more)

    model = init_params(cfg, seed=0, device="cpu")
    n = int(np.prod(SERVE_MESH_SHAPE))
    got, secs = [], []
    counters = reset_counters()
    for where in (dev, torch.device("cpu")):
        mesh = make_mesh(SERVE_MESH_SHAPE, ("data", "model"),
                         devices=[where] * n)
        params = serve_mesh_params(cfg, model, mesh)
        prefill, step = serve_mesh_steps(cfg, mesh, rows)
        t0 = time.perf_counter()
        logits, cache = prefill(params, part(0, prompt, where, **{
            k: torch.from_numpy(v).to(where) for k, v in fixed.items()}))
        out = [logits.unshard().cpu()]
        cache = extend_cache(cfg, cache, prompt, prompt + n_new)
        for i in range(prompt, prompt + n_new):
            logits, cache = step(params, cache, part(i, i + 1, where,
                                                     cache_pos=i))
            out.append(logits.unshard().cpu())
        secs.append(time.perf_counter() - t0)
        got.append(out)
        if where is dev:
            f32_launches = counters["flash_attention"].launches
    rel = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(*got))
    want = sum(is_attention(sl.kind) for sl in layer_slots(cfg)) * n
    res = dict(card=smi, arch=cfg.name, n_layers=cfg.n_layers,
               reduced=arch is not None,
               compute_dtype="float32", mesh=list(SERVE_MESH_SHAPE),
               rows=rows, prompt=prompt, decode_steps=n_new,
               card_s=secs[0], cpu_s=secs[1],
               max_rel_logits=rel, flash_f32_launches=f32_launches,
               flash_f32_expected=want)
    emit("serve_mesh_card_vs_cpu", **res)
    if not (rel <= SERVE_MESH_F32_TOL and f32_launches == want):
        raise AssertionError(f"meshed f32 serving, card against CPU: {res}")
    return res


def serve_mesh(dev) -> dict:
    """Phase 6g: serving over the port's Mesh (module constants
    ``SERVE_MESH_*``).  qwen3-0.6b at full width and depth, its counts
    set to 0 just before the meshed run and read just after: one bf16
    flash launch a layer and (data, model) entry of the prefill (28 x 8);
    granite-moe-1b-a400m at full width; the other five families
    (:func:`serve_mesh_families`); each held to its unmeshed logits; then
    the float32 check, card against CPU, of qwen3 and of the five reduced
    copies."""
    from repro_torch.configs import get_config

    smi = nvidia_smi()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    counters = kernel_counters()
    cfg = get_config(SERVE_MESH_ARCH)
    dense = serve_mesh_model(dev, cfg, SERVE_MESH_NEW, smi, counters,
                             profile=True)
    emit("serve_mesh", **dense)
    want = cfg.n_layers * int(np.prod(SERVE_MESH_SHAPE))
    if dense["launches"]["flash_attention"] != want or any(
            dense["launches"][k] for k in PH_KERNELS + OFF_PATH_KERNELS):
        raise AssertionError(f"meshed serving launched "
                             f"{dense['launches']}, not {want} flash "
                             f"launches alone")
    moe_cfg = get_config(SERVE_MESH_MOE)
    moe_cfg = dataclasses.replace(moe_cfg, moe=dataclasses.replace(
        moe_cfg.moe, capacity_factor=moe_cfg.moe.n_experts
        / moe_cfg.moe.top_k))
    moe = serve_mesh_model(dev, moe_cfg, SERVE_MESH_MOE_NEW, smi,
                           gate=False)
    emit("serve_mesh_moe", **moe)
    torch.backends.cuda.matmul.allow_tf32 = False
    moe32 = serve_mesh_model(dev, dataclasses.replace(
        moe_cfg, compute_dtype="float32"), SERVE_MESH_MOE_NEW, smi,
        contract=SERVE_F32_CONTRACT)
    emit("serve_mesh_moe_f32", **moe32)
    families = serve_mesh_families(dev, smi, counters)
    f32 = serve_mesh_f32(dev, smi)
    families_f32 = {a: serve_mesh_f32(dev, smi, a)
                    for a in SERVE_MESH_F32_REDUCED}
    res = dict(dense=dense, moe=moe, moe_f32=moe32, families=families,
               f32=f32, families_f32=families_f32,
               phase_s=time.perf_counter() - t0)
    emit("serve_mesh_done", card=smi, phase_s=res["phase_s"])
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
    mesh_trained = train_mesh(dev)
    mesh_served = serve_mesh(dev)
    ssm = ssm_archs(dev)
    vlm = vlm_audio(dev)
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
    dryrun(dev, trained["dryrun_check"])
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
    mesh_train_launches = bf16(mesh_trained["dense"]["launches"])
    mesh_serve_launches = dict(
        bf16(mesh_served["dense"]["launches"]),
        flash_attention_f32=mesh_served["f32"]["flash_f32_launches"])
    family_launches = {a: bf16(r["launches"])
                       for a, r in mesh_trained["families"].items()}
    serve_family_launches = {
        a: dict(bf16(r["launches"]), flash_attention_f32=(
            r["f32"]["launches"]["flash_attention"] if "f32" in r else 0))
        for a, r in mesh_served["families"].items()}
    ssm_launches = {a: bf16(r["launches"]) for a, r in ssm.items()}
    vlm_launches = {a: bf16(r["launches"]) for a, r in vlm.items()}

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
            train_mesh_launches=mesh_train_launches[kname],
            serve_mesh_launches=mesh_serve_launches[kname],
            serve_mesh_families_launches={
                a: n[kname] for a, n in serve_family_launches.items()},
            train_mesh_families_launches={
                a: n[kname] for a, n in family_launches.items()},
            ssm_archs_launches={a: n[kname] for a, n in ssm_launches.items()},
            vlm_audio_launches={a: n[kname] for a, n in vlm_launches.items()},
            wrapper_ms=e["wrapper_ms"], shape=e["shape"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
