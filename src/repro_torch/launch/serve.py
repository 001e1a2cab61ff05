"""Batched serving drivers over synthetic traffic.

Port of ``src/repro/launch/serve.py``.  Two workloads share the launcher:

* ``--workload tokens`` — the transformer ``ServeEngine`` (fixed-slot
  continuous batching over a shared KV cache).  The default config is the
  reduced one, as the reference's; ``--full`` serves the published width.
* ``--workload ph`` — ``PHServeEngine``: admission-controlled persistent
  homology serving with union-batched cold requests and warm-start
  incremental updates (tau growth / point arrival) against the dataset
  cache; the reference's ``run_ph`` traffic and flags.

Both run on the card unless ``--device cpu``; on the card the summary also
names the card and its power limit.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload tokens \
        --arch qwen3-0.6b --requests 16 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --prompt-len 2048 --s-max 2112 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --workload ph \
        --requests 24 --cloud-size 48 --update-fraction 0.5 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.obs.trace import stopwatch


def run_tokens(args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(args.arch, reduced=not args.full)
    engine = ServeEngine(cfg, max_batch=args.max_batch,
                         prompt_len=args.prompt_len, s_max=args.s_max,
                         seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, args.prompt_len),
                              dtype=np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new=args.max_new))

    with stopwatch("serve/run") as sw:
        done = engine.run()
    wall = sw.elapsed
    total_tokens = sum(len(v) for v in done.values())
    print(f"served {len(done)}/{args.requests} requests, "
          f"{total_tokens} tokens in {wall:.2f}s "
          f"({total_tokens / wall:.1f} tok/s batched on "
          f"{engine.device.type})")
    for uid in sorted(done)[:4]:
        print(f"  req {uid}: {done[uid][:12]}...")
    _print_card(engine.device)
    return done


def run_ph(args):
    """The reference launcher's PH traffic: a cold wave of
    ``requests * (1 - update_fraction)`` clouds, then an update wave that
    alternates tau growth (1.5x) and point arrival (``arrivals`` points)
    on random cached datasets.  Returns the engine."""
    from repro_torch.serve.ph import PHRequest, PHServeEngine

    engine = PHServeEngine(
        memory_budget_bytes=args.budget_bytes,
        store_budget_bytes=args.store_budget_bytes,
        max_batch_clouds=args.max_batch_clouds,
        landmark_cap=args.landmark_cap,
        seed=args.seed,
        engine=args.reduce_engine,
        batch_size=args.batch_size,
        n_shards=args.n_shards,
        device=args.device)
    rng = np.random.default_rng(args.seed)
    n_cold = max(1, int(round(args.requests * (1 - args.update_fraction))))
    clouds = [rng.normal(size=(args.cloud_size, 3)) for _ in range(n_cold)]
    uid = 0
    for k, p in enumerate(clouds):
        engine.submit(PHRequest(uid=uid, points=p, tau_max=args.tau,
                                dataset=f"ds{k}"))
        uid += 1
    with stopwatch("serve_ph/cold_wave") as sw_cold:
        engine.run()
    # update wave: alternate tau growth and point arrival on cached datasets
    while uid < args.requests:
        k = int(rng.integers(0, n_cold))
        if uid % 2 == 0:
            engine.submit(PHRequest(uid=uid, points=clouds[k],
                                    tau_max=args.tau * 1.5,
                                    dataset=f"ds{k}"))
        else:
            grown = np.concatenate(
                [clouds[k], rng.normal(size=(args.arrivals, 3))], axis=0)
            engine.submit(PHRequest(uid=uid, points=grown,
                                    tau_max=args.tau, dataset=f"ds{k}"))
        uid += 1
    with stopwatch("serve_ph/update_wave") as sw_warm:
        engine.run()
    s = engine.stats()
    served = int(s.get("serve_ph_n_admitted", 0))
    wall = sw_cold.elapsed + sw_warm.elapsed
    hits = s.get("serve_ph_n_cache_hits", 0.0)
    hit_ratio = hits / max(1.0, s.get("serve_ph_n_requests", 0.0))
    print(f"served {served}/{args.requests} PH requests in {wall:.2f}s "
          f"({served / wall:.1f} req/s), cache-hit ratio {hit_ratio:.2f}")
    for key in ("serve_ph_n_cold", "serve_ph_n_batched",
                "serve_ph_n_warm_tau", "serve_ph_n_warm_points",
                "serve_ph_n_rejected", "serve_ph_store_bytes"):
        print(f"  {key} = {s.get(key, 0.0):.0f}")
    _print_card(engine.device)
    return engine


def _print_card(device) -> None:
    """On the card: its name and power limit, as ``nvidia-smi`` gives
    them."""
    if device.type != "cuda":
        return
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"  card: {out.stdout.strip().splitlines()[0]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", choices=("tokens", "ph"), default="tokens")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--full", action="store_true",
                    help="serve the published width (default: reduced)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--s-max", type=int, default=128)
    # ph workload
    ap.add_argument("--cloud-size", type=int, default=48)
    ap.add_argument("--tau", type=float, default=1.6)
    ap.add_argument("--arrivals", type=int, default=6,
                    help="points appended per point-arrival update")
    ap.add_argument("--update-fraction", type=float, default=0.5,
                    help="fraction of requests that are warm updates")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="admission memory budget per reduction")
    ap.add_argument("--store-budget-bytes", type=int, default=None,
                    help="per-tenant cached-state budget")
    ap.add_argument("--max-batch-clouds", type=int, default=8)
    ap.add_argument("--landmark-cap", type=int, default=None)
    ap.add_argument("--reduce-engine", default="single",
                    choices=("single", "batch", "packed"))
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--n-shards", type=int, default=None)
    args = ap.parse_args(argv)
    if args.workload == "tokens":
        run_tokens(args)
    else:
        run_ph(args)


if __name__ == "__main__":
    main()
