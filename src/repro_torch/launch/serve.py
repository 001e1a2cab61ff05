"""Batched token serving over synthetic traffic.

Port of ``src/repro/launch/serve.py``, ``--workload tokens`` only (the PH
workload waits for ``PHServeEngine``, ROADMAP.md §1, item 7).  The
default config is the reduced one, as the reference's; ``--full`` serves
the published width.  Runs on the card unless ``--device cpu``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --workload tokens \
        --arch qwen3-0.6b --requests 16 --max-new 24
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --prompt-len 2048 --s-max 2112 --max-new 32
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
    return done


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
    args = ap.parse_args(argv)
    if args.workload == "ph":
        raise NotImplementedError("--workload ph: PHServeEngine is not "
                                  "ported yet (ROADMAP.md §1, item 7)")
    run_tokens(args)


if __name__ == "__main__":
    main()
