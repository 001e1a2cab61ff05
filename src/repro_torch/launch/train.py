"""End-to-end training on one device: the launcher.

Port of ``src/repro/launch/train.py``.  Runs a ported architecture (full or
``--reduced``): data pipeline -> train state -> microbatched step -> async
checkpointing -> metrics, with optional TDA monitoring (the paper's
technique applied to the model's own hidden states: persistence diagrams of
the final-layer activation point cloud, logged every ``--tda-every``
steps).  It prints the reference's JSON lines and ``done:`` line; each
step is a ``train/step`` span when tracing is on.

It runs on the card unless ``--device cpu`` (``TrainJob.device``).

``TrainJob.mesh_shape`` trains over a mesh, as the reference's does: axes
``("data", "model")`` for two dimensions, ``("pod", "data", "model")`` for
three, every entry on the job's device (``make_mesh(mesh_shape, axes,
devices=[device] * n)``; entries on distinct cards wait for the transport
between them, ROADMAP.md §1 item 5).  ``run`` prints the mesh once, shards
the state as ``shard_params(..., fsdp=True)`` says, binds the step to
``activation_rules(cfg, mesh)`` with the data axes as its microbatch axes,
restores a checkpoint of any mesh shape onto this one, and saves whole
arrays.  Every architecture trains on a mesh; the launcher feeds tokens
only, as the reference's does, so qwen2-vl and whisper train through
``make_train_step`` with their own batches.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 15 --batch 8 --seq 32 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.tokens import ShardedTokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.sharding import (activation_rules,
                                       bind_activation_rules,
                                       shardings_from_specs)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import active_tracer, span, stopwatch
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.train_step import (gathered_model, init_train_state,
                                          load_train_state_, make_train_step,
                                          shard_train_state,
                                          train_state_specs,
                                          train_state_template,
                                          train_state_to_arrays)


@dataclasses.dataclass
class TrainJob:
    cfg: ModelConfig
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    n_micro: int = 1
    lr: float = 3e-4
    warmup: int = 20
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    tda_every: int = 0
    mesh_shape: Optional[tuple] = None       # e.g. (4, 2): (data, model)
    log_every: int = 10
    device: DeviceLike = None


def tda_monitor(params, cfg: ModelConfig, batch: Dict[str, np.ndarray]
                ) -> Dict[str, float]:
    """PH of the final hidden-state point cloud (Dory engine on the model's
    own representations) — H0/H1 Betti summary at the median pairwise scale.

    ``params`` is the model (a meshed run passes its gathered parameters,
    ``gathered_model``).  The forward runs under ``torch.no_grad()`` with
    positions ``arange(S)``: on the card, the flash kernel's route."""
    from repro_torch.models.transformer import forward

    dev = params.device
    sub = {k: torch.as_tensor(np.asarray(v[:4])).to(dev)
           for k, v in batch.items()}
    if cfg.input_kind == "tokens":
        sub["tokens"] = sub["tokens"][:, :-1]
    with torch.no_grad():
        logits, _ = forward(params, sub)
    # final hidden states ~ logits are too wide; use a random projection
    x = logits[..., :64].to(torch.float64).cpu().numpy()
    return _tda_summary(x, dev)


def _tda_summary(x: np.ndarray, device) -> Dict[str, float]:
    """The monitor's PH part on ``x`` (the float64 logits' first 64
    columns): ``compute_ph`` with the reference's defaults (the single
    engine, the dense backend) on the first 256 positions."""
    from repro_torch.core import compute_ph

    pts = x.reshape(-1, x.shape[-1])[:256]
    res = compute_ph(points=pts, maxdim=1,
                     tau_max=float(np.quantile(
                         np.linalg.norm(pts[:1] - pts, axis=-1), 0.5)) + 1e-6,
                     device=device)
    b = res.betti_at(res.stats.get("tau_med", 0.0))
    return {"tda_h0_pairs": float(len(res.diagrams[0])),
            "tda_h1_pairs": float(len(res.diagrams[1])),
            "tda_b0": float(b.get(0, 0))}


def _mesh_axes(shape) -> tuple:
    """The reference launcher's axes for a mesh shape."""
    if len(shape) == 2:
        return ("data", "model")
    if len(shape) == 3:
        return ("pod", "data", "model")
    raise ValueError(f"mesh_shape {tuple(shape)}: the trainer's meshes are "
                     f"(data, model) or (pod, data, model)")


def run(job: TrainJob, restore: bool = False) -> Dict[str, Any]:
    cfg = job.cfg
    dev = resolve_device(job.device)
    opt = AdamW(lr=warmup_cosine(job.lr, job.warmup, max(job.steps, 2)))

    mesh = None
    if job.mesh_shape is not None:
        shape = tuple(int(n) for n in job.mesh_shape)
        mesh = make_mesh(shape, _mesh_axes(shape),
                         devices=[dev] * int(np.prod(shape)))
        print(repr(mesh))

    step_fn = make_train_step(
        cfg, opt, n_micro=job.n_micro,
        micro_batch_axes=(tuple(a for a in ("pod", "data")
                                if a in mesh.axis_names) if mesh else None))

    ckpt = Checkpointer(job.ckpt_dir) if job.ckpt_dir else None
    start_step = 0
    resume = restore and ckpt is not None and ckpt.latest_step() is not None
    if mesh is not None:
        step_fn = bind_activation_rules(step_fn, activation_rules(cfg, mesh))
        ssh = shardings_from_specs(train_state_specs(cfg, mesh)[0], mesh)
        if resume:
            # whole arrays from the files, each laid out on this mesh
            state, meta = ckpt.restore(train_state_template(cfg),
                                       shardings=ssh)
            start_step = int(meta.get("step", 0)) + 1
        else:
            state = shard_train_state(init_train_state(cfg, opt, job.seed,
                                                       dev), mesh)
    else:
        state = init_train_state(cfg, opt, job.seed, dev)
        if resume:
            # a template of shapes alone, and the restored arrays copied
            # into the live state: one model on the device, no host copy
            tree, meta = ckpt.restore(train_state_to_arrays(
                state, shapes_only=True))
            state = load_train_state_(state, tree)
            del tree
            start_step = int(meta.get("step", 0)) + 1

    stream = ShardedTokenStream(vocab=cfg.vocab_size,
                                global_batch=job.global_batch,
                                seq=job.seq_len + 1, seed=job.seed)
    history = []
    saved = None
    # A traced step waits for the card before its span ends, so that every
    # train/step span holds its own step's device work (a logged step waits
    # anyway, reading its metrics).  Untraced, steps queue on the card.
    sync = active_tracer() is not None and dev.type == "cuda"
    with stopwatch("train/steps") as sw_wall:
        for step in range(start_step, job.steps):
            batch_np = stream.batch_at(step)
            logged = step % job.log_every == 0 or step == job.steps - 1
            with span("train/step", step=step):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch_np.items()}
                state, metrics = step_fn(state, batch)
                if logged:
                    # sorted, as the reference's jitted step returns them
                    m = {k: float(v) for k, v in sorted(metrics.items())}
                elif sync:
                    torch.cuda.synchronize(dev)
            if logged:
                m["step"] = step
                if job.tda_every and step % job.tda_every == 0:
                    model = state.params if mesh is None \
                        else gathered_model(cfg, state)
                    m.update(tda_monitor(model, cfg, batch_np))
                    del model
                history.append(m)
                print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                                  for k, v in m.items()}))
            if ckpt is not None and step and step % job.ckpt_every == 0:
                ckpt.save_async(step, train_state_to_arrays(state),
                                metadata={"step": step})
                saved = step
        if ckpt is not None:
            # the reference saves the last step again here; where the loop
            # has just saved it, the files would be the same bytes
            if saved != job.steps - 1:
                ckpt.save(job.steps - 1, train_state_to_arrays(state),
                          metadata={"step": job.steps - 1})
            ckpt.wait()
    wall = sw_wall.elapsed
    return {"history": history, "state": state, "wall_s": wall,
            "final_loss": history[-1]["loss"] if history else float("nan")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--tda-every", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=64,
                    help="reduced config width")
    ap.add_argument("--layers", type=int, default=2,
                    help="reduced config depth")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model,
                          n_heads=max(4, args.d_model // 32),
                          d_ff=args.d_model * 4)
    job = TrainJob(cfg=cfg, steps=args.steps, global_batch=args.batch,
                   seq_len=args.seq, n_micro=args.n_micro, lr=args.lr,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   tda_every=args.tda_every, device=args.device)
    out = run(job, restore=args.restore)
    print(f"done: {args.steps} steps in {out['wall_s']:.1f}s, "
          f"final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
