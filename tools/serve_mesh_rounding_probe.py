"""Card probe: how far a prefill's bf16 logits move with the rows a GEMM
sees, beside how far the meshed prefill's move from the unmeshed one.

    python3 tools/serve_mesh_rounding_probe.py [arch ...]

For each arch (default xlstm-1.3b and qwen2-vl-2b) at published width,
cut in depth as ``chip_smoke.MESH_FAMILIES`` cuts it, on 8 rows of
``chip_smoke.SERVE_MESH_FAMILY_PROMPT``'s prompt (inputs as
``chip_smoke.family_prompts`` draws them): the unmeshed prefill on all 8
rows, the unmeshed prefill on each data entry's 2 rows (one call each,
as the meshed prefill runs a data entry's rows), and the meshed prefill
on (data 4, model 2) entries of the card; in bf16 and in float32 compute
(TF32 off).  One JSON line an arch and dtype: the largest |logits| and
the largest difference of each pair, with the card's name and power
limit.  Needs a card; recurrentgemma-9b's 2,304-token prompt keeps three
float32 logits of 18.9 GB, so it runs only when named.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(batch: dict, lo: int, hi: int) -> dict:
    """Rows ``[lo, hi)`` of a prefill batch (``positions3`` on axis 1)."""
    return {k: v[:, lo:hi] if k == "positions3" else v[lo:hi]
            for k, v in batch.items()}


def probe(arch: str, dtype: str, smi: str, dev=None) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.steps import make_prefill_step

    dev = dev or torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    depth = {a: n for a, n, _ in cs.MESH_FAMILIES}
    cfg = dataclasses.replace(get_config(arch), n_layers=depth[arch],
                              compute_dtype=dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    prompt, n_rows = cs.SERVE_MESH_FAMILY_PROMPT[arch], cs.SERVE_MESH_ROWS
    model = init_params(cfg, seed=0, device=dev)
    batch, _ = cs.family_prompts(cfg, dev, n_rows, prompt)(model)
    per = n_rows // cs.SERVE_MESH_SHAPE[0]
    pre = make_prefill_step(cfg)
    with torch.no_grad():
        whole = pre(model, batch)[0]
        parts = torch.cat([pre(model, rows(batch, lo, lo + per))[0]
                           for lo in range(0, n_rows, per)])
    mesh = make_mesh(cs.SERVE_MESH_SHAPE, ("data", "model"),
                     devices=[dev] * n_rows)
    params = cs.serve_mesh_params(cfg, model, mesh)
    del model
    meshed = cs.serve_mesh_steps(cfg, mesh, n_rows)[0](params, batch)[0]
    lo_, hi_ = torch.aminmax(whole)
    out = dict(card=smi, arch=cfg.name, n_layers=cfg.n_layers,
               compute_dtype=dtype, rows=n_rows, prompt=prompt,
               max_abs_logits=max(-float(lo_), float(hi_)),
               unmeshed_8_rows_vs_2_rows=float((whole - parts).abs().max()),
               meshed_vs_unmeshed_8_rows=cs.sharded_max_diff(meshed, whole),
               meshed_vs_unmeshed_2_rows=cs.sharded_max_diff(meshed, parts))
    del whole, parts, meshed, params
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("serve_mesh_rounding_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    for arch in argv or ["xlstm-1.3b", "qwen2-vl-2b"]:
        for dtype in ("bfloat16", "float32"):
            print(json.dumps(probe(arch, dtype, smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
