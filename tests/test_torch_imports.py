"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro`` (not even its numpy-only
modules), checked on the source and by importing the port with ``jax``
blocked."""
import ast
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_ROOT, "src", "repro_torch")


def _sources():
    out = [os.path.join(_ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(_PORT):
        out.extend(os.path.join(dirpath, f) for f in files
                   if f.endswith(".py"))
    return sorted(out)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.core.packed_reduce, "
            "repro_torch.scale.tiles, repro_torch.kernels.gf2, "
            "repro_torch.kernels.pairwise_dist, repro_torch.data.pointclouds, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.ops, "
            "repro_torch.configs, repro_torch.models.transformer, "
            "repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.core.serial_parallel, repro_torch.core.ref, "
            "repro_torch.scale.sparse_input, repro_torch.dist.compression, "
            "repro_torch.resilience.faults, repro_torch.launch.mesh, "
            "repro_torch.dist.sharding, repro_torch.scale.shard, "
            "repro_torch.scale.budget, repro_torch.serve, "
            "repro_torch.core.resume, repro_torch.serve.ph, "
            "repro_torch.resilience, repro_torch.analyze, "
            "repro_torch.analyze.invariants, repro_torch.launch.elastic, "
            "repro_torch.core.device_engine, repro_torch.analyze.lint, "
            "repro_torch.analyze.collectives, "
            "repro_torch.analyze.__main__, repro_torch.data.tokens, "
            "repro_torch.data, repro_torch.train, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.checkpoint, repro_torch.checkpoint.checkpointer, "
            "repro_torch.launch.train, repro_torch.models.moe, "
            "repro_torch.configs.glm4_9b, repro_torch.configs.granite_34b, "
            "repro_torch.configs.granite_moe_1b_a400m, "
            "repro_torch.configs.deepseek_v2_lite_16b; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
