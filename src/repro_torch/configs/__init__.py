"""Architecture registry: one module per assigned architecture.

Port of ``src/repro/configs/__init__.py``.  ``get_config(name)`` returns
the full published config; ``get_config(name, reduced=True)`` the CPU
smoke-test variant.  Modules load from this package
(``repro_torch.configs.<name>``), never the reference's.  Only the archs
the port's model runs have a module here (the dense decoders, and the MoE
and MLA models); the others raise ``NotImplementedError`` (ROADMAP.md §1,
item 10: the rest of the LM substrate).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS = (
    "qwen3_0_6b", "gemma3_1b", "granite_34b", "glm4_9b", "qwen2_vl_2b",
    "whisper_small", "xlstm_1_3b", "deepseek_v2_lite_16b",
    "granite_moe_1b_a400m", "recurrentgemma_9b",
)

PORTED = ("qwen3_0_6b", "gemma3_1b", "glm4_9b", "granite_34b",
          "granite_moe_1b_a400m", "deepseek_v2_lite_16b")

ALIASES = {
    "qwen3-0.6b": "qwen3_0_6b", "gemma3-1b": "gemma3_1b",
    "granite-34b": "granite_34b", "glm4-9b": "glm4_9b",
    "qwen2-vl-2b": "qwen2_vl_2b", "whisper-small": "whisper_small",
    "xlstm-1.3b": "xlstm_1_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    arch = canonical(name)
    if arch in ARCHS and arch not in PORTED:
        raise NotImplementedError(
            f"{name}: not ported yet (ROADMAP.md §1, item 10, LM "
            f"substrate); the port has {', '.join(PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg: ModelConfig = mod.CONFIG
    return cfg.reduced() if reduced else cfg
