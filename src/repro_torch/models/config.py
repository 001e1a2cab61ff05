"""Model configuration covering the ten assigned architectures.

Port of ``src/repro/models/config.py``: the same dataclasses, field for
field, so every config module can import them; ``pdtype`` and ``cdtype``
return torch dtypes.  ``reduced()`` derives the CPU-smoke-test variant
(same family and block pattern, tiny widths) exactly as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # always-on shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    first_dense_layers: int = 0   # leading dense-FFN layers (deepseek: 1)
    dense_d_ff: int = 0           # d_ff of those dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # 1 sLSTM per this many blocks (rest mLSTM)
    proj_factor: float = 2.0      # up-projection factor for mLSTM
    conv_width: int = 4
    chunk: int = 64               # chunkwise-parallel chunk length


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0                # recurrence width (0 -> d_model)
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")
    attn_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "silu"
    norm_eps: float = 1e-6
    qk_norm: bool = False
    rope_kind: str = "rope"       # rope | mrope | none
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_window: int = -1         # -1 = global
    global_every: int = 0         # gemma3: every k-th layer is global
    tie_embeddings: bool = True
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    enc_dec: bool = False         # whisper
    n_enc_layers: int = 0
    input_kind: str = "tokens"    # tokens | embeddings (vlm/audio stubs)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256  # TP divisibility padding (production std)
    sub_quadratic: bool = False   # eligible for long_500k (per task spec)
    z_loss: float = 1e-4
    remat: str = "none"           # none | full | dots  (activation ckpt)
    scan_seq_axis: bool = False   # sequence-parallel activation constraint

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def window_for_layer(self, i: int) -> int:
        if self.global_every and (i % self.global_every == self.global_every - 1):
            return -1
        return self.attn_window

    def reduced(self, n_layers: int = 2, d_model: int = 64, n_heads: int = 4,
                n_kv_heads: Optional[int] = None, d_ff: int = 128,
                vocab: int = 512) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kv = n_kv_heads if n_kv_heads is not None else max(
            1, n_heads * self.n_kv_heads // self.n_heads)
        changes = dict(
            name=self.name + "-reduced",
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=kv, d_ff=d_ff if self.d_ff else 0,
            vocab_size=vocab, head_dim=d_model // n_heads,
            vocab_pad_multiple=64, compute_dtype="float32",
        )
        if self.rope_kind == "mrope":
            # keep the 2:3:3 section ratio at the reduced head_dim
            half = (d_model // n_heads) // 2
            s1 = half // 4
            s2 = (half - s1) // 2
            changes["mrope_sections"] = (s1, s2, half - s1 - s2)
        if self.moe:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=32,
                n_shared=min(self.moe.n_shared, 1),
                dense_d_ff=64 if self.moe.first_dense_layers else 0)
        if self.mla:
            changes["mla"] = MLAConfig(kv_lora_rank=32, rope_head_dim=8,
                                       nope_head_dim=16, v_head_dim=16)
        if self.xlstm:
            changes["xlstm"] = dataclasses.replace(
                self.xlstm, slstm_every=2, chunk=8)
            changes["n_layers"] = 4
        if self.rglru:
            changes["rglru"] = dataclasses.replace(
                self.rglru, d_rnn=d_model, attn_window=16)
            changes["n_layers"] = 3
        if self.enc_dec:
            changes["n_enc_layers"] = 2
        if self.global_every:
            changes["attn_window"] = 8
            changes["global_every"] = 2
        return dataclasses.replace(self, **changes)
