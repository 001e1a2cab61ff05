"""recurrentgemma-9b [hybrid]: 38 blocks d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — Griffin pattern (RG-LRU, RG-LRU, local-attn
window 2048) x12 + 2 RG-LRU remainder.  [arXiv:2402.19427; unverified]

Port of ``src/repro/configs/recurrentgemma_9b.py``."""
from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, rope_theta=1e4, tie_embeddings=True,
    act="gelu",
    rglru=RGLRUConfig(d_rnn=4096, conv_width=4,
                      block_pattern=("rglru", "rglru", "local_attn"),
                      attn_window=2048),
    sub_quadratic=True,
)
