"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Port of ``src/repro/configs/gemma3_1b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab_size=262144, head_dim=256,
    rope_theta=1e6, attn_window=1024, global_every=6,
    tie_embeddings=True,
    # 5/6 of layers are 1k-windowed; decode cost is O(seq) only on the few
    # global layers with seq-sharded KV -> eligible for long_500k.
    sub_quadratic=True,
)
