"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8)
d_ff(expert)=512 vocab=49155 (padded to 49408) — 32 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Port of ``src/repro/configs/granite_moe_1b_a400m.py``."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155, rope_theta=1e4, tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512, n_shared=0,
                  capacity_factor=1.25),
    sub_quadratic=False,
)
