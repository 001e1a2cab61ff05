"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400 — MLA kv_lora=512 (+64-dim shared rotary head), 1 leading
dense layer (d_ff 10944), 64 routed experts top-6 + 2 shared.
[arXiv:2405.04434; hf]

Port of ``src/repro/configs/deepseek_v2_lite_16b.py``."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=102400, rope_theta=1e4, tie_embeddings=False,
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  capacity_factor=1.25, first_dense_layers=1,
                  dense_d_ff=10944),
    sub_quadratic=False,
)
