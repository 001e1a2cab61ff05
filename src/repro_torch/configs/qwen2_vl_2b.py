"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution; vision frontend is a STUB
(input_specs feeds precomputed patch embeddings + (3,B,S) position grids).
[arXiv:2409.12191; hf]

Port of ``src/repro/configs/qwen2_vl_2b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, rope_kind="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6, tie_embeddings=True, input_kind="embeddings",
    sub_quadratic=False,
)
