"""granite-34b [dense]: 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch code model.  [arXiv:2405.04324; hf]

Port of ``src/repro/configs/granite_34b.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, rope_theta=1e4, tie_embeddings=False,
    act="gelu",
    sub_quadratic=False,
)
