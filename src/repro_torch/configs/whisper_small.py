"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H d_ff=3072
vocab=51865 (padded to 52224 for TP divisibility) — enc-dec; conv frontend
STUB (input_specs feeds precomputed frame embeddings, S_enc = seq_len//2,
S_dec = seq_len//2 per DESIGN.md).  [arXiv:2212.04356; unverified]

Port of ``src/repro/configs/whisper_small.py``."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, enc_dec=True, rope_kind="none",
    act="gelu", tie_embeddings=True,
    sub_quadratic=False,
)
