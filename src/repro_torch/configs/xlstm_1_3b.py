"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H — sLSTM + mLSTM blocks
(1 sLSTM per 8), matrix-memory mLSTM with chunkwise-parallel form; no
separate FFN (d_ff=0, gated up-projection inside blocks).
[arXiv:2405.04517; unverified]

Port of ``src/repro/configs/xlstm_1_3b.py``."""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, rope_kind="none", tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, conv_width=4,
                      chunk=64),
    sub_quadratic=True,   # O(1)/token recurrent state
)
