"""The seed-0 draw order of the port's ``init_params`` on the CPU: the
SHA-256 of every reduced model's weights (each parameter's name, then its
float32 bytes, in ``named_parameters`` order) as it was before the
encoder-decoder and M-RoPE families were added.  Init code for a new
family must not move an existing model's draws: ``chip_smoke.py``'s seams
run at seed 0, and a granite-moe seam once failed under another draw of
the same seed."""
import hashlib

import pytest

from repro_torch.configs import get_config
from repro_torch.models.transformer import init_params

SEED0_SHA256 = {
    "deepseek_v2_lite_16b":
        "20e7983e60ab5e043d5a4b529e239c0a242f49a417b5ceae52ce551b130fe3c5",
    "gemma3_1b":
        "8c5bb115fe4d7f7636920dd31f98661249d726da3a449bb1e253ce134aac6c6d",
    "glm4_9b":
        "d06b48f72a821f984be6a5a58a093e484ac14d899ef1fe7945699d1bd8f2b989",
    "granite_34b":
        "92e8b7ff3b0912237f7032d07c1086d76250d6e3d3d84296a89d473b696ff5a2",
    "granite_moe_1b_a400m":
        "230311512d8f0932bfa7b6b0705346209d86d3a2e72b79a5cbcb1a1146ad9262",
    "qwen3_0_6b":
        "4ab659952956fa70a80c7e11fa0254a8d84e34adfab96c7f8eee24c6459d8712",
    "recurrentgemma_9b":
        "c0ba1ec5166a569d2d071d35509702d3aa16575e5123d1b8637a782854895ca6",
    "xlstm_1_3b":
        "c608c53613e055f438e5dd13ed66ffea2ae965b3d5b5a244a8e50bfc0eae5cfb",
}


@pytest.mark.parametrize("arch", sorted(SEED0_SHA256))
def test_seed0_weights_are_unchanged(arch):
    model = init_params(get_config(arch, reduced=True), 0, "cpu")
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().contiguous().numpy().tobytes())
    assert h.hexdigest() == SEED0_SHA256[arch]
