"""Device resolution shared by the port's entry points.

Every entry point takes ``device=None`` and runs on the card by default.
Without a card that default raises instead of carrying on quietly on the
host: a CPU run is asked for explicitly (``device="cpu"``, as the tests
do), and then the kernel wrappers take their plain PyTorch versions.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a card);
    ``"cpu"`` / ``"cuda[:k]"`` pass through after a check."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cpu' or 'cuda'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "available")
    return dev


def to_host(x: Any) -> np.ndarray:
    """``x`` as a numpy array on the host: a tensor is copied, even one on
    the CPU (the trainer updates its tensors in place while a checkpoint's
    thread writes the copy); anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)
