"""Blocked pairwise squared Euclidean distances: CUDA kernel + plain version.

Port of ``src/repro/kernels/pairwise_dist.py``.  The Pallas TPU kernel
``_pairwise_kernel`` becomes ``csrc/pairwise_dist.cu`` (hand-written for
sm_90a: 64 x 64 output tiles, float32 FMAs on the CUDA cores, ragged edges
masked in the kernel, no padding copy); :func:`pairwise_sq_dists_plain` is
the same function in plain PyTorch (``xx + yy - 2 x @ y.T``, clamped, as
``src/repro/kernels/ref.py`` computes it).

:func:`pairwise_sq_dists` runs the kernel for CUDA tensors and the plain
version for CPU tensors, and nothing else: a CUDA tensor it cannot take
raises.  ``pairwise_sq_dists.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_D = 64

_SIGNATURES = {
    "pairwise_sq_dists": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p),
}


def pairwise_sq_dists_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``max(|x|^2 + |y|^2 - 2 x.y, 0)`` in float32 with a matrix product.

    On a card, call it with ``torch.backends.cuda.matmul.allow_tf32 =
    False`` (PyTorch's default): a TF32 product carries about three
    decimal digits, far outside the harvest's candidate margin.
    """
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = torch.sum(x * x, dim=-1)[:, None]
    yy = torch.sum(y * y, dim=-1)[None, :]
    return torch.clamp_min(xx + yy - 2.0 * (x @ y.T), 0.0)


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances (M, N) between the rows of x (M, d) and y (N, d).

    float32, contiguous, ``d <= 64``, both on one device.  CUDA tensors go
    through the kernel (raising on what it does not take); CPU tensors
    through :func:`pairwise_sq_dists_plain`.
    """
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"expected x (M, d) and y (N, d), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    if x.device.type == "cpu":
        return pairwise_sq_dists_plain(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    m, d = x.shape
    n = y.shape[0]
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds the kernel's limit of {MAX_D}")
    if m > 65535 * 64:
        raise ValueError(f"M={m} exceeds the kernel grid's row limit")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m and n:
        lib = _build.library("pairwise_dist", _SIGNATURES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pairwise_sq_dists(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), m, n, d, stream)
        pairwise_sq_dists.launches += 1
        _build.check_launch(err, "pairwise_sq_dists")
    return out


pairwise_sq_dists.launches = 0
