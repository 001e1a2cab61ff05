"""Blocked (flash) attention: CUDA kernels + plain version.

Port of ``src/repro/kernels/flash_attention.py``.  The Pallas TPU kernel
``_flash_kernel`` becomes two hand-written kernels for sm_90a, picked by
dtype:

- bfloat16: ``csrc/flash_attention_sm90.cu``, on the tensor cores.  One
  block per (bh, 128-query tile): a producer warpgroup feeds Q once and
  K/V tiles through a two-stage ring with TMA; two consumer warpgroups run
  S = Q.K^T and O += P.V as ``wgmma``, with the masks and the online
  softmax in float32 registers.  P is rounded to bfloat16 for P.V, as the
  reference model's ``_sdpa`` rounds its probabilities; the output is
  rounded once.  q, k and v must be 16-byte aligned (TMA).
- float32: ``csrc/flash_attention.cu``, IEEE float32 FMAs on the CUDA
  cores (TF32, 3xTF32 included, is not allowed on this route), built like
  a tuned SGEMM.  One block of 256 threads per (bh, 128-query tile) (64 at
  d > 128); at 64 < d <= 128 each thread keeps an 8 x 4 block of the
  scores and an 8 x 8 block of the output in registers, reads its operands
  from XOR-swizzled shared tiles as float4, and K/V tiles of 64 keys (32
  at d > 128) arrive through a two-stage ``cp.async`` ring, the next tile
  in flight while this one's products run.

Both routes load q, k and v asynchronously (TMA, ``cp.async``), so they
must be 16-byte aligned.

Both skip KV tiles wholly above the diagonal or before the window and mask
a ragged S in the kernel, with no padding copy.  :func:`flash_attention_plain`
is the same function in plain PyTorch, as ``src/repro/kernels/ref.py``
``attention_ref`` computes it: float32 scores, masked to -1e30, softmax in
float32, output in q's dtype.

:func:`flash_attention` runs a kernel for CUDA tensors and the plain
version for CPU tensors, and nothing else: a CUDA tensor it cannot take
raises.  ``flash_attention.launches`` counts kernel launches.  The launch
is the custom operator ``torch.ops.repro_torch.flash_attention``, so a
trace on fake CUDA tensors (``launch/dryrun.py``) passes through it: its
fake implementation gives the output's shape without touching memory,
and its FLOP formula, which ``torch.utils.flop_counter`` reads, counts
4 · d FLOPs a (query, key) pair the masks leave (:func:`attended_pairs`).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

NEG_INF = -1e30
MAX_D = 256

# (q, k, v, o, BH, S, d, causal, window, sm_scale, stream) -> cudaError_t
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)
# dtype -> (source in csrc/, exported function)
_ROUTES = {torch.bfloat16: ("flash_attention_sm90", "flash_attention_bf16"),
           torch.float32: ("flash_attention", "flash_attention_f32")}
ALIGN = 16


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = -1) -> torch.Tensor:
    """Naive softmax attention over (BH, S, d): float32 scores scaled by
    ``1/sqrt(d)``, keys masked to -1e30 (``causal``: j > i; ``window > 0``:
    i - j >= window), output in q's dtype.

    On a card, call it with ``torch.backends.cuda.matmul.allow_tf32 =
    False`` (PyTorch's default) to keep its products in float32.
    """
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    sq, sk = q.shape[1], k.shape[1]
    q_idx = torch.arange(sq, device=q.device)[:, None]
    k_idx = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if window > 0:
        mask &= (q_idx - k_idx) < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = -1) -> torch.Tensor:
    """Attention over q, k, v (BH, S, d) with GQA pre-expanded.

    ``window > 0`` masks keys at distance ``window`` or more; ``window <=
    0`` is global (the TPU kernel's convention).  CUDA tensors go through
    a kernel by dtype (bfloat16: the tensor-core kernel; float32: the SIMT
    kernel): contiguous, one shape, ``d <= 256`` and a multiple of 8, and
    16-byte aligned; anything else raises.  CPU tensors go through
    :func:`flash_attention_plain`.
    """
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v of one (BH, S, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _ROUTES:
        raise TypeError(f"expected float32 or bfloat16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    bh, s, d = q.shape
    if d > MAX_D or d % 8 != 0:
        raise ValueError(f"d={d}: the kernel takes d <= {MAX_D}, a multiple "
                         "of 8")
    if bh > 65535:
        raise ValueError(f"BH={bh} exceeds the kernel grid's limit of 65535")
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                 int(window))


flash_attention.launches = 0


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool,
                          window: int) -> torch.Tensor:
    """The kernel launch behind :func:`flash_attention` (checked there)."""
    if any(t.data_ptr() % ALIGN for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned: the kernels "
                         "load them with TMA (bfloat16) or cp.async "
                         "(float32)")
    out = torch.empty_like(q)
    bh, s, d = q.shape
    if bh and s:
        source, fn = _ROUTES[q.dtype]
        lib = _build.library(source, {fn: _ARGTYPES})
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s,
            d, int(causal), int(window), 1.0 / math.sqrt(d), stream)
        flash_attention.launches += 1
        _build.check_launch(err, "flash_attention")
    return out


@_flash_attention_cuda.register_fake
def _flash_attention_fake(q, k, v, causal, window):
    return torch.empty_like(q)


def attended_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, over S queries and S keys."""
    i = np.arange(s)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int((hi - lo + 1).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 out_shape=None, **kwargs) -> int:
    """Q.K^T and P.V: 2 · d FLOPs each a pair attended, BH times."""
    bh, s, d = q_shape
    return 4 * d * bh * attended_pairs(s, causal, window)
