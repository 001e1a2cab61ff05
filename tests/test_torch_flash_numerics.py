"""The bfloat16 flash kernel's arithmetic, emulated on the CPU.

``csrc/flash_attention_sm90.cu`` runs only on the card.  Its arithmetic is
emulated here tile by tile: bfloat16 inputs, float32 scores scaled by
``log2(e) / sqrt(d)`` after the product, float32 running max and sum in
the exp2 domain, the probabilities of each KV tile rounded to bfloat16
before P.V with a float32 accumulator, and one rounding of the output.
The emulation is held against the JAX package's ``flash_attention``
(Pallas, interpret mode, as ``tests/test_torch_attention.py`` runs it) and
against ``flash_attention_plain``, within ``1e-2``: the gate the kernel is
held to on the card.  It shows, before any card run, that rounding P to
bfloat16 keeps that gate.  Nothing in ``repro_torch`` imports this.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention_plain

GATE = dict(rtol=1e-2, atol=1e-2)
NEG_INF = -1e30


def emulate_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int, bk: int = 128,
                 round_p: bool = True) -> torch.Tensor:
    """The kernel's arithmetic on bfloat16 (BH, S, d) tensors, KV tile by
    KV tile (``bk`` keys, as at d <= 128), output in q's dtype.
    ``round_p=False`` keeps P in float32 (not the kernel: a check of the
    recurrence itself)."""
    bh, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = math.log2(math.e) / math.sqrt(d)
    qi = torch.arange(s)[:, None]
    m = torch.full((bh, s), NEG_INF)
    l = torch.zeros((bh, s))
    acc = torch.zeros((bh, s, d))
    for k0 in range(0, s, bk):
        kj = torch.arange(k0, min(s, k0 + bk))[None, :]
        sc = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + bk]) * scale
        ok = torch.ones(sc.shape[1:], dtype=torch.bool)
        if causal:
            ok &= kj <= qi
        if window > 0:
            ok &= (qi - kj) < window
        sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if round_p:
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p, vf[:, k0:k0 + bk])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _inputs(seed, bh, s, d):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(bh, s, d)),
                            dtype=torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("bh,s,d,causal,window", [
    (2, 128, 64, True, -1), (1, 256, 128, True, -1), (3, 77, 64, False, -1),
    (2, 300, 128, True, 64), (4, 200, 64, False, 1), (1, 300, 64, False, 48),
    (2, 129, 128, True, 1)])
def test_emulation_matches_pallas_and_plain(bh, s, d, causal, window):
    q, k, v = _inputs(bh * 1000 + s, bh, s, d)
    got = emulate_sm90(q, k, v, causal, window).float().numpy()
    pallas = jax_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                         for t in (q, k, v)),
                       causal=causal, window=window, block_q=64,
                       block_k=64, interpret=True)
    plain = flash_attention_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32), **GATE)
    np.testing.assert_allclose(got, plain.float().numpy(), **GATE)


@pytest.mark.parametrize("causal,window,bk", [(True, -1, 128),
                                              (True, 1024, 64)])
def test_emulation_keeps_the_gate_at_serving_length(causal, window, bk):
    """At S = 2048 (the serving prefill's length; bk = 64 as at d = 256)
    against the plain version, with the rounding of P visible: the two
    differ, and by less than the gate."""
    q, k, v = _inputs(13, 2, 2048, 128)
    got = emulate_sm90(q, k, v, causal, window, bk).float()
    plain = flash_attention_plain(q, k, v, causal=causal, window=window)
    err = float((got - plain.float()).abs().max())
    assert 0.0 < err
    torch.testing.assert_close(got, plain.float(), **GATE)


@pytest.mark.parametrize("causal,window", [(True, -1), (False, 24)])
def test_emulation_without_rounding_is_the_plain_version(causal, window):
    """With P kept in float32 the tile-wise exp2 recurrence is the plain
    softmax up to float32 order (float32 in and out), so rounding P is the
    emulation's only approximation."""
    q, k, v = (t.float() for t in _inputs(21, 2, 200, 64))
    got = emulate_sm90(q, k, v, causal, window, bk=64, round_p=False)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
