"""The port's multi-head latent attention (``mla_params``/``mla_apply``)
on the CPU against the JAX package, with reduced deepseek-v2-lite-16b's
weights carried across: prefill through the flash route (the kernel's
plain version, values zero-padded to q's width) and through
``_sdpa_masked``, the absorbed decode against the latent cache, and the
padded flash route itself against ``_sdpa_masked``.

Inputs are numpy arrays from seeds, handed to both packages.  Tolerances:
float32 ``2e-4`` as ``tests/test_torch_attention.py`` holds
``attention_apply`` (sums in another order); the padded route against
``_sdpa_masked`` ``1e-5`` (the same function in float32).  The
reference's bfloat16 decode does not run on this CPU (XLA's CPU dot has
no bfloat16 x bfloat16 = float32 form), so the rounding order in
bfloat16 is held on the card (``chip_smoke.py``'s prefill seam) and not
here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

F32 = dict(rtol=2e-4, atol=2e-4)
ARCH = "deepseek-v2-lite-16b"


def _layer(seed=0, compute_dtype="float32"):
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True),
                               compute_dtype=compute_dtype)
    jp = jattn.mla_params(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v["scale"] if isinstance(v, dict)
                                       else v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


class _Spy:
    """Records the (q, v) head dims and windows ``ops.attention`` gets."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = ops.attention

        def spy(q, k, v, causal=True, window=-1):
            self.calls.append((q.shape[-1], v.shape[-1], window))
            return real(q, k, v, causal=causal, window=window)

        monkeypatch.setattr(ops, "attention", spy)


def test_mla_params_layout_matches_jax():
    jcfg, tcfg, jp, _ = _layer()
    gen = torch.Generator().manual_seed(0)
    tp = tattn.mla_params(tcfg, gen, "cpu")
    assert list(tp) == list(jp)
    for k, v in jp.items():
        want = v["scale"] if isinstance(v, dict) else v
        assert tuple(tp[k].shape) == want.shape, k
        assert tp[k].dtype == getattr(torch, str(want.dtype)), k
    assert torch.equal(tp["kv_norm"], torch.ones_like(tp["kv_norm"]))


@pytest.mark.parametrize("window", [-1, 5])
def test_mla_prefill_matches_jax(window, monkeypatch):
    jcfg, tcfg, jp, tp = _layer()
    m = jcfg.mla
    rng = np.random.default_rng(21)
    b, s = 2, 12
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, (wc, wr) = jattn.mla_apply(jp, jcfg, jnp.asarray(x),
                                     jnp.asarray(pos), window)
    spy = _Spy(monkeypatch)
    got, (gc, gr) = tattn.mla_apply(tp, tcfg, torch.from_numpy(x), None,
                                    window)
    # the flash route, the values padded to q's width
    qk = m.nope_head_dim + m.rope_head_dim
    assert spy.calls == [(qk, qk, window)]
    assert gc.shape == (b, s, m.kv_lora_rank)
    assert gr.shape == (b, s, m.rope_head_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **F32)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **F32)
    alt, _ = tattn.mla_apply(tp, tcfg, torch.from_numpy(x),
                             torch.from_numpy(pos.copy()), window)
    assert len(spy.calls) == 1              # explicit positions: no kernel
    np.testing.assert_allclose(alt.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("pos", [0, 6])
def test_mla_absorbed_decode_matches_jax(window, pos, monkeypatch):
    jcfg, tcfg, jp, tp = _layer(seed=1)
    m = jcfg.mla
    rng = np.random.default_rng(22)
    b, s_max = 2, 10
    cc = rng.normal(size=(b, s_max, m.kv_lora_rank)).astype(np.float32)
    cr = rng.normal(size=(b, s_max, m.rope_head_dim)).astype(np.float32)
    cc[:, pos:] = 0
    cr[:, pos:] = 0
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    positions = np.full((b, 1), pos, dtype=np.int32)
    want, (wc, wr) = jattn.mla_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(positions), window,
        cache=(jnp.asarray(cc), jnp.asarray(cr)), cache_pos=jnp.int32(pos))
    spy = _Spy(monkeypatch)
    tc, tr = torch.from_numpy(cc.copy()), torch.from_numpy(cr.copy())
    got, (gc, gr) = tattn.mla_apply(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(positions), window,
        cache=(tc, tr), cache_pos=pos)
    assert spy.calls == []                  # decode never takes the kernel
    assert gc is tc and gr is tr            # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **F32)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), **F32)


def test_mla_decode_continues_its_prefill():
    """Prefill of S - 1 tokens then one absorbed decode step gives the
    full prefill's last output (the latent cache path against the
    up-projected one, within the port)."""
    _, tcfg, _, tp = _layer(seed=3)
    m = tcfg.mla
    rng = np.random.default_rng(24)
    b, s = 2, 9
    x = torch.from_numpy(rng.normal(size=(b, s, tcfg.d_model))
                         .astype(np.float32))
    full, _ = tattn.mla_apply(tp, tcfg, x, None, -1)
    _, (c, r) = tattn.mla_apply(tp, tcfg, x[:, :s - 1], None, -1)
    cache = (torch.zeros((b, s + 2, m.kv_lora_rank)),
             torch.zeros((b, s + 2, m.rope_head_dim)))
    cache[0][:, :s - 1] = c
    cache[1][:, :s - 1] = r
    pos = torch.full((b, 1), s - 1)
    last, _ = tattn.mla_apply(tp, tcfg, x[:, s - 1:], pos, -1, cache=cache,
                              cache_pos=s - 1)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               **F32)


@pytest.mark.parametrize("window", [-1, 4])
def test_padded_flash_route_matches_sdpa_masked(window):
    """``_flash_prefill`` with values narrower than q and k (the kernel's
    CPU plain version on zero-padded values, the output sliced back)
    against ``_sdpa_masked`` on the unpadded values, within 1e-5."""
    rng = np.random.default_rng(25)
    b, s, h, dq, dv = 2, 11, 4, 24, 16
    q, k = (torch.from_numpy(rng.normal(size=(b, s, h, dq))
                             .astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(b, s, h, dv)).astype(np.float32))
    got = tattn._flash_prefill(q, k, v, window, True)
    pos = torch.arange(s).expand(b, s)
    want = tattn._sdpa_masked(q, k, v, pos, pos, window, causal=True)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_route_refuses_values_wider_than_q():
    q = torch.zeros((1, 4, 2, 16))
    v = torch.zeros((1, 4, 2, 24))
    with pytest.raises(ValueError, match="wider than q"):
        tattn._flash_prefill(q, q, v, -1, True)
