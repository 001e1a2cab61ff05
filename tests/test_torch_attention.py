"""The port's attention on the CPU against the JAX package: the flash
kernel's plain version and ``ops.attention`` against ``flash_attention``
(Pallas, interpret mode) and ``attention_ref``; the layers; and
``attention_apply`` (prefill and decode) with weights carried across, for
reduced qwen3-0.6b and gemma3-1b.

Inputs are numpy arrays from seeds, handed to both packages.  Tolerances:
attention ``2e-4`` in float32 and ``3e-2`` in bfloat16 (as
``tests/test_kernels.py`` holds the Pallas kernel; the hypothesis sweep
``3e-4`` as there); layers ``1e-6`` (float32, the same operations);
``attention_apply`` ``2e-4`` (float32 sums in another order, and the
flash route's scores scaled after the product where ``_sdpa`` scales
before the softmax).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as kref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

F32 = dict(rtol=2e-4, atol=2e-4)


def _qkv(rng, shape, dtype=np.float32):
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


def _port_all(q, k, v, causal, window, dtype=torch.float32):
    """flash_attention_plain, flash_attention and ops.attention on CPU
    tensors: all three must agree exactly (one plain version)."""
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    outs = [flash_attention_plain(tq, tk, tv, causal=causal, window=window),
            flash_attention(tq, tk, tv, causal=causal, window=window),
            ops.attention(tq, tk, tv, causal=causal, window=window)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0].float().numpy()


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d,bq,bk", [(128, 64, 64, 64), (256, 32, 128, 128)])
def test_attention_matches_pallas_and_ref(causal, s, d, bq, bk):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, (2, s, d))
    got = _port_all(q, k, v, causal, -1)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, block_q=bq, block_k=bk, interpret=True)
    ref = kref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(ref), **F32)


@pytest.mark.parametrize("s,window,causal", [(256, 64, True), (77, 16, True),
                                             (77, -1, True), (77, -1, False),
                                             (130, 24, False)])
def test_attention_window_and_ragged(s, window, causal):
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, (1, s, 32))
    got = _port_all(q, k, v, causal, window)
    pallas = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, block_q=64, block_k=64,
                       interpret=True)
    ref = kref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **F32)
    np.testing.assert_allclose(got, np.asarray(ref), **F32)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_attention_dtypes(dtype, tol):
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, (1, 128, 64))
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    # both packages see the same (rounded) inputs
    q, k, v = (np.array(a.astype(jnp.float32)) for a in (jq, jk, jv))
    got = _port_all(q, k, v, True, -1, getattr(torch, dtype))
    pallas = jax_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
    assert pallas.dtype == jq.dtype
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got, np.asarray(kref.attention_ref(jq, jk, jv), np.float32),
        rtol=tol, atol=tol)


def test_attention_output_dtype_follows_q():
    q = torch.zeros((1, 8, 16), dtype=torch.bfloat16)
    assert flash_attention(q, q, q).dtype == torch.bfloat16


def test_attention_rejects_mismatched_inputs():
    q = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 9, 16)), q)
    with pytest.raises(TypeError):
        flash_attention(q, q, q.double())


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 3), st.sampled_from([16, 64, 77, 130]),
       st.sampled_from([8, 32, 64]), st.booleans(),
       st.sampled_from([-1, 1, 5, 64]), st.integers(0, 2**31 - 1))
def test_attention_hypothesis_sweep(b, s, d, causal, window, seed):
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, (b, s, d))
    got = _port_all(q, k, v, causal, window)
    ref = kref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

LAYER = dict(rtol=1e-6, atol=1e-6)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-6)
    got = tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, size=(2, 9)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    small = pos % 8
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(small), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(small),
                             theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(12)
    p = {k: rng.normal(size=shape).astype(np.float32) / 8 for k, shape in
         (("w_up", (32, 48)), ("w_down", (48, 32)), ("w_gate", (32, 48)))}
    if act == "gelu":
        del p["w_gate"]
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act, jnp.float32)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tlayers.mlp(torch.from_numpy(x), t["w_up"], t["w_down"],
                      t.get("w_gate"), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_unembed_matches_jax():
    rng = np.random.default_rng(13)
    table = rng.normal(size=(128, 32)).astype(np.float32)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    want = jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x),
                           jnp.float32)
    got = tlayers.unembed(torch.from_numpy(table), torch.from_numpy(x),
                          torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


# ---------------------------------------------------------------------------
# attention_apply with carried weights
# ---------------------------------------------------------------------------

ARCHS = ["qwen3-0.6b", "gemma3-1b"]


def _layer(arch, seed=0):
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    jp = jattn.attn_params(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.array(v["scale"] if isinstance(v, dict)
                                       else v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


class _Spy:
    """Records the windows ``ops.attention`` is called with."""

    def __init__(self, monkeypatch):
        self.windows = []
        real = ops.attention

        def spy(q, k, v, causal=True, window=-1):
            self.windows.append(window)
            return real(q, k, v, causal=causal, window=window)

        monkeypatch.setattr(ops, "attention", spy)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [-1, 3, 8])
def test_attention_apply_prefill_matches_jax(arch, window, monkeypatch):
    jcfg, tcfg, jp, tp = _layer(arch)
    rng = np.random.default_rng(14)
    b, s = 2, 12
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, (wk, wv) = jattn.attention_apply(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(pos), window)
    spy = _Spy(monkeypatch)
    tpos = torch.from_numpy(pos.copy())
    got, (gk, gv) = tattn.attention_apply(tp, tcfg, torch.from_numpy(x),
                                          None, window)
    assert spy.windows == [window]          # the flash-kernel route
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **F32)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **F32)
    # explicit positions, even arange ones, take _sdpa_masked: same values
    alt, _ = tattn.attention_apply(tp, tcfg, torch.from_numpy(x), tpos,
                                   window)
    np.testing.assert_allclose(alt.numpy(), np.asarray(want), **F32)
    assert spy.windows == [window]


def test_window_zero_is_self_only_and_not_routed(monkeypatch):
    """window == 0 means "self only" in the model but "global" in the
    kernel, so prefill must not route it to the kernel."""
    jcfg, tcfg, jp, tp = _layer("qwen3-0.6b")
    rng = np.random.default_rng(15)
    x = rng.normal(size=(1, 6, jcfg.d_model)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)[None]
    want, _ = jattn.attention_apply(jp, jcfg, jnp.asarray(x),
                                    jnp.asarray(pos), 0)
    spy = _Spy(monkeypatch)
    got, _ = tattn.attention_apply(tp, tcfg, torch.from_numpy(x), None, 0)
    assert spy.windows == []
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [-1, 3])
def test_attention_apply_decode_matches_jax(arch, window, monkeypatch):
    jcfg, tcfg, jp, tp = _layer(arch, seed=1)
    rng = np.random.default_rng(16)
    b, s_max, pos = 2, 10, 6
    shape = (b, s_max, jcfg.n_kv_heads, jcfg.head_dim_)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    ck[:, pos:] = 0
    cv[:, pos:] = 0
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32)
    positions = np.full((b, 1), pos, dtype=np.int32)
    want, (wk, wv) = jattn.attention_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(positions), window,
        cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_pos=jnp.int32(pos))
    spy = _Spy(monkeypatch)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = tattn.attention_apply(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(positions), window,
        cache=(tk, tv), cache_pos=pos)
    assert spy.windows == []                # decode never takes the kernel
    assert gk is tk and gv is tv            # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **F32)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), **F32)


@pytest.mark.parametrize("window", [-1, 0, 4])
def test_mask_bias_matches_jax(window):
    q_pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0)
    k_pos = np.arange(9, dtype=np.int32)
    want = jattn._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), window)
    got = tattn._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                           window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sq", [1, 2048, 4096, 16384])
def test_q_chunk_matches_jax(sq):
    assert tattn._q_chunk(sq) == jattn._q_chunk(sq)


def test_sdpa_masked_chunked_matches_jax():
    """Above 2048 queries both packages chunk the queries (1024 rows)."""
    rng = np.random.default_rng(17)
    b, s, h, kv, d = 1, 4096, 2, 1, 8
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    want = jattn._sdpa_masked(*(jnp.asarray(a) for a in (q, k, v, pos, pos)),
                              64)
    got = tattn._sdpa_masked(*(torch.from_numpy(a) for a in (q, k, v, pos,
                                                             pos)), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
