"""The port's encoder-decoder, reduced whisper-small, on the CPU against
the JAX package: the sinusoidal positions, cross-attention, the model's
forward, prefill/``extend_cache``/decode, decode against its own
teacher-forced forward, the attention routes, activation checkpointing, a
train step and checkpoints, with the reference's weights carried across
(``params_from_arrays``).

Inputs are numpy arrays from seeds, handed to both packages.  Tolerances:
the sinusoids 1e-6, at the reduced width (64) over 64 positions and at
the published one (768) over 8: XLA's float32 ``exp`` differs from
torch's by an ulp in some frequency lanes, so the angles drift apart with
the position (at d = 768, 1.8e-6 at position 18; at whisper's 1,500
frames about 1e-4);
cross-attention 1e-5; the model (float32 compute) 2e-4, as
``tests/test_torch_serve.py`` holds the dense ones; a train step's loss
and gradient norm 1e-5 relative, its weights 2e-4 (at a learning rate of
5e-5); checkpoints bit for bit.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve.steps import extend_cache as jax_extend_cache
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.dist.sharding import tree_flatten_with_path, tree_path_str
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.serve import steps as tsteps
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCH = "whisper-small"
TOL = dict(rtol=2e-4, atol=2e-4)
# jax.eval_shape of the reference's init_params at the published widths
FULL_PARAMS = 238_139_904


def _models(seed=0):
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, model


def _batch(cfg, b, s, s_enc, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "enc_embeds": rng.normal(size=(b, s_enc, cfg.d_model)).astype(
                np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _flat(tree):
    return [(tree_path_str(kp), np.asarray(leaf))
            for kp, leaf in tree_flatten_with_path(tree)[0]]


@pytest.fixture
def flash_log(monkeypatch):
    """Each flash-route call's ``(S, causal)``, passed on unchanged."""
    calls = []
    real = tattn.ops.attention
    monkeypatch.setattr(tattn.ops, "attention", lambda q, k, v, **kw: (
        calls.append((q.shape[1], kw["causal"])), real(q, k, v, **kw))[1])
    return calls


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d", [(1, 64), (17, 64), (64, 64), (8, 768)])
def test_sinusoidal_positions_match_jax(seq, d):
    want = np.asarray(jlayers.sinusoidal_positions(seq, d))
    got = tlayers.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,n_pos", [(64, 64), (768, 8)])
def test_sinusoidal_at_matches_jax(d, n_pos):
    """The decode step's embedding at one position, in the reference's
    decode arithmetic."""
    for pos in range(n_pos):
        want = np.asarray(jtf._sinusoidal_at(jnp.int32(pos), d))
        got = ttf._sinusoidal_at(pos, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=str(pos))


@pytest.mark.parametrize("which", ["table", "at"])
def test_sinusoids_at_whisper_length_match_jax(which):
    """Both sinusoids at whisper-small's served length (1,500 encoder
    frames, d = 768).  An angle ``pos · div`` carries ``pos · ulp(div)``
    of rounding, so the bound grows with the position: ``1e-6 + 2^-23 ·
    seq``, some 1.8e-4 at 1,500, where a wrong frequency or swapped sin and
    cos lanes are off by O(1)."""
    seq, d = 1500, 768
    atol = 1e-6 + 2.0 ** -23 * seq
    if which == "table":
        want = np.asarray(jlayers.sinusoidal_positions(seq, d))
        got = tlayers.sinusoidal_positions(seq, d).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
        return
    for pos in [*range(0, seq, 37), seq - 1]:
        want = np.asarray(jtf._sinusoidal_at(jnp.int32(pos), d))
        got = ttf._sinusoidal_at(pos, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol,
                                   err_msg=str(pos))


def test_cross_attn_params_layout():
    """Keys, shapes and dtypes of ``cross_attn_params`` against the
    reference's: all ``n_heads`` heads for K and V."""
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    jp = jattention.cross_attn_params(jax.random.PRNGKey(0), jcfg)
    tp = tattn.cross_attn_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    assert list(tp) == list(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape and str(tp[k].dtype) == \
            f"torch.{v.dtype}", k


@pytest.mark.parametrize("s,s_enc", [(5, 9), (9, 5), (1, 7)])
def test_cross_attention_apply_matches_jax(s, s_enc):
    """Prefill (K and V from ``enc_out``, returned) with S_dec != S_enc,
    then the same queries against the returned K/V as ``kv_cache``: the
    output equal within 1e-5, and ``enc_out`` no longer read."""
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    jp = jattention.cross_attn_params(jax.random.PRNGKey(1), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(50)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, s_enc, jcfg.d_model)).astype(np.float32)
    want, (wk, wv) = jattention.cross_attention_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(enc))
    got, (gk, gv) = tattn.cross_attention_apply(
        tp, tcfg, torch.from_numpy(x), torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for a, b in ((gk, wk), (gv, wv)):
        assert tuple(a.shape) == (2, s_enc, tcfg.n_heads, tcfg.head_dim_)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    want_c, _ = jattention.cross_attention_apply(
        jp, jcfg, jnp.asarray(x), None, kv_cache=(wk, wv))
    got_c, kv = tattn.cross_attention_apply(tp, tcfg, torch.from_numpy(x),
                                            None, kv_cache=(gk, gv))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert kv[0] is gk and kv[1] is gv


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_full_width_parameter_count():
    cfg = get_config(ARCH)
    model = ttf.Transformer(cfg, ttf._param_tree(cfg, None,
                                                 torch.device("meta")))
    shapes = jax.eval_shape(lambda k: jtf.init_params(jax_get_config(ARCH),
                                                      k),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert ttf.count_params(model) == want == FULL_PARAMS


def test_plan_puts_the_encoder_first():
    cfg = get_config(ARCH)
    kinds = [s.kind for s in ttf.layer_slots(cfg)]
    assert kinds == ["enc_attn_mlp"] * 12 + ["dec_attn_mlp"] * 12
    assert [g.name for g in ttf.build_plan(cfg)] == ["encoder", "decoder"]
    assert all(s.window == -1 for s in ttf.layer_slots(cfg))


def test_params_round_trip_the_references_tree():
    """``enc_final_norm``, ``ln_cross`` and ``cross`` included."""
    _, _, jp, model = _models()
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    got = jax.tree_util.tree_leaves_with_path(ttf.params_to_arrays(model))
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    names = dict(model.named_parameters())
    assert {"enc_final_norm.scale", "blocks.2.ln_cross.scale",
            "blocks.2.cross.p.wk"} <= set(names)
    assert "blocks.0.cross.p.wk" not in names


@pytest.mark.parametrize("explicit", [False, True])
def test_forward_matches_jax(explicit, flash_log):
    """Logits, ``enc_out`` and every decoder layer's (K, V, xK, xV)
    against the reference's; an encoder layer's cache is empty, as the
    reference's ``{}`` group.  Without ``positions`` the encoder takes the
    flash route not causal, then the decoder causal (the kernel's plain
    version here); with explicit ``positions`` neither does."""
    jcfg, tcfg, jp, model = _models()
    batch = _batch(jcfg, 2, 10, 7, 51)
    if explicit:
        batch["positions"] = np.broadcast_to(
            np.arange(10, dtype=np.int32), (2, 10)).copy()
    want, _, jc = jtf.forward(jp, jcfg, _jax(batch), return_caches=True)
    got, aux, tc = ttf.forward(model, _torch(batch), return_caches=True)
    assert float(aux) == 0.0
    assert flash_log == ([] if explicit else [(7, False)] * 2
                         + [(10, True)] * 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tc["enc_out"].numpy(),
                               np.asarray(jc["enc_out"]), **TOL)
    assert jc["layers"][0] == {}
    for layer, slot in zip(tc["layers"], ttf.layer_slots(tcfg)):
        if slot.kind == "enc_attn_mlp":
            assert layer == ()
            continue
        ref = jc["layers"][slot.group][slot.key]
        assert len(layer) == len(ref) == 4
        for a, b in zip(layer, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b[slot.repeat]),
                                       **TOL)


def test_make_cache_matches_the_references():
    """Zero caches: the decoder's cross pair at ``s_max`` as the
    reference allocates it, nothing for the encoder; ``enc_out`` beside."""
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    enc = torch.ones((3, 5, tcfg.d_model))
    cache = ttf.make_cache(tcfg, 3, 20, "cpu", enc_out=enc)
    assert cache["enc_out"] is enc
    jc = jtf.init_cache(jcfg, 3, 20)
    for layer, s in zip(cache["layers"], ttf.layer_slots(tcfg)):
        want = [] if s.kind == "enc_attn_mlp" else [
            (tuple(a.shape[1:]), str(a.dtype)) for a in jc[s.group][s.key]]
        assert [(tuple(t.shape), str(t.dtype).split(".")[1])
                for t in layer] == want
        assert not any(t.any() for t in layer)


@pytest.mark.parametrize("prompt,s_enc", [(6, 9), (9, 9)])
def test_prefill_then_decode_matches_jax(prompt, s_enc):
    """Prefill, ``extend_cache`` and 4 decode steps against the reference's
    ``decode_step``.  ``extend_cache`` grows only the self-attention K/V to
    ``s_max``; the cross K/V keep the encoder's length, also where it
    equals ``prompt_len`` (the reference picks them by slot, not shape:
    zero-padded keys would take softmax mass)."""
    jcfg, tcfg, jp, model = _models(seed=2)
    s_max = prompt + 6
    batch = _batch(jcfg, 2, prompt + 4, s_enc, 52)
    pre = dict(batch, tokens=batch["tokens"][:, :prompt])
    _, _, jc = jtf.forward(jp, jcfg, _jax(pre), return_caches=True)
    jc = jax_extend_cache(jcfg, jc, prompt, s_max)
    _, tc = tsteps.make_prefill_step(tcfg)(model, _torch(pre))
    tc = tsteps.extend_cache(tcfg, tc, prompt, s_max)
    for layer, s in zip(tc["layers"], ttf.layer_slots(tcfg)):
        if s.kind == "enc_attn_mlp":
            assert layer == ()
            continue
        assert [t.shape[1] for t in layer] == [s_max, s_max, s_enc, s_enc]
        assert [tuple(t.shape) for t in layer] == \
            [tuple(a.shape[1:]) for a in jc["layers"][s.group][s.key]]
    decode = tsteps.make_decode_step(tcfg)
    toks = batch["tokens"]
    for i in range(prompt, prompt + 4):
        want, jc = jtf.decode_step(jp, jcfg, jc, {
            "tokens": jnp.asarray(toks[:, i:i + 1]),
            "cache_pos": jnp.int32(i)})
        got, tc = decode(model, tc, {"tokens": torch.from_numpy(
            toks[:, i:i + 1]), "cache_pos": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("prefix,s_enc", [(4, 6), (6, 6)])
def test_decode_matches_forward_suffix(prefix, s_enc):
    """Decode with the cross K/V cached at prefill against the teacher-forced
    forward, as ``tests/test_archs.py::test_whisper_decode_matches_forward``
    holds the reference; at ``prompt_len == S_enc`` too."""
    _, tcfg, _, model = _models(seed=2)
    batch = _torch(_batch(tcfg, 1, 12, s_enc, 53))
    full, _ = ttf.forward(model, batch)
    _, _, caches = ttf.forward(model, dict(
        batch, tokens=batch["tokens"][:, :prefix]), return_caches=True)
    cache = tsteps.extend_cache(tcfg, caches, prefix, 12)
    for i in range(prefix, 12):
        logits, cache = ttf.decode_step(model, cache, {
            "tokens": batch["tokens"][:, i:i + 1], "cache_pos": i})
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, i].numpy(),
                                   **TOL)


def test_engine_serves_token_decoders_only():
    with pytest.raises(NotImplementedError, match="token decoders"):
        ServeEngine(get_config(ARCH, reduced=True), device="cpu")


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def test_training_forward_takes_no_flash_route(flash_log):
    """Under autograd the loss function passes explicit positions: the
    encoder gets ``arange(S_enc)`` and neither side reaches the flash
    route, which would raise."""
    _, tcfg, _, model = _models()
    model.requires_grad_(True)
    tot, _ = tts.make_loss_fn(tcfg)(model, _torch(_batch(tcfg, 2, 9, 6,
                                                         54)))
    tot.backward()
    assert flash_log == []
    assert model.blocks[0].attn.p["wq"].grad.abs().sum() > 0


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(remat):
    """``enc_out`` crosses each decoder block's checkpoint: the gradients
    (the encoder's included, through the cross-attention) under ``remat``
    equal those without."""
    import dataclasses

    _, tcfg, jp, _ = _models(seed=3)
    batch = _torch(_batch(tcfg, 2, 9, 6, 55))
    grads = []
    for r in ("none", remat):
        cfg = dataclasses.replace(tcfg, remat=r)
        model = ttf.params_from_arrays(cfg, jax.tree.map(np.asarray, jp),
                                       "cpu").requires_grad_(True)
        tot, _ = tts.make_loss_fn(cfg)(model, batch)
        names = [n for n, _ in model.named_parameters()]
        grads.append(dict(zip(names, torch.autograd.grad(
            tot, list(model.parameters())))))
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7,
                                   msg=name)
    assert grads[0]["blocks.0.attn.p.wq"].abs().sum() > 0


def test_train_step_matches_reference():
    """One step at ``n_micro=2`` on tokens and encoder frames: loss and
    gradient norm rtol 1e-5, every updated weight and first moment within
    2e-4."""
    jcfg, tcfg, jp, _ = _models(seed=4)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-4, 2, 10))
    to = topt.AdamW(lr=topt.warmup_cosine(1e-4, 2, 10))
    batch = _batch(jcfg, 4, 13, 8, 56)
    js, jm = jax.jit(jts.make_train_step(jcfg, jo, n_micro=2))(
        jts.TrainState(params=jp, opt=jo.init(jp)), _jax(batch))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu").requires_grad_(True)
    ts, tm = tts.make_train_step(tcfg, to, n_micro=2)(
        tts.TrainState(params=model,
                       opt=to.init(dict(model.named_parameters()))),
        _torch(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    arrays = tts.train_state_to_arrays(ts)
    for got, want in ((arrays.params, js.params), (arrays.opt.m, js.opt.m)):
        got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                       err_msg=name)


def test_checkpoints_cross_packages(tmp_path):
    """A train state after one reference step restores in the port and
    back bit for bit; the manifests agree and name the encoder-decoder's
    leaves."""
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    opt = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    js = jts.init_train_state(jcfg, opt, jax.random.PRNGKey(1))
    js, _ = jax.jit(jts.make_train_step(jcfg, opt))(
        js, _jax(_batch(jcfg, 4, 9, 6, 57)))
    host = jax.tree.map(np.asarray, js)
    ts = tts.train_state_from_arrays(tcfg, host, "cpu")
    JCheckpointer(str(tmp_path / "ref")).save(2, js, metadata={"step": 2})
    Checkpointer(str(tmp_path / "port")).save(
        2, tts.train_state_to_arrays(ts), metadata={"step": 2})
    manifests = [json.load(open(tmp_path / d / "step_0000000002" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert {"params__enc_final_norm__scale",
            "params__groups__1__dec_attn_mlp_0__ln_cross__scale",
            "opt__m__groups__1__dec_attn_mlp_0__cross__wv",
            "params__groups__0__enc_attn_mlp_0__ffn__w_up"} <= set(
                manifests[0]["leaves"])
    live = tts.init_train_state(tcfg, topt.AdamW(
        lr=topt.warmup_cosine(1e-3, 2, 10)), seed=5, device="cpu")
    tree, meta = Checkpointer(str(tmp_path / "ref")).restore(
        tts.train_state_to_arrays(live, shapes_only=True))
    assert meta == {"step": 2}
    tts.load_train_state_(live, tree)
    theirs, _ = JCheckpointer(str(tmp_path / "port")).restore(js)
    for got in (tts.train_state_to_arrays(live),
                jax.tree.map(np.asarray, theirs)):
        g, w = _flat(got), _flat(host)
        assert [n for n, _ in g] == [n for n, _ in w]
        for (name, a), (_, b) in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
