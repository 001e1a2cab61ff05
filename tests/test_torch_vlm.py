"""The port's vision-language decoder, reduced qwen2-vl-2b, on the CPU
against the JAX package: ``apply_mrope`` (M-RoPE), embedding inputs, the
model's forward, prefill/decode, a train step and checkpoints, with the
reference's weights carried across (``params_from_arrays``).

Inputs are numpy arrays from seeds, handed to both packages; the
``positions3`` grids are laid out as Qwen2-VL lays out a prompt (text on
one index on all three axes, an image's patches at (start, start + row,
start + column), the text after it resumed at the largest index + 1).
Tolerances: ``apply_mrope`` in float32 1e-6, in bfloat16 ``3e-2 · max(1,
max |want|)`` (the bf16 contract of ``chip_smoke.py``'s seam); the model
(float32 compute) 2e-4, as ``tests/test_torch_serve.py`` holds the dense
ones; a train step's loss and gradient norm 1e-5 relative, its weights
2e-4 (at a learning rate of 5e-5, below which AdamW's first move of 2 lr
on a near-zero gradient stays); checkpoints bit for bit.
"""
import dataclasses
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

ARCH = "qwen2-vl-2b"
TOL = dict(rtol=2e-4, atol=2e-4)
BF16_CONTRACT = 3e-2
# jax.eval_shape of the reference's init_params at the published widths
FULL_PARAMS = 1_543_853_568


def qwen2vl_positions3(b, s, before, grid):
    """(3, b, s) grids: ``before`` text positions, one image of ``grid`` =
    (t, h, w) patches, text to fill; and the next text index."""
    t, h, w = grid
    n = t * h * w
    p = np.empty((3, s), dtype=np.int32)
    p[:, :before] = np.arange(before)
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                             indexing="ij")
    for axis, idx in enumerate((ti, hi, wi)):
        p[axis, before:before + n] = before + idx.ravel()
    nxt = int(p[:, :before + n].max()) + 1
    p[:, before + n:] = nxt + np.arange(s - before - n)
    return np.broadcast_to(p[:, None], (3, b, s)).copy(), nxt + s - before - n


def _models(seed=0):
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, model


def _batch(cfg, b, s, seed, grid=(1, 2, 3), before=2):
    rng = np.random.default_rng(seed)
    p3, nxt = qwen2vl_positions3(b, s, before, grid)
    return {"embeds": rng.normal(size=(b, s, cfg.d_model)).astype(
        np.float32), "positions3": p3}, nxt


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

def test_positions3_layout():
    p3, nxt = qwen2vl_positions3(1, 14, 2, (1, 2, 3))
    assert p3[:, 0, :2].tolist() == [[0, 1]] * 3
    assert p3[0, 0, 2:8].tolist() == [2] * 6
    assert p3[1, 0, 2:8].tolist() == [2, 2, 2, 3, 3, 3]
    assert p3[2, 0, 2:8].tolist() == [2, 3, 4, 2, 3, 4]
    assert p3[:, 0, 8].tolist() == [5, 5, 5] and nxt == 11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_apply_mrope_matches_jax(sections, dtype):
    """Distinct t/h/w grids (an image of 2 x 3 x 4 patches) rotate each
    section of the frequency lanes by its own grid."""
    d = 2 * sum(sections)
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 30, 3, d)).astype(np.float32)
    p3, _ = qwen2vl_positions3(2, 30, 3, (2, 3, 4))
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jlayers.apply_mrope(jx, jnp.asarray(p3), sections,
                                          1e6).astype(jnp.float32))
    got = tlayers.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(p3), sections, 1e6)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        atol = BF16_CONTRACT * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=atol)


def test_apply_mrope_with_equal_grids_is_apply_rope():
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(size=(2, 9, 4, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 500, (2, 9)))
    assert torch.equal(tlayers.apply_mrope(x, pos[None].expand(3, 2, 9),
                                           (2, 3, 3), 1e4),
                       tlayers.apply_rope(x, pos, 1e4))


def test_apply_mrope_sections_must_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 16))
    with pytest.raises(AssertionError):
        tlayers.apply_mrope(x, torch.zeros((3, 1, 2), dtype=torch.long),
                            (2, 3, 4))


@pytest.mark.parametrize("flash", [False, True])
def test_attention_apply_mrope_matches_jax(flash, monkeypatch):
    """One M-RoPE attention layer (GQA 4:1): explicit positions take
    ``_sdpa_masked``, none the flash route (its plain version here), each
    held to the reference's (which masks on ``arange(S)`` either way)."""
    jcfg, tcfg, jp, model = _models()
    p = jp["groups"][0]["attn_mlp_0"]["attn"]
    jattn = {k: v[0] for k, v in p.items()}
    calls = []
    real = tattn.ops.attention
    monkeypatch.setattr(tattn.ops, "attention", lambda q, k, v, **kw: (
        calls.append(q.shape), real(q, k, v, **kw))[1])
    rng = np.random.default_rng(32)
    x = rng.normal(size=(2, 10, jcfg.d_model)).astype(np.float32)
    p3, _ = qwen2vl_positions3(2, 10, 1, (1, 2, 2))
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    want, (wk, _) = jattention.attention_apply(
        jattn, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.int32(-1),
        positions3=jnp.asarray(p3))
    got, (gk, _) = tattn.attention_apply(
        {k: torch.from_numpy(np.array(v)) for k, v in jattn.items()}, tcfg,
        torch.from_numpy(x), None if flash else torch.from_numpy(pos), -1,
        positions3=torch.from_numpy(p3))
    assert len(calls) == int(flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5,
                               atol=1e-5)


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


def test_params_round_trip_the_references_tree():
    _, _, jp, model = _models()
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    got = jax.tree_util.tree_leaves_with_path(ttf.params_to_arrays(model))
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("case", ["image", "default_positions3",
                                  "explicit_positions"])
def test_forward_matches_jax(case, monkeypatch):
    """Logits and every layer's K/V against the reference's forward on
    ``embeds``: with an image-grid ``positions3`` (the flash route: one
    call a layer), without ``positions3`` (the 1-D positions on all three
    grids) and with explicit ``positions`` (``_sdpa_masked``, no call)."""
    jcfg, tcfg, jp, model = _models()
    batch, _ = _batch(jcfg, 2, 16, 33, grid=(1, 3, 4))
    if case == "default_positions3":
        del batch["positions3"]
    if case == "explicit_positions":
        batch["positions"] = np.broadcast_to(
            np.arange(16, dtype=np.int32), (2, 16)).copy()
    calls = []
    real = tattn.ops.attention
    monkeypatch.setattr(tattn.ops, "attention", lambda q, k, v, **kw: (
        calls.append(kw["causal"]), real(q, k, v, **kw))[1])
    want, _, jc = jtf.forward(jp, jcfg, _jax(batch), return_caches=True)
    got, aux, tc = ttf.forward(model, _torch(batch), return_caches=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert calls == ([] if case == "explicit_positions"
                     else [True] * tcfg.n_layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tc["enc_out"] is None
    for layer, slot in zip(tc["layers"], ttf.layer_slots(tcfg)):
        ref = jc["layers"][slot.group][slot.key]
        for a, b in zip(layer, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b[slot.repeat]),
                                       **TOL)


def test_image_grid_moves_the_logits():
    """positions3 reaches the rotation: the image grid against the 1-D
    positions on all three axes gives other logits in both packages."""
    jcfg, _, jp, model = _models()
    batch, _ = _batch(jcfg, 1, 16, 34, grid=(1, 3, 4))
    flat = {"embeds": batch["embeds"]}
    a = ttf.forward(model, _torch(batch))[0].numpy()
    b = ttf.forward(model, _torch(flat))[0].numpy()
    ja = np.asarray(jtf.forward(jp, jcfg, _jax(batch))[0])
    jb = np.asarray(jtf.forward(jp, jcfg, _jax(flat))[0])
    assert np.abs(a - b).max() > 1e-2 and np.abs(ja - jb).max() > 1e-2


@pytest.mark.parametrize("prompt", [8, 12])
def test_prefill_then_decode_matches_jax(prompt):
    """Prefill on an image prompt, ``extend_cache`` and 4 decode steps of
    embeddings with ``positions3`` going on from the next text index on all
    three axes, against the reference's ``decode_step``; the cache's K/V
    grow to ``s_max`` and nothing else changes shape."""
    jcfg, tcfg, jp, model = _models(seed=2)
    s_max = prompt + 6
    batch, nxt = _batch(jcfg, 2, prompt, 35)
    steps = np.random.default_rng(36).normal(
        size=(4, 2, 1, jcfg.d_model)).astype(np.float32)
    _, _, jc = jtf.forward(jp, jcfg, _jax(batch), return_caches=True)
    jc = jax_extend_cache(jcfg, jc, prompt, s_max)
    _, tc = tsteps.make_prefill_step(tcfg)(model, _torch(batch))
    tc = tsteps.extend_cache(tcfg, tc, prompt, s_max)
    for layer, s in zip(tc["layers"], ttf.layer_slots(tcfg)):
        assert [tuple(t.shape) for t in layer] == \
            [tuple(a.shape[1:]) for a in jc["layers"][s.group][s.key]]
        assert all(t.shape[1] == s_max for t in layer)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(4):
        p3 = np.full((3, 2, 1), nxt + i, dtype=np.int32)
        want, jc = jtf.decode_step(jp, jcfg, jc, {
            "embeds": jnp.asarray(steps[i]), "positions3": jnp.asarray(p3),
            "cache_pos": jnp.int32(prompt + i)})
        got, tc = decode(model, tc, {
            "embeds": torch.from_numpy(steps[i]),
            "positions3": torch.from_numpy(p3), "cache_pos": prompt + i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_defaults_positions3_to_cache_pos():
    """Without ``positions3`` a decode step rotates by ``cache_pos`` on
    all three grids, as the reference's does."""
    jcfg, tcfg, jp, model = _models(seed=3)
    batch, _ = _batch(jcfg, 1, 10, 37)
    x = np.random.default_rng(38).normal(
        size=(1, 1, jcfg.d_model)).astype(np.float32)
    _, _, jc = jtf.forward(jp, jcfg, _jax(batch), return_caches=True)
    jc = jax_extend_cache(jcfg, jc, 10, 12)
    want, _ = jtf.decode_step(jp, jcfg, jc, {"embeds": jnp.asarray(x),
                                             "cache_pos": jnp.int32(10)})
    _, tc = tsteps.make_prefill_step(tcfg)(model, _torch(batch))
    tc = tsteps.extend_cache(tcfg, tc, 10, 12)
    got, _ = ttf.decode_step(model, tc, {"embeds": torch.from_numpy(x),
                                         "cache_pos": 10})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_engine_serves_token_decoders_only():
    with pytest.raises(NotImplementedError, match="token decoders"):
        ServeEngine(get_config(ARCH, reduced=True), device="cpu")


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def _flat(tree):
    return [(tree_path_str(kp), np.asarray(leaf))
            for kp, leaf in tree_flatten_with_path(tree)[0]]


def _train_batch(cfg, seed):
    batch, _ = _batch(cfg, 4, 12, seed)
    batch["labels"] = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32)
    return batch


def test_train_step_matches_reference():
    """One step at ``n_micro=2`` on ``embeds``, ``labels`` and an image
    ``positions3`` (split on its batch axis, 1): loss and gradient norm
    rtol 1e-5, every updated weight and first moment within 2e-4."""
    jcfg, tcfg, jp, _ = _models(seed=4)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-4, 2, 10))
    to = topt.AdamW(lr=topt.warmup_cosine(1e-4, 2, 10))
    batch = _train_batch(jcfg, 39)
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


def test_loss_takes_the_labels_to_the_logits_length():
    """An embeddings batch's labels may run longer than its positions: the
    loss slices them to the logits' length, as the reference's does."""
    jcfg, tcfg, jp, model = _models(seed=5)
    batch = _train_batch(jcfg, 40)
    batch["labels"] = np.concatenate(
        [batch["labels"], batch["labels"][:, :3]], axis=1)
    jtot, _ = jts.make_loss_fn(jcfg)(jp, _jax(batch))
    tot, _ = tts.make_loss_fn(tcfg)(model, _torch(batch))
    np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-5)


def test_checkpoints_cross_packages(tmp_path):
    """A train state after one reference step restores in the port and
    back bit for bit; the two manifests agree."""
    jcfg, tcfg = (get(ARCH, reduced=True)
                  for get in (jax_get_config, get_config))
    opt = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    js = jts.init_train_state(jcfg, opt, jax.random.PRNGKey(1))
    js, _ = jax.jit(jts.make_train_step(jcfg, opt))(
        js, _jax(_train_batch(jcfg, 41)))
    host = jax.tree.map(np.asarray, js)
    ts = tts.train_state_from_arrays(tcfg, host, "cpu")
    JCheckpointer(str(tmp_path / "ref")).save(2, js, metadata={"step": 2})
    Checkpointer(str(tmp_path / "port")).save(
        2, tts.train_state_to_arrays(ts), metadata={"step": 2})
    manifests = [json.load(open(tmp_path / d / "step_0000000002" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
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


def test_reduced_config_keeps_the_section_ratio():
    cfg = get_config(ARCH, reduced=True)
    assert cfg.mrope_sections == jax_get_config(ARCH,
                                                reduced=True).mrope_sections
    assert sum(cfg.mrope_sections) == cfg.head_dim_ // 2
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
