"""The port's recurrent blocks (``repro_torch.models.ssm``: mLSTM, sLSTM,
RG-LRU) and the two models built on them, reduced xlstm-1.3b and
recurrentgemma-9b, on the CPU against the JAX package, with the
reference's weights carried across (``params_from_arrays``, or the flat
block dicts with each ``{"scale": ...}`` norm as its scale).

Inputs are numpy arrays from seeds, handed to both packages.
Tolerances: the blocks in float32 ``1e-5`` (mLSTM ``2e-5``: its chunk
sums run through ``exp`` of gates up to ``e^5``), as ``rtol = atol``; in
bfloat16 compute ``3e-2 · max(1, max |want|)`` (the bf16 contract of
``chip_smoke.py``'s seam): XLA rounds some bf16 operations (``silu``'s
sigmoid) one ulp away from torch, and the mLSTM's normaliser amplifies
that.  Whole models (float32 compute) ``2e-4``, as
``tests/test_torch_serve.py`` holds the dense ones.  The RG-LRU scan
associates in another order than ``jax.lax.associative_scan`` and agrees
to rounding.

The reference's mLSTM disagrees with its own decode form and depends on
its chunk length (ROADMAP.md §3, "Reference fault, kept in the port");
:func:`test_mlstm_chunk_dependence_is_the_references` holds the port to
the same arithmetic, fault included.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.steps import extend_cache as jax_extend_cache
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serve import steps as tsteps
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=2e-4, atol=2e-4)
XLSTM, GRIFFIN = "xlstm-1.3b", "recurrentgemma-9b"
ARCHS = [XLSTM, GRIFFIN]
KINDS = {"mlstm": XLSTM, "slstm": XLSTM, "rglru": GRIFFIN}
F32_TOL = {"mlstm": 2e-5, "slstm": 1e-5, "rglru": 1e-5}
BF16_CONTRACT = 3e-2
# jax.eval_shape of the reference's init_params at the published widths
FULL_PARAMS = {XLSTM: 3_427_559_592, GRIFFIN: 7_483_486_208}


def _cfgs(arch, compute_dtype="float32", **changes):
    out = []
    for get in (jax_get_config, get_config):
        cfg = dataclasses.replace(get(arch, reduced=True),
                                  compute_dtype=compute_dtype, **changes)
        out.append(cfg)
    return out


def _flat(jp):
    return {k: torch.from_numpy(np.array(v["scale"] if isinstance(v, dict)
                                         else v)) for k, v in jp.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _close(got, want, kind, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        tol = F32_TOL[kind]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        atol = BF16_CONTRACT * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 8])
def test_causal_conv_matches_jax(s, with_state):
    """Width 4, so a decode state of width 3."""
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, s, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    want, wst = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    got, gst = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 None if st is None else torch.from_numpy(st))
    assert gst.shape == (2, 3, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), rtol=0, atol=0)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_params_layout_matches_jax(kind):
    """Key order, shapes and dtypes of ``*_params`` against the
    reference's, under bf16 parameters: the gate weights, biases and
    ``lam`` stay float32; ``b_f`` starts at 3 and ``lam`` at 2."""
    jcfg, tcfg = _cfgs(KINDS[kind], param_dtype="bfloat16")
    jp = getattr(jssm, f"{kind}_params")(jax.random.PRNGKey(0), jcfg)
    tp = getattr(tssm, f"{kind}_params")(tcfg,
                                         torch.Generator().manual_seed(0),
                                         "cpu")
    assert list(tp) == list(jp)
    for k, v in jp.items():
        want = v["scale"] if isinstance(v, dict) else v
        assert tuple(tp[k].shape) == want.shape, k
        assert tp[k].dtype == getattr(torch, str(want.dtype)), k
    if "b_f" in tp:
        assert torch.equal(tp["b_f"], torch.full_like(tp["b_f"], 3.0))
    if "lam" in tp:
        assert torch.equal(tp["lam"], torch.full_like(tp["lam"], 2.0))


def _block(kind, seed, dtype):
    jcfg, tcfg = _cfgs(KINDS[kind], dtype)
    jp = getattr(jssm, f"{kind}_params")(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _flat(jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 32])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_sequence_matches_jax(kind, s, dtype):
    """The sequence form from a zero state, output and final state; S = 8
    is one mLSTM chunk of the reduced config, S = 32 four."""
    jcfg, tcfg, jp, tp = _block(kind, 1, dtype)
    x = np.random.default_rng(41).normal(
        size=(2, s, jcfg.d_model)).astype(np.float32)
    apply = getattr(jssm, f"{kind}_apply")
    want, wc = apply(jp, jcfg, jnp.asarray(x))
    got, gc = getattr(tssm, f"{kind}_apply")(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and len(gc) == len(wc)
    _close(got, want, kind, dtype)
    for a, b in zip(gc, wc):
        assert a.dtype == getattr(torch, str(b.dtype))
        _close(a, b, kind, dtype)


def _random_cache(kind, cfg, b, rng):
    """A decode state of the block's shapes (the reference's init), filled
    from ``rng``; mLSTM's normaliser positive so ``|q·n|`` can pass 1."""
    init = getattr(jssm, f"{kind}_init_cache")(cfg, b)
    out = []
    for i, a in enumerate(init):
        v = rng.normal(size=a.shape).astype(np.float32)
        if kind == "mlstm" and i == 1:
            v = np.abs(v) * 3
        out.append(v.astype(np.asarray(a).dtype))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_decode_matches_jax(kind, dtype):
    """Three decode steps from a random state, each step's output and new
    state against the reference's, the state carried by each package."""
    jcfg, tcfg, jp, tp = _block(kind, 2, dtype)
    rng = np.random.default_rng(42)
    cache = _random_cache(kind, jcfg, 2, rng)
    jc = tuple(jnp.asarray(a) for a in cache)
    tc = tuple(torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
        getattr(torch, str(a.dtype))) for a in cache)
    for _ in range(3):
        x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        want, jc = getattr(jssm, f"{kind}_apply")(jp, jcfg, jnp.asarray(x),
                                                  jc)
        got, new = getattr(tssm, f"{kind}_apply")(tp, tcfg,
                                                  torch.from_numpy(x), tc)
        assert all(a is not b for a, b in zip(new, tc))   # returned new
        tc = new
        _close(got, want, kind, dtype)
        for a, b in zip(tc, jc):
            _close(a, b, kind, dtype)


def test_mlstm_refuses_a_ragged_chunking():
    jcfg, tcfg, jp, tp = _block("mlstm", 0, "float32")
    x = np.zeros((1, 12, jcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jssm.mlstm_apply(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="S = 12 .* chunk 8"):
        tssm.mlstm_apply(tp, tcfg, torch.from_numpy(x))


@pytest.mark.parametrize("s", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_recurrence(s):
    """``_linear_scan`` against the loop ``h = a h + b`` in float64."""
    rng = np.random.default_rng(43)
    a = rng.uniform(0.2, 1.0, size=(2, s, 3))
    b = rng.normal(size=(2, s, 3))
    h = np.zeros((2, 3))
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = tssm._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


def test_mlstm_chunk_dependence_is_the_references():
    """The reference fault, held in both packages: reduced xlstm's mLSTM
    block over 2 x 16 tokens at chunk 8 and at chunk 16 (``jax.random.
    PRNGKey(2)``): each chunking equal between the packages within 2e-5,
    while the two chunkings differ from each other by more than 0.5 in
    both (the reference scales only the intra-chunk scores by
    ``1/sqrt(hd)`` and weights its normaliser by the scores)."""
    outs = {}
    x = np.random.default_rng(44).normal(size=(2, 16, 64)).astype(np.float32)
    for chunk in (8, 16):
        jcfg, tcfg = _cfgs(XLSTM)
        jcfg, tcfg = (dataclasses.replace(c, xlstm=dataclasses.replace(
            c.xlstm, chunk=chunk)) for c in (jcfg, tcfg))
        jp = jssm.mlstm_params(jax.random.PRNGKey(2), jcfg)
        want, _ = jssm.mlstm_apply(jp, jcfg, jnp.asarray(x))
        got, _ = tssm.mlstm_apply(_flat(jp), tcfg, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
        outs[chunk] = (np.asarray(want), got.numpy())
    for i, pkg in enumerate(("reference", "port")):
        gap = np.abs(outs[8][i] - outs[16][i]).max()
        assert gap > 0.5, (pkg, gap)


def test_mlstm_decode_differs_from_its_sequence_form_as_the_reference():
    """The same fault from the other side: 16 one-token decode steps
    against the sequence form differ by more than 0.5, by the same
    amount in both packages (within 1e-4)."""
    jcfg, tcfg, jp, tp = _block("mlstm", 2, "float32")
    x = np.random.default_rng(45).normal(size=(2, 16, 64)).astype(np.float32)
    gaps = []
    for ssm, cfg, p, arr, init in (
            (jssm, jcfg, jp, jnp.asarray,
             lambda: jssm.mlstm_init_cache(jcfg, 2)),
            (tssm, tcfg, tp, torch.from_numpy,
             lambda: tssm.mlstm_init_cache(tcfg, 2))):
        seq, _ = ssm.mlstm_apply(p, cfg, arr(x))
        cache, steps = init(), []
        for t in range(16):
            y, cache = ssm.mlstm_apply(p, cfg, arr(x[:, t:t + 1]), cache)
            steps.append(_np(y))
        gaps.append(np.abs(np.concatenate(steps, 1) - _np(seq)).max())
    assert gaps[0] > 0.5
    np.testing.assert_allclose(gaps[1], gaps[0], rtol=1e-4)


# ---------------------------------------------------------------------------
# the plan and the parameter tree
# ---------------------------------------------------------------------------

def _plan(g):
    return (g.name, g.parts, g.repeats, g.d_ff_override,
            None if g.windows is None else g.windows.tolist())


@pytest.mark.parametrize("arch,reduced,n_layers", [
    (XLSTM, True, None), (XLSTM, False, None), (GRIFFIN, True, 3),
    (GRIFFIN, True, 5), (GRIFFIN, False, 38)])
def test_layer_slots_follow_the_reference_plan(arch, reduced, n_layers):
    """``build_plan`` equal to the reference's (groups, parts, repeats,
    windows), and ``layer_slots`` its instances repeat by repeat: griffin
    at 5 layers has the ``griffin_rem`` group of two RG-LRU."""
    jcfg, tcfg = (get(arch, reduced=reduced)
                  for get in (jax_get_config, get_config))
    if n_layers is not None:
        jcfg, tcfg = (dataclasses.replace(c, n_layers=n_layers)
                      for c in (jcfg, tcfg))
    jplan = jtf.build_plan(jcfg)
    assert [_plan(g) for g in ttf.build_plan(tcfg)] == \
        [_plan(g) for g in jplan]
    want = [(gi, f"{k}_{i}", r, k,
             -1 if g.windows is None else int(g.windows[r, i]))
            for gi, g in enumerate(jplan) for r in range(g.repeats)
            for k, i in g.instances]
    got = [(s.group, s.key, s.repeat, s.kind, s.window)
           for s in ttf.layer_slots(tcfg)]
    assert got == want and len(got) == tcfg.n_layers
    if n_layers == 5:
        assert [g.name for g in jplan] == ["griffin", "griffin_rem"]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_count(arch):
    cfg = get_config(arch)
    model = ttf.Transformer(cfg, ttf._param_tree(cfg, None,
                                                 torch.device("meta")))
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert ttf.count_params(model) == want == FULL_PARAMS[arch]


def _models(arch, seed=0, n_layers=None):
    jcfg, tcfg = (get(arch, reduced=True)
                  for get in (jax_get_config, get_config))
    if n_layers is not None:
        jcfg, tcfg = (dataclasses.replace(c, n_layers=n_layers)
                      for c in (jcfg, tcfg))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, model


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_the_references_tree(arch):
    _, _, jp, model = _models(arch)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    got = jax.tree_util.tree_leaves_with_path(ttf.params_to_arrays(model))
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_seeded(arch):
    cfg = get_config(arch, reduced=True)
    a, b, c = (dict(ttf.init_params(cfg, seed, "cpu").named_parameters())
               for seed in (5, 5, 6))
    assert list(a) == list(b) == list(c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    want = jtf.count_params(jtf.init_params(jax_get_config(arch, True),
                                            jax.random.PRNGKey(0)))
    assert sum(t.numel() for t in a.values()) == want


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_layers", [(XLSTM, None), (GRIFFIN, None),
                                           (GRIFFIN, 5)])
def test_forward_matches_jax(arch, n_layers, monkeypatch):
    """Logits and every layer's cache (its kind's state) against the
    reference's; recurrentgemma's ``local_attn`` takes the flash route
    (the kernel's plain version here) at its window, xlstm no attention."""
    jcfg, tcfg, jp, model = _models(arch, n_layers=n_layers)
    calls = []
    real = tattn.ops.attention
    monkeypatch.setattr(tattn.ops, "attention", lambda q, k, v, **kw: (
        calls.append(kw["window"]), real(q, k, v, **kw))[1])
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want, want_aux, jcache = jtf.forward(jp, jcfg,
                                         {"tokens": jnp.asarray(toks)},
                                         return_caches=True)
    got, aux, tcache = ttf.forward(model, {"tokens": torch.from_numpy(toks)},
                                   return_caches=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    slots = ttf.layer_slots(tcfg)
    assert calls == [s.window for s in slots if s.kind == "local_attn"]
    for layer, slot in zip(tcache["layers"], slots):
        ref = jcache["layers"][slot.group][slot.key]
        assert len(layer) == len(ref)
        for a, b in zip(layer, ref):
            np.testing.assert_allclose(_np(a), _np(b[slot.repeat]), **TOL)


def test_make_cache_holds_each_kinds_state():
    """``make_cache`` against the reference's ``init_cache`` (one repeat of
    each stacked leaf): shapes and dtypes, all zero; the recurrent states
    do not grow with ``s_max``."""
    for arch in ARCHS:
        jcfg, tcfg = (get(arch, reduced=True)
                      for get in (jax_get_config, get_config))
        layers = ttf.make_cache(tcfg, 3, 20, "cpu")["layers"]
        jc = jtf.init_cache(jcfg, 3, 20)
        want = [[(tuple(a.shape[1:]), str(a.dtype))
                 for a in jc[s.group][s.key]] for s in ttf.layer_slots(tcfg)]
        got = [[(tuple(t.shape), str(t.dtype).split(".")[1]) for t in layer]
               for layer in layers]
        assert got == want
        assert not any(t.any() for layer in layers for t in layer)


@pytest.mark.parametrize("arch,prompt,clash", [
    (XLSTM, 8, False), (XLSTM, 4, True), (GRIFFIN, 12, False),
    (GRIFFIN, 64, True)])
def test_prefill_then_decode_matches_jax(arch, prompt, clash):
    """Prefill, ``extend_cache`` and 4 decode steps against the
    reference's.  xlstm at 4 prompt tokens (one chunk of 4: mLSTM's C and
    n have 4 heads on axis 1) and recurrentgemma at 64 (RG-LRU's ``h`` has
    ``d_rnn = 64`` on axis 1): a recurrent state whose axis 1 equals the
    prompt length must pass through unpadded, as the reference picks
    layers by kind, never by shape."""
    jcfg, tcfg, jp, model = _models(arch, seed=2)
    s_max = prompt + 6
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, prompt + 4)).astype(np.int32)
    _, _, jc = jtf.forward(jp, jcfg,
                           {"tokens": jnp.asarray(toks[:, :prompt])},
                           return_caches=True)
    jc = jax_extend_cache(jcfg, jc, prompt, s_max)
    _, tc = tsteps.make_prefill_step(tcfg)(
        model, {"tokens": torch.from_numpy(toks[:, :prompt])})
    tc = tsteps.extend_cache(tcfg, tc, prompt, s_max)
    slots = ttf.layer_slots(tcfg)
    assert clash == any(t.shape[1] == prompt
                        for layer, s in zip(tc["layers"], slots)
                        if not ttf.is_attention(s.kind) for t in layer)
    for layer, s in zip(tc["layers"], slots):
        want = [tuple(a.shape[1:]) for a in jc["layers"][s.group][s.key]]
        assert [tuple(t.shape) for t in layer] == want
        if ttf.is_attention(s.kind):
            assert all(t.shape[1] == s_max for t in layer)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(prompt, prompt + 4):
        want, jc = jtf.decode_step(jp, jcfg, jc, {
            "tokens": jnp.asarray(toks[:, i:i + 1]),
            "cache_pos": jnp.int32(i)})
        got, tc = decode(model, tc, {"tokens": torch.from_numpy(
            toks[:, i:i + 1]), "cache_pos": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_layers", [None, 5])
def test_griffin_decode_matches_forward_suffix(n_layers):
    """recurrentgemma's decode against its teacher-forced forward, as
    ``tests/test_archs.py`` holds the reference (xlstm's mLSTM does not
    have this property in either package: the reference fault)."""
    _, tcfg, _, model = _models(GRIFFIN, seed=1, n_layers=n_layers)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, 24)).astype(np.int32))
    full, _ = ttf.forward(model, {"tokens": toks})
    _, _, caches = ttf.forward(model, {"tokens": toks[:, :4]},
                               return_caches=True)
    cache = tsteps.extend_cache(tcfg, caches, 4, 24)
    for i in range(4, 24):       # past the reduced window of 16
        logits, cache = ttf.decode_step(model, cache, {
            "tokens": toks[:, i:i + 1], "cache_pos": i})
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, i].numpy(),
                                   **TOL)


def _requests(cfg, n, max_len, seed):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, cfg.vocab_size,
                               size=int(rng.integers(3, max_len + 1)),
                               dtype=np.int32)) for uid in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_matches_jax(arch):
    """The engine serves both models: the reference engine's tokens and
    counters, prompts left-padded to 8 (a chunk of reduced xlstm)."""
    jcfg, tcfg, jp, model = _models(arch, seed=4)
    kw = dict(max_batch=2, prompt_len=8, s_max=16)
    jeng = JServeEngine(jcfg, params=jp, **kw)
    teng = ServeEngine(tcfg, params=model, device="cpu", **kw)
    for uid, prompt in _requests(tcfg, 3, 8, seed=1):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new=3))
        teng.submit(Request(uid=uid, prompt=prompt, max_new=3))
    want, got = jeng.run(), teng.run()
    assert got == want
    assert len(got) == 3 and all(len(v) == 3 for v in got.values())
    assert teng.stats() == jeng.stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "2", "--prompt-len", "8", "--s-max", "16"])
    assert "served 3/3 requests" in capsys.readouterr().out
