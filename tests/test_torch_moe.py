"""The port's mixture-of-experts FFN (``models/moe.py``) and the models
built on it and on MLA, on the CPU against the JAX package: ``moe_apply``
with the reference's weights carried across, at a capacity that drops
routings (1.25) and one that drops none (16), with and without a shared
expert, and with a router that sends most tokens to one expert; then the
four architectures this slice ports (reduced granite-moe-1b-a400m,
deepseek-v2-lite-16b, glm4-9b and granite-34b): forward logits, aux and
caches, prefill then decode, decode against the teacher-forced forward,
the layer layout in the reference's parameter tree, and the full-width
parameter counts.

Inputs are numpy arrays from seeds, handed to both packages; the routers'
probabilities have no ties (``torch.topk``'s order on ties is unspecified,
``jax.lax.top_k`` takes the lower index first).  Tolerances (float32
compute): ``moe_apply``'s output 1e-5 and aux 1e-6; whole-model logits,
aux and caches 2e-4, as ``tests/test_torch_serve.py`` holds the dense
models (sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve.steps import extend_cache as jax_extend_cache
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve import steps as tsteps

TOL = dict(rtol=2e-4, atol=2e-4)
NEW_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "glm4-9b",
             "granite-34b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
# jax.eval_shape of the reference's init_params at the published widths
FULL_PARAMS = {"granite-moe-1b-a400m": 1_334_887_424,
               "deepseek-v2-lite-16b": 15_706_484_224,
               "glm4-9b": 9_399_767_040, "granite-34b": 33_962_366_976}


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_cfgs(capacity_factor, n_shared):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("deepseek-v2-lite-16b", reduced=True)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor, n_shared=n_shared)))
    return out


def _carry(jp):
    return {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _loads(jp, x, k):
    """Routings per expert, from the reference's router."""
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, -1) @ jp["router"])
    _, top_e = jax.lax.top_k(probs, k)
    return np.bincount(np.asarray(top_e).ravel(),
                       minlength=jp["router"].shape[1])


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_apply_matches_jax(capacity_factor, n_shared, skewed):
    jcfg, tcfg = _moe_cfgs(capacity_factor, n_shared)
    m = jcfg.moe
    jp = jmoe.moe_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(31)
    b, s = 2, 6         # 24 routings, 7 slots an expert at 1.25
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    if skewed:
        # a shared direction in every token, which expert 0's router
        # column reads: most tokens route to expert 0
        u = rng.normal(size=jcfg.d_model).astype(np.float32)
        x += 2 * u
        router = np.array(jp["router"])
        router[:, 0] += 0.5 * u / np.linalg.norm(u)
        jp = dict(jp, router=jnp.asarray(router))
    capacity = tmoe.moe_capacity(tcfg, b * s)
    loads = _loads(jp, x, m.top_k)
    if capacity_factor < 2:              # routings are dropped here
        assert loads.max() > capacity, (loads, capacity)
    if skewed:
        assert loads[0] >= 0.8 * b * s, loads
    want, want_aux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got, aux = tmoe.moe_apply(_carry(jp), tcfg, torch.from_numpy(x))
    assert got.shape == (b, s, jcfg.d_model) and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6,
                               atol=1e-6)


def test_moe_apply_drops_the_later_tokens():
    """Past capacity, an expert keeps its first routings in token order:
    a token whose every routing is dropped gets only the shared
    experts' output (zero without them)."""
    jcfg, tcfg = _moe_cfgs(0.1, 0)
    jp = jmoe.moe_params(jax.random.PRNGKey(4), jcfg)
    x = np.random.default_rng(32).normal(
        size=(1, 40, jcfg.d_model)).astype(np.float32)
    got, _ = tmoe.moe_apply(_carry(jp), tcfg, torch.from_numpy(x))
    assert tmoe.moe_capacity(tcfg, 40) == 2
    # 4 experts x 2 slots: at most 8 routings kept, from the first tokens
    zero = (got[0].abs().sum(-1) == 0).numpy()
    assert zero[-20:].all() and not zero[:2].any()
    want, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_moe_params_layout_matches_jax(param_dtype):
    jcfg, tcfg = (dataclasses.replace(c, param_dtype=param_dtype)
                  for c in _moe_cfgs(1.25, 1))
    jp = jmoe.moe_params(jax.random.PRNGKey(0), jcfg)
    tp = tmoe.moe_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert list(tp) == list(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert tp[k].dtype == getattr(torch, str(v.dtype)), k
    assert tp["router"].dtype == torch.float32


@pytest.mark.parametrize("t,arch,want", [
    (8, "deepseek-v2-lite-16b", 1), (8, "granite-moe-1b-a400m", 2),
    (16384, "deepseek-v2-lite-16b", 1920), (2, "granite-moe-1b-a400m", 1),
    (1024, "granite-moe-1b-a400m", 320)])
def test_capacity_is_the_references(t, arch, want):
    """``int(max(1, (t·k·capacity_factor) // E))`` in Python floats: a
    decode step of 8 slots leaves deepseek one slot an expert."""
    m = jax_get_config(arch).moe
    assert tmoe.moe_capacity(get_config(arch), t) == want == int(
        max(1, (t * m.top_k * m.capacity_factor) // m.n_experts))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _models(arch, seed=0, **moe_changes):
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    if moe_changes:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, **moe_changes)) for c in (jcfg, tcfg))
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, model


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_layer_slots_follow_the_reference_plan(arch):
    """The module's layers sit in the reference's groups as its plan says:
    the plan's groups, the layers' windows, and the parameter tree the
    module writes (key paths, shapes and dtypes) equal to the reference's
    ``init_params`` at the reduced widths."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jplan = jtf.build_plan(jcfg)
    plan = ttf.build_plan(cfg)
    assert [(g.name, g.parts, g.repeats, g.d_ff_override) for g in plan] \
        == [(g.name, g.parts, g.repeats, g.d_ff_override) for g in jplan]
    model = ttf.Transformer(cfg, ttf._param_tree(cfg, None,
                                                 torch.device("meta")))
    assert [b.window for b in model.blocks] == [
        s.window for s in ttf.layer_slots(cfg)]
    rcfg, jrcfg = get_config(arch, reduced=True), \
        jax_get_config(arch, reduced=True)
    small = ttf.Transformer(rcfg, ttf._param_tree(rcfg, None,
                                                  torch.device("meta")))
    tree = ttf.arrays_from_named(dict(small.named_parameters()), rcfg,
                                 shapes_only=True)
    want = jax.eval_shape(lambda k: jtf.init_params(jrcfg, k),
                          jax.random.PRNGKey(0))
    got = {jax.tree_util.keystr(kp): (a.shape, np.dtype(a.dtype))
           for kp, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == {jax.tree_util.keystr(kp): (a.shape, np.dtype(a.dtype))
                   for kp, a in jax.tree_util.tree_flatten_with_path(want)[0]}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_parameter_count(arch):
    cfg = get_config(arch)
    model = ttf.Transformer(cfg, ttf._param_tree(cfg, None,
                                                 torch.device("meta")))
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert ttf.count_params(model) == want == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_round_trip_the_references_tree(arch):
    _, _, jp, model = _models(arch)
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    got = jax.tree_util.tree_leaves_with_path(ttf.params_to_arrays(model))
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, model = _models(arch)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want, want_aux, jcache = jtf.forward(jp, jcfg,
                                         {"tokens": jnp.asarray(toks)},
                                         return_caches=True)
    got, aux, tcache = ttf.forward(model, {"tokens": torch.from_numpy(toks)},
                                   return_caches=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert (float(aux) > 0) == (tcfg.moe is not None)
    for layer, slot in zip(tcache["layers"], ttf.layer_slots(tcfg)):
        ref = jcache["layers"][slot.group][slot.key]
        for a, b in zip(layer, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b[slot.repeat]),
                                       **TOL)
    # explicit positions take _sdpa_masked: the same logits and aux
    pos = torch.arange(16).expand(2, 16)
    alt, alt_aux = ttf.forward(model, {"tokens": torch.from_numpy(toks),
                                       "positions": pos})
    np.testing.assert_allclose(alt.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(alt_aux), float(want_aux), **TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """At the configs' own capacity (1.25): a decode step of 2 tokens has
    one slot an expert, so routings drop there as in the reference."""
    jcfg, tcfg, jp, model = _models(arch, seed=2)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    _, _, jc = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :6])},
                           return_caches=True)
    jc = jax_extend_cache(jcfg, jc, 6, 12)
    _, tc = tsteps.make_prefill_step(tcfg)(
        model, {"tokens": torch.from_numpy(toks[:, :6])})
    tc = tsteps.extend_cache(tcfg, tc, 6, 12)
    assert all(t.shape[1] == 12 for layer in tc["layers"] for t in layer)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(6, 10):
        want, jc = jtf.decode_step(jp, jcfg, jc, {
            "tokens": jnp.asarray(toks[:, i:i + 1]),
            "cache_pos": jnp.int32(i)})
        got, tc = decode(model, tc, {"tokens": torch.from_numpy(
            toks[:, i:i + 1]), "cache_pos": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_make_cache_holds_the_latents():
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    layers = ttf.make_cache(cfg, 3, 20, "cpu")["layers"]
    m = cfg.mla
    assert len(layers) == cfg.n_layers
    for c, r in layers:
        assert c.shape == (3, 20, m.kv_lora_rank) and c.dtype == cfg.cdtype
        assert r.shape == (3, 20, m.rope_head_dim)
        assert not c.any() and not r.any()
    jc = jtf.init_cache(jax_get_config("deepseek-v2-lite-16b", reduced=True),
                        3, 20)
    assert [tuple(a.shape[1:]) for g in jc for v in g.values() for a in v] \
        == [tuple(a.shape) for layer in layers for a in layer]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward_suffix(arch):
    """Decode against teacher-forced forward logits, as
    ``tests/test_archs.py`` holds the reference, at capacity factor 16 (no
    drops: capacity depends on the batch, so 8 teacher-forced tokens can
    collide where one decode token cannot)."""
    _, tcfg, _, model = _models(arch, seed=1, capacity_factor=16.0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (1, 8)).astype(np.int32))
    full, _ = ttf.forward(model, {"tokens": toks})
    _, _, caches = ttf.forward(model, {"tokens": toks[:, :4]},
                               return_caches=True)
    cache = tsteps.extend_cache(tcfg, caches, 4, 8)
    for i in range(4, 8):
        logits, cache = ttf.decode_step(model, cache, {
            "tokens": toks[:, i:i + 1], "cache_pos": i})
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, i].numpy(),
                                   **TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_is_seeded(arch):
    cfg = get_config(arch, reduced=True)
    a, b = (dict(ttf.init_params(cfg, 5, "cpu").named_parameters())
            for _ in range(2))
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    want = jtf.count_params(jtf.init_params(jax_get_config(arch, True),
                                            jax.random.PRNGKey(0)))
    assert sum(t.numel() for t in a.values()) == want
