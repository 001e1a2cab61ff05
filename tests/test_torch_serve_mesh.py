"""Serving over the port's Mesh on the CPU against the JAX package's
sharded steps on 8 host devices: the meshed prefill, ``extend_cache`` and
four meshed decode steps of reduced qwen3-0.6b, gemma3-1b (its local
window of 8 crossing the cache's blocks), glm4-9b and granite-34b (one KV
head, whole on every model entry) and granite-moe-1b-a400m (``_moe_a2a``
by shard; ``_moe_global`` under the batch fallback), each at (data 4,
model 2) and (2, 2), and under the fallback: batch 1 on (4, 2), the
cache's sequence over (data, model) in eight blocks of two.

The reference runs in one subprocess (``XLA_FLAGS`` set before jax
starts) from the port's initial weights: its ``make_prefill_step`` and
``make_decode_step`` bound to its activation rules and jitted with the
cells' ``in_shardings`` (``shard_params(..., fsdp=False)``,
``batch_specs``, ``cache_specs``) and ``out_shardings``.  Decode runs at
positions 6-9 of a 16-slot cache (8 is the first slot of the last block
over ``model``) and, under the fallback, at 12-15 (12 and 14 each the
first slot of a block, 14-15 the last block).

Tolerances: 1e-5 (float32; sums in another order), logits and caches;
greedy tokens exactly.  The meshed steps are held to the port's unmeshed
ones too, at 1e-5 with equal greedy tokens.  Where granite-moe's meshed
step takes ``_moe_a2a`` its per-shard capacity drops other routings than
the unmeshed step's global capacity (ROADMAP.md §3 item 6, the
reference's drops, held above), so that comparison runs at a capacity
factor of ``n_experts / top_k``, where neither path drops a routing.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist.sharding import (ShardedTensor, activation_rules,
                                       bind_activation_rules, shard_params,
                                       shard_tree, shardings_from_specs,
                                       tree_flatten_with_path, tree_path_str,
                                       tree_unflatten)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serve import steps as tsteps

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-0.6b", "gemma3-1b", "glm4-9b", "granite-34b",
         "granite-moe-1b-a400m"]
# (mesh shape, batch, prompt length); the cache holds S_MAX slots and
# decode runs N_DECODE steps from the prompt's end
CASES = {"4x2": ((4, 2), 8, 6), "2x2": ((2, 2), 4, 6),
         "fallback": ((4, 2), 1, 12)}
S_MAX, N_DECODE = 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _tokens(cfg, batch, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, S_MAX)).astype(np.int32)


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.dist.sharding import (activation_rules, batch_specs,
                                 bind_activation_rules, cache_specs,
                                 shard_params, shardings_from_specs,
                                 tree_path_str)
from repro.launch.mesh import make_mesh
from repro.models import transformer as jtf
from repro.serve.steps import extend_cache, make_decode_step, make_prefill_step

tmp, archs, cases = sys.argv[1], {archs!r}, {cases!r}
s_max, n_decode = {s_max!r}, {n_decode!r}
out = {{}}

def flat(tree, into, prefix):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        into[f"{{prefix}}/{{tree_path_str(kp)}}"] = np.asarray(v)

def sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)

for arch in archs:
    cfg = get_config(arch, reduced=True)
    init = np.load(os.path.join(tmp, f"init_{{arch}}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0))))
    for case, (shape, batch, prompt) in cases.items():
        toks = np.load(os.path.join(tmp, f"tokens_{{arch}}_{{case}}.npy"))
        mesh = make_mesh(shape, ("data", "model"))
        key = f"{{arch}}/{{case}}"
        params = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(init[tree_path_str(kp)]) for kp, _ in leaves])
        pspecs, _ = shard_params(params, mesh, fsdp=False,
                                 heads={{"q": cfg.n_heads,
                                        "kv": cfg.n_kv_heads}})
        psh = shardings_from_specs(pspecs, mesh)
        pre = bind_activation_rules(make_prefill_step(cfg), activation_rules(
            cfg, mesh, batch=batch))
        dec = bind_activation_rules(make_decode_step(cfg), activation_rules(
            cfg, mesh, decode=True, batch=batch))
        bsh = shardings_from_specs(batch_specs(
            {{"tokens": sds((batch, prompt), jnp.int32)}}, mesh), mesh)
        dsh = shardings_from_specs(batch_specs(
            {{"tokens": sds((batch, 1), jnp.int32),
              "cache_pos": sds((), jnp.int32)}}, mesh), mesh)
        with mesh:
            params = jax.device_put(params, psh)
            logits, cache = jax.jit(pre, in_shardings=(psh, bsh))(
                params, {{"tokens": jnp.asarray(toks[:, :prompt])}})
            out[f"{{key}}/prefill/logits"] = np.asarray(logits)
            flat(cache["layers"], out, f"{{key}}/prefill/cache")
            cache = extend_cache(cfg, cache, prompt, s_max)
            csh = {{"layers": jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                cache_specs(cache["layers"], mesh, seq_len=s_max,
                            batch=batch),
                is_leaf=lambda x: isinstance(x, P)),
                "enc_out": NamedSharding(mesh, P())}}
            step = jax.jit(dec, in_shardings=(psh, csh, dsh),
                           out_shardings=(None, csh))
            cache = jax.device_put(cache, csh)
            for i in range(prompt, prompt + n_decode):
                logits, cache = step(params, cache, {{
                    "tokens": jnp.asarray(toks[:, i:i + 1]),
                    "cache_pos": jnp.int32(i)}})
                out[f"{{key}}/decode{{i}}/logits"] = np.asarray(logits)
            flat(cache["layers"], out, f"{{key}}/decode/cache")
np.savez(os.path.join(tmp, "reference.npz"), **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's initial weights and tokens for each architecture, then
    the reference's sharded steps on them (one subprocess)."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        model = ttf.init_params(cfg, seed=0, device="cpu")
        np.savez(tmp / f"init_{arch}.npz",
                 **{tree_path_str(kp): np.asarray(v) for kp, v in
                    tree_flatten_with_path(ttf.params_to_arrays(model))[0]})
        for case, (_, batch, _) in CASES.items():
            np.save(tmp / f"tokens_{arch}_{case}.npy", _tokens(cfg, batch))
    code = _REFERENCE.format(archs=ARCHS, cases=CASES, s_max=S_MAX,
                             n_decode=N_DECODE)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(tmp)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return tmp, dict(np.load(tmp / "reference.npz"))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))


def _sharded(cfg, mesh, tree):
    """The reference's parameter tree laid out for serving
    (``shard_params(..., fsdp=False)``)."""
    specs, _ = shard_params(tree, mesh, fsdp=False,
                            heads={"q": cfg.n_heads, "kv": cfg.n_kv_heads})
    return shard_tree(tree, shardings_from_specs(specs, mesh))


def _steps(cfg, mesh, batch):
    return (bind_activation_rules(tsteps.make_prefill_step(cfg),
                                  activation_rules(cfg, mesh, batch=batch)),
            bind_activation_rules(tsteps.make_decode_step(cfg),
                                  activation_rules(cfg, mesh, decode=True,
                                                   batch=batch)))


def _serve(cfg, params, mesh, toks, prompt, s_max=S_MAX):
    """The meshed prefill, extend_cache and N_DECODE decode steps:
    ``[(prefill logits, prefill cache), (logits, cache) a decode step]``,
    the logits as the steps return them, the caches whole."""
    pre, dec = _steps(cfg, mesh, toks.shape[0])
    logits, cache = pre(params, {"tokens": toks[:, :prompt]})
    out = [(logits, [[t.unshard() for t in layer]
                     for layer in cache["layers"]])]
    cache = tsteps.extend_cache(cfg, cache, prompt, s_max)
    for i in range(prompt, prompt + N_DECODE):
        logits, cache = dec(params, cache, {"tokens": toks[:, i:i + 1],
                                            "cache_pos": i})
        out.append((logits, [[t.unshard() for t in layer]
                             for layer in cache["layers"]]))
    return out


def _serve_unmeshed(cfg, model, toks, prompt, s_max=S_MAX):
    logits, cache = tsteps.make_prefill_step(cfg)(
        model, {"tokens": toks[:, :prompt]})
    out = [(logits, cache["layers"])]
    cache = tsteps.extend_cache(cfg, cache, prompt, s_max)
    decode = tsteps.make_decode_step(cfg)
    for i in range(prompt, prompt + N_DECODE):
        logits, cache = decode(model, cache, {"tokens": toks[:, i:i + 1],
                                              "cache_pos": i})
        out.append((logits, [[t.clone() for t in layer]
                             for layer in cache["layers"]]))
    return out


def _port(tmp, arch, case, cfg=None):
    cfg = cfg or get_config(arch, reduced=True)
    shape, batch, prompt = CASES[case]
    init = np.load(tmp / f"init_{arch}.npz")
    template = ttf.params_to_arrays(ttf.init_params(cfg, seed=0,
                                                    device="cpu"))
    flat, treedef = tree_flatten_with_path(template)
    tree = tree_unflatten(treedef, [init[tree_path_str(kp)]
                                    for kp, _ in flat])
    mesh = _mesh(shape)
    toks = torch.from_numpy(np.load(tmp / f"tokens_{arch}_{case}.npy"))
    return cfg, mesh, tree, toks, prompt


def _hold_cache(cfg, got, ref, prefix):
    for layer, slot in zip(got, ttf.layer_slots(cfg)):
        for j, t in enumerate(layer):
            want = ref[f"{prefix}/{slot.group}/{slot.key}/{j}"][slot.repeat]
            np.testing.assert_allclose(t.numpy(), want, **TOL,
                                       err_msg=f"{prefix} {slot} {j}")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_prefill_matches_reference(world, arch, case):
    """The meshed prefill's logits and its cache, whole, against the
    reference's jitted prefill with the cell's ``in_shardings``."""
    tmp, ref = world
    cfg, mesh, tree, toks, prompt = _port(tmp, arch, case)
    pre, _ = _steps(cfg, mesh, toks.shape[0])
    logits, cache = pre(_sharded(cfg, mesh, tree),
                        {"tokens": toks[:, :prompt]})
    key = f"{arch}/{case}"
    np.testing.assert_allclose(logits.unshard().numpy(),
                               ref[f"{key}/prefill/logits"], **TOL)
    _hold_cache(cfg, [[t.unshard() for t in layer]
                      for layer in cache["layers"]], ref,
                f"{key}/prefill/cache")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_decode_matches_reference(world, arch, case):
    """Four meshed decode steps after ``extend_cache``: each step's logits
    and the final cache, whole, against the reference's jitted decode
    with the cell's ``in_shardings`` and ``out_shardings``; the cache's
    layout is ``cache_specs``'."""
    tmp, ref = world
    cfg, mesh, tree, toks, prompt = _port(tmp, arch, case)
    got = _serve(cfg, _sharded(cfg, mesh, tree), mesh, toks, prompt)
    key = f"{arch}/{case}"
    np.testing.assert_allclose(got[0][0].unshard().numpy(),
                               ref[f"{key}/prefill/logits"], **TOL)
    for i, (logits, _) in zip(range(prompt, prompt + N_DECODE), got[1:]):
        np.testing.assert_allclose(logits.unshard().numpy(),
                                   ref[f"{key}/decode{i}/logits"], **TOL,
                                   err_msg=f"{key} position {i}")
    _hold_cache(cfg, got[-1][1], ref, f"{key}/decode/cache")


# batch 1 on (4, 2) with a cache that does not split 8 ways: (prompt,
# slots, the cache's sequence entry)
UNEVEN = {"uneven": (9, 14, "model"), "whole": (9, 13, None)}


@pytest.mark.parametrize("case", list(CASES) + list(UNEVEN))
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_steps_match_unmeshed(world, arch, case):
    """The meshed steps against the port's unmeshed ones on the same
    weights: logits and caches within 1e-5, greedy tokens equal.
    ``uneven``: batch 1 on (4, 2), a 9-token prompt and 14 slots, which
    do not split into 8 blocks, so the sequence goes over ``model`` alone
    (two blocks of 7); ``whole``: 13 slots, which split over nothing, so
    each entry holds the whole cache (``extend_cache`` gathers split KV
    heads).  ``sample_greedy`` takes the meshed logits as the steps
    return them."""
    tmp, _ = world
    base = "fallback" if case in UNEVEN else case
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None and case in ("4x2", "2x2"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    cfg, mesh, tree, toks, prompt = _port(tmp, arch, base, cfg)
    model = ttf.params_from_arrays(cfg, tree, "cpu")
    s_max = S_MAX
    if case in UNEVEN:
        prompt, s_max, seq = UNEVEN[case]
        layer = tsteps.extend_cache(cfg, _steps(cfg, mesh, 1)[0](
            _sharded(cfg, mesh, tree), {"tokens": toks[:, :prompt]})[1],
            prompt, s_max)["layers"][0]
        assert tuple(layer[0].spec) == (None, seq, None, None)
    got = _serve(cfg, _sharded(cfg, mesh, tree), mesh, toks, prompt, s_max)
    want = _serve_unmeshed(cfg, model, toks, prompt, s_max)
    for step, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
        assert isinstance(gl, ShardedTensor)
        np.testing.assert_allclose(gl.unshard().numpy(), wl.numpy(), **TOL,
                                   err_msg=f"step {step}")
        assert torch.equal(tsteps.sample_greedy(gl),
                           tsteps.sample_greedy(wl)), step
        for gt, wt in zip(gc, wc):
            for a, b in zip(gt, wt):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_a_wholly_masked_block_weighs_nothing():
    """A cache block wholly past ``cache_pos`` (or outside the window):
    its largest score is near ``NEG_INF``, which is finite, so its weight
    ``exp(m_j - M)`` underflows to 0 and the combine gives no NaN; the
    result is the softmax over the unmasked block alone."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 2, 2, 8, generator=gen)
    k = torch.randn(2, 8, 2, 8, generator=gen)
    v = torch.randn(2, 8, 2, 8, generator=gen)
    mesh = _mesh((1, 2))
    parts = [tattn._decode_partial(q, k[:, :4], v[:, :4], 0, 2, -1,
                                   torch.float32),
             tattn._decode_partial(q, k[:, 4:], v[:, 4:], 4, 2, -1,
                                   torch.float32)]
    big, tot, acc = tattn._lse_combine(mesh, ("model",), parts)
    assert float(torch.exp(parts[1][0] - big).max()) == 0.0
    assert torch.isfinite(acc / tot).all()
    alone = parts[0][2] / parts[0][1]
    np.testing.assert_allclose((acc / tot).numpy(), alone.numpy(), **TOL)
    # a window of 2 at position 6 masks the first block wholly too
    parts = [tattn._decode_partial(q, k[:, :4], v[:, :4], 0, 6, 2,
                                   torch.float32),
             tattn._decode_partial(q, k[:, 4:], v[:, 4:], 4, 6, 2,
                                   torch.float32)]
    big, tot, acc = tattn._lse_combine(mesh, ("model",), parts)
    assert float(torch.exp(parts[0][0] - big).max()) == 0.0
    np.testing.assert_allclose((acc / tot).numpy(),
                               (parts[1][2] / parts[1][1]).numpy(), **TOL)


@pytest.mark.parametrize("case", ["4x2", "fallback"])
def test_moe_decode_dispatch_follows_the_bound_batch_rule(world, case,
                                                          monkeypatch):
    """granite-moe's meshed decode takes ``_moe_a2a`` where the batch rule
    splits the batch over ``data`` (the reference's condition) and
    ``_moe_global`` under the fallback (batch rule ``None``, the
    reference's GSPMD path), never the refusal for axes that differ."""
    tmp, _ = world
    arch = "granite-moe-1b-a400m"
    cfg, mesh, tree, toks, prompt = _port(tmp, arch, case)
    taken = []
    for name in ("_moe_a2a", "_moe_global"):
        fn = getattr(tmoe, name)
        monkeypatch.setattr(tmoe, name, lambda *a, _f=fn, _n=name, **k: (
            taken.append(_n), _f(*a, **k))[1])
    pre, dec = _steps(cfg, mesh, toks.shape[0])
    params = _sharded(cfg, mesh, tree)
    _, cache = pre(params, {"tokens": toks[:, :prompt]})
    cache = tsteps.extend_cache(cfg, cache, prompt, S_MAX)
    taken.clear()
    dec(params, cache, {"tokens": toks[:, prompt:prompt + 1],
                        "cache_pos": prompt})
    want = "_moe_a2a" if case == "4x2" else "_moe_global"
    assert taken == [want] * cfg.n_layers


@pytest.mark.parametrize("case", ["4x2", "fallback"])
def test_extend_cache_moves_each_layer_by_one_all_to_all(world, case):
    """qwen3's aligned KV heads go from prefill's layout (heads over
    ``model``) to decode's (sequence over ``model``) by one ``all_to_all``
    over ``model`` a tensor and a row of model entries (4 rows at (4,
    2)); gemma3's one KV head is whole on every entry, so its blocks are
    sliced, with no collective."""
    tmp, _ = world
    for arch, per_tensor in (("qwen3-0.6b", 4), ("gemma3-1b", 0)):
        cfg, mesh, tree, toks, prompt = _port(tmp, arch, case)
        pre, _ = _steps(cfg, mesh, toks.shape[0])
        _, cache = pre(_sharded(cfg, mesh, tree),
                       {"tokens": toks[:, :prompt]})
        heads = "model" if per_tensor else None
        assert all(t.spec[2] == heads for layer in cache["layers"]
                   for t in layer)
        seen = []
        with tmesh.recording(lambda name, m, axis, rows: seen.append(
                (name, axis))):
            got = tsteps.extend_cache(cfg, cache, prompt, S_MAX)
        assert seen == [("all_to_all", "model")] * (
            per_tensor * 2 * cfg.n_layers)
        seq = "model" if case == "4x2" else ("data", "model")
        for layer in got["layers"]:
            for t in layer:
                assert t.shape[1] == S_MAX and t.spec[1] == seq


def test_a_later_family_refuses_naming_item_12():
    """deepseek's MLA waits for item 12.2: its meshed prefill raises."""
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    mesh = _mesh((2, 2))
    tree = ttf.params_to_arrays(ttf.init_params(cfg, seed=0, device="cpu"))
    pre, _ = _steps(cfg, mesh, 2)
    with pytest.raises(NotImplementedError, match="item 12"):
        pre(_sharded(cfg, mesh, tree),
            {"tokens": torch.zeros((2, 4), dtype=torch.int32)})


@pytest.mark.parametrize("case", ["4x2", "fallback"])
def test_unbound_steps_take_the_cells_rules(world, case):
    """Steps given a sharded tree with no rules bound (the reference's
    steps run unbound too) take the rules the cells bind,
    ``activation_rules(cfg, mesh, decode=..., batch=B)``: the same logits
    as the bound steps."""
    tmp, _ = world
    cfg, mesh, tree, toks, prompt = _port(tmp, "qwen3-0.6b", case)
    params = _sharded(cfg, mesh, tree)
    bound = _serve(cfg, params, mesh, toks, prompt)
    logits, cache = tsteps.make_prefill_step(cfg)(
        params, {"tokens": toks[:, :prompt]})
    got = [logits]
    cache = tsteps.extend_cache(cfg, cache, prompt, S_MAX)
    for i in range(prompt, prompt + N_DECODE):
        logits, cache = tsteps.make_decode_step(cfg)(
            params, cache, {"tokens": toks[:, i:i + 1], "cache_pos": i})
        got.append(logits)
    for g, (w, _) in zip(got, bound):
        assert torch.equal(g.unshard(), w.unshard())
