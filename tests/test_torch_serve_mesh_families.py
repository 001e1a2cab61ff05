"""Serving over the port's Mesh for the last five families on the CPU
against the JAX package's sharded steps on 8 host devices: the meshed
prefill, ``extend_cache`` and four meshed decode steps of reduced
deepseek-v2-lite-16b (MLA's latent cache and absorbed decode,
``_moe_a2a``), xlstm-1.3b (the mLSTM and sLSTM states), recurrentgemma-9b
(the RG-LRU state beside windowed ``local_attn`` with one KV head),
qwen2-vl-2b (embedding inputs, an image grid in ``positions3``) and
whisper-small (the encoder, the cross-attention cache; an encoder of 11
frames, and of ``S_MAX``), each at (data 4, model 2) and (2, 2), and
under the batch fallback: batch 1 on (4, 2), the attention caches'
sequence over (data, model) in eight blocks of two.

The reference runs in one subprocess (``XLA_FLAGS`` set before jax
starts) from the port's initial weights (``params_to_arrays``, keyed by
``tree_path_str``): its ``make_prefill_step`` and ``make_decode_step``
bound to its activation rules and jitted with the cells' ``in_shardings``
(``shard_params(..., fsdp=False)``, ``batch_specs``, ``cache_specs``) and
``out_shardings``.  xlstm's prompts are 8 tokens, a multiple of its
reduced chunk (the reference's mLSTM asserts it; the port raises
``ValueError``).  recurrentgemma's reduced window equals ``S_MAX`` and
would mask nothing, so both packages run it at a window of 4 (the same
``dataclasses.replace``), which masks inside the prompt and across the
decode cache's blocks.  qwen2-vl's decode steps pass the grid's
``positions3`` at (4, 2) and (2, 2) and take the default (``cache_pos``
on all three grids) under the fallback.

Tolerances: 1e-5 (float32; sums in another order), logits and caches,
but the mLSTM's state against the reference's at 2e-5, the float32
tolerance ``tests/test_torch_ssm.py`` holds the mLSTM block to (its chunk
sums run through ``exp`` of gates up to ``e^5``: 1.4e-5 apart on one
element of 4,096 under the fallback); greedy tokens exactly.  The meshed
steps are held to the port's unmeshed ones too, at 1e-5 with equal
greedy tokens; deepseek runs that comparison at a capacity factor of
``n_experts / top_k``, where neither ``_moe_a2a``'s per-shard capacity
nor the unmeshed global one drops a routing (ROADMAP.md §3 item 6).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.sharding import (ShardedTensor, activation_rules,
                                       bind_activation_rules, shard_params,
                                       shard_tree, shardings_from_specs,
                                       tree_flatten_with_path, tree_path_str,
                                       tree_unflatten)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve import steps as tsteps

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# variant -> (arch, recurrentgemma's window or None, whisper's frames)
VARIANTS = {"deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", None, 0),
            "xlstm-1.3b": ("xlstm-1.3b", None, 0),
            "recurrentgemma-9b": ("recurrentgemma-9b", 4, 0),
            "qwen2-vl-2b": ("qwen2-vl-2b", None, 0),
            "whisper-small": ("whisper-small", None, 11),
            "whisper-small-senc16": ("whisper-small", None, 16)}
# (mesh shape, batch, prompt length; xlstm's prompt is 8 in every case)
CASES = {"4x2": ((4, 2), 8, 6), "2x2": ((2, 2), 4, 6),
         "fallback": ((4, 2), 1, 12)}
S_MAX, N_DECODE, XLSTM_PROMPT = 16, 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)
MLSTM_TOL = dict(rtol=2e-5, atol=2e-5)   # test_torch_ssm.py's F32_TOL


def _cfg(variant, cfg=None):
    """The variant's reduced config (recurrentgemma at its test window)."""
    arch, window, _ = VARIANTS[variant]
    cfg = cfg or get_config(arch, reduced=True)
    if window is not None:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, attn_window=window))
    return cfg


def _prompt(variant, case):
    return XLSTM_PROMPT if variant.startswith("xlstm") else CASES[case][2]


def _inputs(cfg, batch: int, frames: int, seed: int = 3) -> dict:
    """``S_MAX`` positions of the model's input kind as numpy arrays:
    ``tokens``; qwen2-vl's ``embeds`` and ``positions3`` laid out as text,
    a 2 x 3 image grid, text (shifted back by 3); whisper's
    ``enc_embeds`` of ``frames`` beside the tokens."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind != "tokens":
        p3 = np.broadcast_to(np.arange(S_MAX, dtype=np.int32),
                             (3, batch, S_MAX)).copy()
        p3[1, :, 2:8] = 2 + np.arange(6) // 3
        p3[2, :, 2:8] = 2 + np.arange(6) % 3
        p3[:, :, 8:] -= 3
        return {"embeds": rng.normal(size=(batch, S_MAX, cfg.d_model))
                .astype(np.float32), "positions3": p3}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, S_MAX))
           .astype(np.int32)}
    if frames:
        out["enc_embeds"] = rng.normal(size=(batch, frames, cfg.d_model)
                                       ).astype(np.float32)
    return out


def _prefill_batch(inputs, prompt):
    return {k: v if k == "enc_embeds" else
            (v[:, :, :prompt] if k == "positions3" else v[:, :prompt])
            for k, v in inputs.items()}


def _decode_batch(inputs, i, case):
    """Position ``i``'s decode batch: its token or embedding, and (but
    under the fallback) its ``positions3``."""
    out = {k: v[:, i:i + 1] for k, v in inputs.items()
           if k in ("tokens", "embeds")}
    if "positions3" in inputs and case != "fallback":
        out["positions3"] = inputs["positions3"][:, :, i:i + 1]
    return out


_REFERENCE = r"""
import dataclasses, os, sys
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

tmp, variants, cases = sys.argv[1], {variants!r}, {cases!r}
s_max, n_decode, xlstm_prompt = {s_max!r}, {n_decode!r}, {xlstm_prompt!r}
out = {{}}

def flat(tree, into, prefix):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        into[f"{{prefix}}/{{tree_path_str(kp)}}"] = np.asarray(v)

def sharded(batch, mesh):
    return shardings_from_specs(batch_specs({{
        k: jax.ShapeDtypeStruct(np.shape(v), jnp.asarray(v).dtype)
        for k, v in batch.items()}}, mesh), mesh)

for variant, (arch, window, frames) in variants.items():
    cfg = get_config(arch, reduced=True)
    if window is not None:
        cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, attn_window=window))
    init = np.load(os.path.join(tmp, f"init_{{arch}}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jtf.init_params(cfg, jax.random.PRNGKey(0))))
    for case, (shape, batch, prompt) in cases.items():
        if arch.startswith("xlstm"):
            prompt = xlstm_prompt
        inputs = dict(np.load(os.path.join(tmp,
                                           f"inputs_{{variant}}_{{case}}.npz")))
        mesh = make_mesh(shape, ("data", "model"))
        key = f"{{variant}}/{{case}}"
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
        pb = {{k: jnp.asarray(v if k == "enc_embeds" else
                             (v[:, :, :prompt] if k == "positions3"
                              else v[:, :prompt]))
              for k, v in inputs.items()}}
        with mesh:
            params = jax.device_put(params, psh)
            logits, cache = jax.jit(pre, in_shardings=(psh, sharded(pb,
                                                                     mesh)))(
                params, pb)
            out[f"{{key}}/prefill/logits"] = np.asarray(logits)
            flat(cache["layers"], out, f"{{key}}/prefill/cache")
            if cache["enc_out"] is not None:
                out[f"{{key}}/prefill/enc_out"] = np.asarray(cache["enc_out"])
            cache = extend_cache(cfg, cache, prompt, s_max)
            csh = {{"layers": jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                cache_specs(cache["layers"], mesh, seq_len=s_max,
                            batch=batch),
                is_leaf=lambda x: isinstance(x, P)),
                "enc_out": NamedSharding(mesh, P())}}
            cache = jax.device_put(cache, csh)
            step = None
            for i in range(prompt, prompt + n_decode):
                db = {{k: jnp.asarray(v[:, i:i + 1]) for k, v in
                      inputs.items() if k in ("tokens", "embeds")}}
                if "positions3" in inputs and case != "fallback":
                    db["positions3"] = jnp.asarray(
                        inputs["positions3"][:, :, i:i + 1])
                db["cache_pos"] = jnp.int32(i)
                if step is None:
                    step = jax.jit(dec, in_shardings=(psh, csh,
                                                      sharded(db, mesh)),
                                   out_shardings=(None, csh))
                logits, cache = step(params, cache, db)
                out[f"{{key}}/decode{{i}}/logits"] = np.asarray(logits)
            flat(cache["layers"], out, f"{{key}}/decode/cache")
np.savez(os.path.join(tmp, "reference.npz"), **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's initial weights and inputs for each variant, then the
    reference's sharded steps on them (one subprocess)."""
    tmp = tmp_path_factory.mktemp("serve_mesh_families")
    for variant, (arch, _, frames) in VARIANTS.items():
        cfg = _cfg(variant)
        if not (tmp / f"init_{arch}.npz").exists():
            model = ttf.init_params(cfg, seed=0, device="cpu")
            np.savez(tmp / f"init_{arch}.npz",
                     **{tree_path_str(kp): np.asarray(v) for kp, v in
                        tree_flatten_with_path(ttf.params_to_arrays(
                            model))[0]})
        for case, (_, batch, _) in CASES.items():
            np.savez(tmp / f"inputs_{variant}_{case}.npz",
                     **_inputs(cfg, batch, frames))
    code = _REFERENCE.format(variants=VARIANTS, cases=CASES, s_max=S_MAX,
                             n_decode=N_DECODE, xlstm_prompt=XLSTM_PROMPT)
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


def _whole(layers):
    return [[t.unshard() if isinstance(t, ShardedTensor) else t.clone()
             for t in layer] for layer in layers]


def _run(cfg, pre, dec, params, inputs, prompt, case):
    """The prefill, ``extend_cache`` and ``N_DECODE`` decode steps:
    ``[(prefill logits, prefill cache, enc_out), (logits, cache, None) a
    decode step]``, the logits as the steps return them, the caches
    whole."""
    logits, cache = pre(params, _prefill_batch(inputs, prompt))
    enc = cache["enc_out"]
    out = [(logits, _whole(cache["layers"]),
            enc.unshard() if isinstance(enc, ShardedTensor) else enc)]
    cache = tsteps.extend_cache(cfg, cache, prompt, S_MAX)
    for i in range(prompt, prompt + N_DECODE):
        logits, cache = dec(params, cache, dict(
            _decode_batch(inputs, i, case), cache_pos=i))
        out.append((logits, _whole(cache["layers"]), None))
    return out


def _port(tmp, variant, case, cfg=None):
    """The variant's config, a CPU mesh of the case, the reference's tree
    of the initial weights and the case's inputs as tensors."""
    cfg = _cfg(variant, cfg)
    shape = CASES[case][0]
    init = np.load(tmp / f"init_{VARIANTS[variant][0]}.npz")
    template = ttf.params_to_arrays(ttf.init_params(cfg, seed=0,
                                                    device="cpu"))
    flat, treedef = tree_flatten_with_path(template)
    tree = tree_unflatten(treedef, [init[tree_path_str(kp)]
                                    for kp, _ in flat])
    inputs = {k: torch.from_numpy(v) for k, v in
              np.load(tmp / f"inputs_{variant}_{case}.npz").items()}
    return cfg, _mesh(shape), tree, inputs


def _meshed(tmp, variant, case, cfg=None):
    cfg, mesh, tree, inputs = _port(tmp, variant, case, cfg)
    batch = CASES[case][1]
    return cfg, tree, _run(cfg, *_steps(cfg, mesh, batch),
                           _sharded(cfg, mesh, tree), inputs,
                           _prompt(variant, case), case)


def _hold_cache(cfg, got, ref, prefix):
    for layer, slot in zip(got, ttf.layer_slots(cfg)):
        for j, t in enumerate(layer):
            want = ref[f"{prefix}/{slot.group}/{slot.key}/{j}"][slot.repeat]
            np.testing.assert_allclose(
                t.float().numpy(), want.astype(np.float32),
                **(MLSTM_TOL if slot.kind == "mlstm" else TOL),
                err_msg=f"{prefix} {slot} {j}")


def _greedy(logits):
    return np.argmax(logits[:, -1], axis=-1)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_meshed_prefill_matches_reference(world, variant, case):
    """The meshed prefill's logits, every cache tensor (K/V, MLA's latent
    and rotary key, the recurrent states, the cross K/V) and ``enc_out``,
    whole, against the reference's jitted prefill with the cell's
    ``in_shardings``; the greedy tokens equal."""
    tmp, ref = world
    cfg, mesh, tree, inputs = _port(tmp, variant, case)
    pre, _ = _steps(cfg, mesh, CASES[case][1])
    logits, cache = pre(_sharded(cfg, mesh, tree),
                        _prefill_batch(inputs, _prompt(variant, case)))
    key = f"{variant}/{case}"
    got = logits.unshard().numpy()
    np.testing.assert_allclose(got, ref[f"{key}/prefill/logits"], **TOL)
    assert np.array_equal(_greedy(got), _greedy(ref[f"{key}/prefill/logits"]))
    _hold_cache(cfg, _whole(cache["layers"]), ref, f"{key}/prefill/cache")
    if cfg.enc_dec:
        np.testing.assert_allclose(cache["enc_out"].unshard().numpy(),
                                   ref[f"{key}/prefill/enc_out"], **TOL)
    else:
        assert cache["enc_out"] is None


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_meshed_decode_matches_reference(world, variant, case):
    """``extend_cache`` and four meshed decode steps: each step's logits,
    its greedy tokens, and the final cache, whole, against the
    reference's jitted decode with the cell's ``in_shardings`` and
    ``out_shardings``."""
    tmp, ref = world
    cfg, _, got = _meshed(tmp, variant, case)
    key = f"{variant}/{case}"
    prompt = _prompt(variant, case)
    for i, (logits, _, _) in zip(range(prompt, prompt + N_DECODE), got[1:]):
        want = ref[f"{key}/decode{i}/logits"]
        np.testing.assert_allclose(logits.unshard().numpy(), want, **TOL,
                                   err_msg=f"{key} position {i}")
        assert np.array_equal(_greedy(logits.unshard().numpy()),
                              _greedy(want)), i
    _hold_cache(cfg, got[-1][1], ref, f"{key}/decode/cache")


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_meshed_steps_match_unmeshed(world, variant, case):
    """The meshed steps against the port's unmeshed ones on the same
    weights: logits, caches and ``enc_out`` within 1e-5, greedy tokens
    equal (``sample_greedy`` takes the meshed logits as the steps return
    them)."""
    tmp, _ = world
    cfg = get_config(VARIANTS[variant][0], reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    cfg, tree, got = _meshed(tmp, variant, case, cfg)
    _, _, _, inputs = _port(tmp, variant, case)
    model = ttf.params_from_arrays(cfg, tree, "cpu")
    want = _run(cfg, tsteps.make_prefill_step(cfg),
                tsteps.make_decode_step(cfg), model, inputs,
                _prompt(variant, case), case)
    for step, ((gl, gc, ge), (wl, wc, we)) in enumerate(zip(got, want)):
        assert isinstance(gl, ShardedTensor)
        np.testing.assert_allclose(gl.unshard().numpy(), wl.numpy(), **TOL,
                                   err_msg=f"step {step}")
        assert torch.equal(tsteps.sample_greedy(gl),
                           tsteps.sample_greedy(wl)), step
        for gt, wt in zip(gc, wc):
            for a, b in zip(gt, wt):
                np.testing.assert_allclose(a.float().numpy(),
                                           b.float().numpy(), **TOL)
        if we is not None:
            np.testing.assert_allclose(ge.numpy(), we.numpy(), **TOL)


@pytest.mark.parametrize("case", ["4x2", "fallback"])
def test_decode_cache_is_laid_out_by_kind(world, case):
    """After ``extend_cache`` every layer's cache has ``cache_specs``'
    layout: MLA's (B, S_max, r) latent and rotary key sequence-sharded
    like K/V (over ``model``, or (data, model) under the fallback), the
    recurrent states batch-only, whisper's cross K/V batch-only at the
    encoder's length (11 frames, never padded), its self K/V padded;
    ``enc_out`` carried with its batch over ``data``."""
    tmp, _ = world
    seq = "model" if case == "4x2" else ("data", "model")
    batch = "data" if case == "4x2" else None
    for variant in ("deepseek-v2-lite-16b", "xlstm-1.3b",
                    "recurrentgemma-9b", "whisper-small"):
        cfg, mesh, tree, inputs = _port(tmp, variant, case)
        pre, _ = _steps(cfg, mesh, CASES[case][1])
        prompt = _prompt(variant, case)
        _, cache = pre(_sharded(cfg, mesh, tree),
                       _prefill_batch(inputs, prompt))
        got = tsteps.extend_cache(cfg, cache, prompt, S_MAX)
        assert got["enc_out"] is cache["enc_out"]
        for layer, slot in zip(got["layers"], ttf.layer_slots(cfg)):
            for j, t in enumerate(layer):
                spec = tuple(t.spec) + (None,) * (len(t.shape) - len(t.spec))
                sequence = ttf.is_attention(slot.kind) and j < 2
                assert spec[0] == batch, (variant, slot, j)
                assert spec[1] == (seq if sequence else None), (slot, j)
                assert all(a is None for a in spec[2:]), (slot, j)
                if sequence:
                    assert t.shape[1] == S_MAX
                if slot.kind == "dec_attn_mlp" and j >= 2:
                    assert t.shape[1] == VARIANTS[variant][2]
        if cfg.enc_dec:
            assert tuple(got["enc_out"].spec)[0] == batch


@pytest.mark.parametrize("variant,want", [
    ("deepseek-v2-lite-16b", None), ("recurrentgemma-9b", None),
    ("xlstm-1.3b", 0), ("qwen2-vl-2b", None), ("whisper-small", None)])
def test_meshed_prefill_takes_the_flash_route(world, variant, want,
                                              monkeypatch):
    """Without ``positions`` the meshed prefill runs ``_flash_prefill``
    once a self-attention layer (whisper's encoder's too) and (data,
    model) entry: each layer's query heads split over ``model`` here, so
    8 calls a layer at (4, 2); never for xlstm, which has no attention;
    whisper's cross-attention stays ``_sdpa_masked``."""
    tmp, _ = world
    cfg, mesh, tree, inputs = _port(tmp, variant, "4x2")
    calls = []
    real = tattn._flash_prefill
    monkeypatch.setattr(tattn, "_flash_prefill", lambda *a, **k: (
        calls.append(a[0].shape), real(*a, **k))[1])
    pre, _ = _steps(cfg, mesh, 8)
    pre(_sharded(cfg, mesh, tree),
        _prefill_batch(inputs, _prompt(variant, "4x2")))
    layers = sum(ttf.is_attention(s.kind) for s in ttf.layer_slots(cfg))
    assert len(calls) == (layers * 8 if want is None else want)
    assert all(shape[0] == 2 and shape[2] == cfg.n_heads // 2
               for shape in calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_serves_over_a_mesh(arch):
    """``make_prefill_step``, ``extend_cache`` and ``make_decode_step`` of
    every reduced architecture over a (data 2, model 2) mesh of CPU
    entries, on 4 rows of its input kind, against the unmeshed steps on
    the same weights: logits within 1e-5 (deepseek and granite-moe at a
    capacity factor of ``n_experts / top_k``), greedy tokens equal."""
    cfg = get_config(arch, reduced=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = ttf.init_params(cfg, seed=0, device="cpu")
    mesh = _mesh((2, 2))
    params = _sharded(cfg, mesh, ttf.params_to_arrays(model))
    inputs = {k: torch.from_numpy(v) for k, v in
              _inputs(cfg, 4, 9 if cfg.enc_dec else 0, seed=5).items()}
    got = _run(cfg, *_steps(cfg, mesh, 4), params, inputs, 8, "2x2")
    want = _run(cfg, tsteps.make_prefill_step(cfg),
                tsteps.make_decode_step(cfg), model, inputs, 8, "2x2")
    for (gl, _, _), (wl, _, _) in zip(got, want):
        np.testing.assert_allclose(gl.unshard().numpy(), wl.numpy(), **TOL)
        assert torch.equal(tsteps.sample_greedy(gl),
                           tsteps.sample_greedy(wl))
