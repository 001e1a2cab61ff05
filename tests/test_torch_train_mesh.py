"""The sharded trainer on a CPU mesh against the JAX package's on 8 host
devices: one meshed step of reduced qwen3-0.6b, gemma3-1b (its single KV
head misaligned at tp = 2) and granite-moe-1b-a400m (``_moe_a2a``) at
(data 4, model 2) and (2, 2); the split of each microbatch over the data
entries; the elastic re-mesh case of ``tests/test_system.py``
(``test_elastic_remesh_restore``: train on (4, 2) with a checkpoint at
every step, restore onto (2, 2), keep training) across both packages;
and the architectures a mesh refused, which now train on one
(``tests/test_torch_train_mesh_families.py`` holds their meshed steps).

The reference runs in one subprocess (``XLA_FLAGS`` set before jax
starts), from the port's initial weights and checkpoints, so that both
packages start from the same state.  Tolerances: loss and gradient norm
1e-5 relative; weights and first moments as ``tests/test_torch_train.py``
holds the unmeshed step (the median absolute difference <= 1e-7, the
99.9th percentile <= 1e-6); checkpoints bit for bit.
"""
import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.dist.sharding import (activation_rules,
                                       bind_activation_rules, shard_tree,
                                       shardings_from_specs,
                                       tree_flatten_with_path, tree_path_str,
                                       tree_unflatten, unshard_tree)
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-0.6b", "gemma3-1b", "granite-moe-1b-a400m"]
SHAPES = [(4, 2), (2, 2)]
# the families a mesh refused before their meshed forward was ported
REFUSED = ["deepseek-v2-lite-16b", "xlstm-1.3b", "recurrentgemma-9b",
           "qwen2-vl-2b", "whisper-small"]
BATCH, SEQ, N_MICRO = 8, 17, 2
REMESH = dict(global_batch=4, seq_len=16, log_every=1)


def _tokens(cfg, seed=10):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)


def _flat(tree):
    return {tree_path_str(kp): np.asarray(leaf)
            for kp, leaf in tree_flatten_with_path(tree)[0]}


def _opt():
    return topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import contextlib, io
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.checkpoint import Checkpointer
from repro.configs import get_config
from repro.dist.sharding import (activation_rules, batch_specs,
                                 bind_activation_rules, shard_params,
                                 shardings_from_specs, tree_path_str)
from repro.launch.mesh import make_mesh
from repro.launch.train import TrainJob, run
from repro.train import optimizer as jopt, train_step as jts

tmp, archs, shapes, remesh = sys.argv[1], {archs!r}, {shapes!r}, {remesh!r}
out = {{}}

def flat(tree):
    return {{tree_path_str(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}}

def from_flat(template, arrays):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(arrays[tree_path_str(kp)]) for kp, _ in leaves])

def state_shardings(cfg, mesh, params):
    pspecs, _ = shard_params(params, mesh, fsdp=True,
                             heads={{"q": cfg.n_heads, "kv": cfg.n_kv_heads}})
    return shardings_from_specs(jts.TrainState(params=pspecs, opt=(
        jopt.AdamWState(step=P(), m=pspecs, v=pspecs))), mesh)

for arch in archs:
    cfg = get_config(arch, reduced=True)
    init = np.load(os.path.join(tmp, f"init_{{arch}}.npz"))
    toks = np.load(os.path.join(tmp, f"tokens_{{arch}}.npy"))
    for shape in shapes:
        mesh = make_mesh(shape, ("data", "model"))
        opt = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
        step = bind_activation_rules(jts.make_train_step(
            cfg, opt, n_micro={n_micro}, micro_batch_axes=("data",)),
            activation_rules(cfg, mesh))
        with mesh:
            params = from_flat(jax.eval_shape(lambda: jts.init_train_state(
                cfg, opt, jax.random.PRNGKey(0)).params), init)
            state = jts.TrainState(params=params, opt=opt.init(params))
            ssh = state_shardings(cfg, mesh, params)
            state = jax.device_put(state, ssh)
            bsh = shardings_from_specs(batch_specs({{"tokens":
                jax.ShapeDtypeStruct(toks.shape, jnp.int32)}}, mesh), mesh)
            new, m = jax.jit(step, in_shardings=(ssh, bsh),
                             out_shardings=(ssh, None))(
                state, {{"tokens": jnp.asarray(toks)}})
        key = f"{{arch}}_{{shape[0]}}x{{shape[1]}}"
        for k, v in m.items():
            out[f"{{key}}/metric/{{k}}"] = np.asarray(v)
        for k, v in flat(new.params).items():
            out[f"{{key}}/params/{{k}}"] = v
        for k, v in flat(new.opt.m).items():
            out[f"{{key}}/m/{{k}}"] = v

# the elastic re-mesh case, from the port's seed checkpoint
cfg = get_config("qwen3-0.6b", reduced=True)
ckpt_dir = os.path.join(tmp, "j")
with contextlib.redirect_stdout(io.StringIO()):
    out1 = run(TrainJob(cfg=cfg, steps=3, ckpt_dir=ckpt_dir, ckpt_every=1,
                        mesh_shape=(4, 2), **remesh), restore=True)
    out2 = run(TrainJob(cfg=cfg, steps=6, ckpt_dir=ckpt_dir,
                        ckpt_every=10_000, mesh_shape=(2, 2), **remesh),
               restore=True)
for k in ("step", "loss", "grad_norm"):
    out[f"remesh/{{k}}"] = np.array([h[k] for h in
                                     out1["history"] + out2["history"]])

# the port's (4, 2) checkpoint restored onto the reference's (2, 2)
mesh = make_mesh((2, 2), ("data", "model"))
opt = jopt.AdamW(lr=jopt.warmup_cosine(3e-4, 20, 3))
with mesh:
    template = jax.eval_shape(lambda: jts.init_train_state(
        cfg, opt, jax.random.PRNGKey(0)))
    restored, meta = Checkpointer(os.path.join(tmp, "t")).restore(
        template, step=2, shardings=state_shardings(cfg, mesh,
                                                    template.params))
assert meta["step"] == 2, meta
for k, v in flat(restored).items():
    out[f"port_ckpt/{{k}}"] = v
    assert len(restored.params["embed"]["table"].sharding.device_set) == 4
np.savez(os.path.join(tmp, "reference.npz"), **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's initial weights and tokens for each architecture, a seed
    checkpoint of reduced qwen3 in ``t`` and ``j``, the port's (4, 2) run
    from it in ``t``; then the reference's steps, its re-mesh run in ``j``
    and its restore of the port's step-2 checkpoint."""
    tmp = tmp_path_factory.mktemp("mesh")
    for arch in ARCHS:
        cfg = get_config(arch, reduced=True)
        state = tts.init_train_state(cfg, _opt(), seed=0, device="cpu")
        np.savez(tmp / f"init_{arch}.npz",
                 **_flat(tts.train_state_to_arrays(state).params))
        np.save(tmp / f"tokens_{arch}.npy", _tokens(cfg))
    cfg = get_config("qwen3-0.6b", reduced=True)
    seed = tts.train_state_to_arrays(tts.init_train_state(
        cfg, _opt(), seed=1, device="cpu"))
    Checkpointer(str(tmp / "t")).save(-1, seed, metadata={"step": -1})
    shutil.copytree(tmp / "t", tmp / "j")
    first = _quiet(tlaunch.run, tlaunch.TrainJob(
        cfg=cfg, steps=3, ckpt_dir=str(tmp / "t"), ckpt_every=1,
        mesh_shape=(4, 2), device="cpu", **REMESH), restore=True)
    code = _REFERENCE.format(archs=ARCHS, shapes=SHAPES, remesh=REMESH,
                             n_micro=N_MICRO)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(tmp)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return tmp, dict(np.load(tmp / "reference.npz")), first


def _hold_weights(got, want, what):
    """``tests/test_torch_train.py``'s weight tolerance: the median
    absolute difference <= 1e-7, the 99.9th percentile <= 1e-6."""
    assert sorted(got) == sorted(want), what
    d = np.concatenate([np.abs(got[k].astype(np.float64)
                               - want[k].astype(np.float64)).ravel()
                        for k in sorted(got)])
    assert np.median(d) <= 1e-7, f"{what}: median {np.median(d)}"
    assert np.quantile(d, 0.999) <= 1e-6, \
        f"{what}: 99.9th percentile {np.quantile(d, 0.999)}"


def _bits_equal(a, b) -> bool:
    return np.array_equal(np.atleast_1d(a).view(np.uint8),
                          np.atleast_1d(b).view(np.uint8))


def _meshed_state(cfg, shape, init):
    """The port's state from the initial weights, sharded on a CPU mesh
    of ``shape``."""
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))
    template = tts.train_state_template(cfg)
    flat, treedef = tree_flatten_with_path(template.params)
    params = tree_unflatten(treedef, [init[tree_path_str(kp)]
                                      for kp, _ in flat])
    zeros = tree_unflatten(treedef, [np.zeros(a.shape, np.float32)
                                     for _, a in flat])
    state = tts.TrainState(params=params, opt=topt.AdamWState(
        step=np.zeros((), np.int32), m=zeros, v=zeros))
    specs, _ = tts.train_state_specs(cfg, mesh)
    return mesh, shard_tree(state, shardings_from_specs(specs, mesh))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_step_matches_reference(world, arch, shape):
    """One step in 2 microbatches of 8 x 17 tokens: loss, gradient norm,
    lr and the MoE aux loss 1e-5 relative; the new weights and first
    moments as the unmeshed step's."""
    tmp, ref, _ = world
    cfg = get_config(arch, reduced=True)
    key = f"{arch}_{shape[0]}x{shape[1]}"
    mesh, state = _meshed_state(cfg, shape, np.load(tmp / f"init_{arch}.npz"))
    opt = _opt()
    step = bind_activation_rules(tts.make_train_step(
        cfg, opt, n_micro=N_MICRO, micro_batch_axes=("data",)),
        activation_rules(cfg, mesh))
    state, metrics = step(state, {"tokens": torch.from_numpy(
        np.load(tmp / f"tokens_{arch}.npy"))})
    for k in ("loss", "grad_norm", "lr", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]),
                                   float(ref[f"{key}/metric/{k}"]),
                                   rtol=1e-5, err_msg=k)
    assert (float(metrics["aux_loss"]) > 0) == (cfg.moe is not None)
    arrays = tts.train_state_to_arrays(state)
    for part, tree in (("params", arrays.params), ("m", arrays.opt.m)):
        want = {k.split("/", 2)[2]: v for k, v in ref.items()
                if k.startswith(f"{key}/{part}/")}
        _hold_weights(_flat(tree), want, f"{key} {part}")


@pytest.mark.parametrize("batch,n_micro,shape", [
    (8, 2, (4, 2)), (8, 2, (2, 2)), (16, 4, (2, 2)), (8, 1, (4, 2)),
    (12, 3, (2, 1))])
def test_each_data_entry_takes_its_share_of_the_microbatch(
        monkeypatch, batch, n_micro, shape):
    """Each data entry's microbatch is ``B / (n_micro · dp)`` rows, its
    own block of the microbatch, never the whole microbatch (the
    reference's "16x FLOP inflation")."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    mesh = make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * int(np.prod(shape)))
    state = tts.shard_train_state(tts.init_train_state(
        cfg, _opt(), seed=0, device="cpu"), mesh)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, 9)).astype(np.int32))
    seen = []
    real = tts.forward_meshed

    def spy(params, cfg_, plan, batches):
        seen.append([b["tokens"] for b in batches])
        return real(params, cfg_, plan, batches)

    monkeypatch.setattr(tts, "forward_meshed", spy)
    tts.make_train_step(cfg, _opt(), n_micro=n_micro,
                        micro_batch_axes=("data",))(state, {"tokens": toks})
    dp = shape[0]
    rows = batch // (n_micro * dp)
    assert len(seen) == n_micro
    for i, parts in enumerate(seen):
        assert [tuple(p.shape) for p in parts] == [(rows, 8)] * dp
        whole = torch.cat(parts)
        assert torch.equal(whole, toks[i * rows * dp:(i + 1) * rows * dp,
                                       :-1])


def test_remesh_run_matches_reference(world):
    """``test_elastic_remesh_restore``'s cycle: 3 steps on (4, 2) with a
    checkpoint at every step, then ``run(restore=True)`` on (2, 2) to 6
    steps.  The port's per-step losses and gradient norms equal the
    reference's within 1e-5 relative across the boundary."""
    tmp, ref, first = world
    cfg = get_config("qwen3-0.6b", reduced=True)
    second = _quiet(tlaunch.run, tlaunch.TrainJob(
        cfg=cfg, steps=6, ckpt_dir=str(tmp / "t"), ckpt_every=10_000,
        mesh_shape=(2, 2), device="cpu", **REMESH), restore=True)
    hist = first["history"] + second["history"]
    assert [h["step"] for h in hist] == list(ref["remesh/step"]) \
        == list(range(6))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in hist], ref[f"remesh/{k}"],
                                   rtol=1e-5, err_msg=k)
    mesh = second["state"].params["embed"]["table"].sharding.mesh
    assert dict(mesh.shape) == {"data": 2, "model": 2}


def test_reference_checkpoint_restores_in_the_port_remeshed(world):
    """The reference's step-2 checkpoint, written on (4, 2), restores onto
    the port's (2, 2) shardings and onto no mesh, bit for bit."""
    tmp, _, _ = world
    cfg = get_config("qwen3-0.6b", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    ssh = shardings_from_specs(tts.train_state_specs(cfg, mesh)[0], mesh)
    ckpt = Checkpointer(str(tmp / "j"))
    template = tts.train_state_template(cfg)
    sharded, meta = ckpt.restore(template, step=2, shardings=ssh)
    plain, _ = ckpt.restore(template, step=2)
    latest, _, at = ckpt.restore_latest_valid(template, shardings=ssh)
    assert meta["step"] == 2 and at == 5
    files = {name[:-4]: np.load(tmp / "j" / "step_0000000002" / name)
             for name in os.listdir(tmp / "j" / "step_0000000002")
             if name.endswith(".npy")}
    got = _flat(unshard_tree(sharded))
    assert {k.replace("/", "__") for k in got} == set(files)
    for k, v in got.items():
        want = files[k.replace("/", "__")]
        assert v.dtype == want.dtype and _bits_equal(v, want), k
        assert np.array_equal(_flat(plain)[k], want), k
    table = sharded.params["embed"]["table"]
    assert len(table.blocks) == 4 and dict(
        table.sharding.mesh.shape) == {"data": 2, "model": 2}
    assert _flat(unshard_tree(latest)).keys() == got.keys()


def test_port_checkpoint_restores_in_the_reference_remeshed(world):
    """The port's step-2 checkpoint, written on (4, 2), restores onto the
    reference's (2, 2) shardings bit for bit."""
    tmp, ref, _ = world
    d = tmp / "t" / "step_0000000002"
    want = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("port_ckpt/")}
    assert {k.replace("/", "__") + ".npy" for k in want} == \
        {n for n in os.listdir(d) if n.endswith(".npy")}
    for k, v in want.items():
        mine = np.load(d / (k.replace("/", "__") + ".npy"))
        assert v.dtype == mine.dtype and _bits_equal(v, mine), k


@pytest.mark.parametrize("arch", REFUSED)
def test_meshed_entry_points_train_the_other_families(arch, tmp_path):
    """MLA, the recurrent blocks, the vision-language and the
    encoder-decoder models, which raised under a mesh until their meshed
    forward was ported, train on one: the accepted call (the launcher for
    a token decoder, one ``make_train_step(micro_batch_axes=)`` step for
    qwen2-vl and whisper) gives the reference's losses and gradient norms
    within 1e-5 relative (``tests/test_torch_train_mesh_families.py``'s
    :func:`accepted_against_reference`)."""
    from test_torch_train_mesh_families import accepted_against_reference

    for got, want in accepted_against_reference(arch, tmp_path):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=arch)


def test_a_meshed_job_without_a_card_raises(monkeypatch):
    """No fallback: with no card and no ``device="cpu"`` the meshed job
    raises instead of training on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.run(tlaunch.TrainJob(cfg=cfg, mesh_shape=(2, 2), steps=1))


def test_meshed_step_takes_a_sharded_state():
    cfg = get_config("qwen3-0.6b", reduced=True)
    step = tts.make_train_step(cfg, _opt(), micro_batch_axes=("data",))
    state = tts.init_train_state(cfg, _opt(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="sharded over a mesh"):
        step(state, {"tokens": torch.zeros((4, 9), dtype=torch.int32)})


@pytest.mark.parametrize("arch,shape,axes", [
    ("glm4-9b", (2, 2), ("data", "model")),
    ("granite-34b", (2, 2), ("data", "model")),
    ("qwen3-0.6b", (2, 2, 2), ("pod", "data", "model")),
    ("gemma3-1b", (4, 1), ("data", "model")),
    ("gemma3-1b", (1, 8), ("data", "model")),
    ("granite-moe-1b-a400m", (4, 1), ("data", "model"))])
def test_meshed_launcher_run_equals_the_unmeshed_run(tmp_path, arch, shape,
                                                     axes):
    """``TrainJob(mesh_shape=...)`` of the other decoder-only models, a
    (pod, data, model) mesh, a model axis of 1 (the MoE then takes the
    global-capacity dispatch, as the unmeshed step) and one of 8 (gemma3's
    4 query heads misaligned: row-parallel ``wq``, the attention whole,
    ``wo`` column-parallel and gathered): the same losses and
    gradient norms as the unmeshed run within 1e-5 relative, the final
    weights within 1e-6."""
    cfg = get_config(arch, reduced=True)
    kw = dict(cfg=cfg, steps=2, global_batch=8, seq_len=8, n_micro=2,
              log_every=1, device="cpu")
    meshed = _quiet(tlaunch.run, tlaunch.TrainJob(mesh_shape=shape, **kw))
    plain = _quiet(tlaunch.run, tlaunch.TrainJob(**kw))
    mesh = meshed["state"].params["embed"]["table"].sharding.mesh
    assert mesh.axis_names == axes
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[k] for h in meshed["history"]],
                                   [h[k] for h in plain["history"]],
                                   rtol=1e-5, err_msg=k)
    got = _flat(tts.train_state_to_arrays(meshed["state"]).params)
    want = _flat(tts.train_state_to_arrays(plain["state"]).params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_meshed_remat_gives_the_gradients_of_none(remat):
    """The meshed forward keeps the per-block activation checkpointing:
    under ``full`` and ``dots`` (each block's weights gathered again in
    the recompute) the step equals the one without, exactly."""
    import dataclasses

    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    toks = torch.from_numpy(_tokens(cfg))
    got = []
    for policy in ("none", remat):
        c = dataclasses.replace(cfg, remat=policy)
        state = tts.shard_train_state(tts.init_train_state(
            c, _opt(), seed=0, device="cpu"), mesh)
        step = bind_activation_rules(tts.make_train_step(
            c, _opt(), n_micro=2, micro_batch_axes=("data",)),
            activation_rules(c, mesh))
        state, m = step(state, {"tokens": toks})
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    _flat(tts.train_state_to_arrays(state).params)))
    (l0, g0, p0), (l1, g1, p1) = got
    assert (l0, g0) == (l1, g1)
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k
