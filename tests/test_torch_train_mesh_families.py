"""The meshed forward of every family against the JAX package's on 8 host
devices: one meshed step of reduced deepseek-v2-lite-16b (MLA,
``_moe_a2a``), xlstm-1.3b (mLSTM, sLSTM), recurrentgemma-9b (RG-LRU,
windowed attention, one KV head), qwen2-vl-2b (embedding inputs, an image
grid in ``positions3``) and whisper-small (an encoder of another length
than the decoder, cross-attention) at (data 4, model 2) and (2, 2); the
launcher's meshed runs against its unmeshed ones, remat, a deepseek
checkpoint across packages and meshes, and one meshed step of every
architecture.

The reference runs in one subprocess (``XLA_FLAGS`` set before jax
starts), from the port's initial weights, so that both packages start
from the same state.  Tolerances: loss, gradient norm and MoE aux loss
1e-5 relative; weights and first moments as ``tests/test_torch_train.py``
holds the unmeshed step (the median absolute difference <= 1e-7, the
99.9th percentile <= 1e-6); checkpoints bit for bit.

:func:`accepted_against_reference` is the accepted call of each family
under a mesh against the reference's unmeshed call in this process, for
the cases of ``tests/test_torch_train_mesh.py`` and
``tests/test_torch_signatures.py`` that held the refusals.
"""
import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.sharding import (activation_rules,
                                       bind_activation_rules, shard_tree,
                                       shardings_from_specs,
                                       tree_flatten_with_path, tree_path_str,
                                       tree_unflatten)
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["deepseek-v2-lite-16b", "xlstm-1.3b", "recurrentgemma-9b",
            "qwen2-vl-2b", "whisper-small"]
SHAPES = [(4, 2), (2, 2)]
BATCH, SEQ, ENC_SEQ, N_MICRO = 8, 17, 11, 2
CKPT_ARCH = "deepseek-v2-lite-16b"
CKPT = dict(steps=2, global_batch=8, seq_len=16, n_micro=2, log_every=1)


def family_batch(cfg, seed: int = 10, batch: int = BATCH, seq: int = SEQ):
    """A batch of ``cfg``'s input kind as numpy arrays: ``tokens`` (B, S);
    whisper's ``enc_embeds`` (B, ``ENC_SEQ``, d) beside them; qwen2-vl's
    ``embeds`` and ``labels`` of S - 1 positions with ``positions3`` laid
    out as text, a 2 x 3 image grid, text."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind != "tokens":
        s = seq - 1
        p3 = np.broadcast_to(np.arange(s, dtype=np.int32),
                             (3, batch, s)).copy()
        p3[1, :, 2:8] = 2 + np.arange(6) // 3
        p3[2, :, 2:8] = 2 + np.arange(6) % 3
        p3[:, :, 8:] -= 3
        return {"embeds": rng.normal(size=(batch, s, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (batch, s)).astype(
                    np.int32),
                "positions3": p3}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)}
    if cfg.enc_dec:
        out["enc_embeds"] = rng.normal(
            size=(batch, ENC_SEQ, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _flat(tree):
    return {tree_path_str(kp): np.asarray(leaf)
            for kp, leaf in tree_flatten_with_path(tree)[0]}


def _opt():
    return topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def _meshed_step(cfg, mesh, n_micro: int = N_MICRO):
    return bind_activation_rules(tts.make_train_step(
        cfg, _opt(), n_micro=n_micro, micro_batch_axes=("data",)),
        activation_rules(cfg, mesh))


def _cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def accepted_against_reference(arch: str, tmp_path):
    """The accepted meshed call of ``arch`` against the reference's
    unmeshed call on the same weights, in this process: a token decoder
    through both launchers (a (2, 2) mesh in the port; deepseek's at (1,
    2), where the MoE takes the global-capacity dispatch as one device
    does, while MLA splits its heads), 2 steps from the reference's
    initial state written as a step -1 checkpoint; qwen2-vl and whisper
    through one ``make_train_step(micro_batch_axes=("data",))`` step on
    their own batches against the reference's jitted step.  Returns pairs
    (port, reference) of losses and gradient norms, to hold within 1e-5
    relative."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_config as jax_get_config
    from repro.launch import train as jlaunch
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts

    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    shape = (1, 2) if cfg.moe is not None else (2, 2)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    jstate = jts.init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    if cfg.input_kind == "tokens" and not cfg.enc_dec:
        for d in ("j", "t"):
            JCheckpointer(str(tmp_path / d)).save(-1, jstate,
                                                  metadata={"step": -1})
        kw = dict(steps=2, global_batch=4, seq_len=16, n_micro=2, lr=1e-3,
                  warmup=2, ckpt_every=10_000, log_every=1)
        want = _quiet(jlaunch.run, jlaunch.TrainJob(
            cfg=jcfg, ckpt_dir=str(tmp_path / "j"), **kw), restore=True)
        got = _quiet(tlaunch.run, tlaunch.TrainJob(
            cfg=cfg, ckpt_dir=str(tmp_path / "t"), mesh_shape=shape,
            device="cpu", **kw), restore=True)
        mesh = got["state"].params["embed"]["table"].sharding.mesh
        assert tuple(mesh.devices.shape) == shape
        return [(g[k], w[k]) for g, w in zip(got["history"], want["history"])
                for k in ("loss", "grad_norm")]
    batch = family_batch(cfg, seed=7, batch=4, seq=13)
    _, jm = jax.jit(jts.make_train_step(jcfg, jo, n_micro=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = _cpu_mesh(shape)
    state = tts.shard_train_state(tts.train_state_from_arrays(
        cfg, jax.tree.map(np.asarray, jstate), "cpu"), mesh)
    _, tm = _meshed_step(cfg, mesh)(state, _torch(batch))
    return [(float(tm[k]), float(jm[k])) for k in ("loss", "grad_norm")]


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.checkpoint import Checkpointer
from repro.configs import get_config
from repro.dist.sharding import (activation_rules, batch_specs,
                                 bind_activation_rules, shard_params,
                                 shardings_from_specs, tree_path_str)
from repro.launch.mesh import make_mesh
from repro.train import optimizer as jopt, train_step as jts

tmp, archs, shapes = sys.argv[1], {archs!r}, {shapes!r}
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
    batch = {{k: jnp.asarray(v) for k, v in
             np.load(os.path.join(tmp, f"batch_{{arch}}.npz")).items()}}
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
            bsh = shardings_from_specs(batch_specs({{
                k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in batch.items()}}, mesh), mesh)
            new, m = jax.jit(step, in_shardings=(ssh, bsh),
                             out_shardings=(ssh, None))(state, batch)
        key = f"{{arch}}_{{shape[0]}}x{{shape[1]}}"
        for k, v in m.items():
            out[f"{{key}}/metric/{{k}}"] = np.asarray(v)
        for k, v in flat(new.params).items():
            out[f"{{key}}/params/{{k}}"] = v
        for k, v in flat(new.opt.m).items():
            out[f"{{key}}/m/{{k}}"] = v

# the port's (4, 2) checkpoint of {ckpt_arch} restored onto (2, 2)
cfg = get_config({ckpt_arch!r}, reduced=True)
mesh = make_mesh((2, 2), ("data", "model"))
opt = jopt.AdamW(lr=jopt.warmup_cosine(3e-4, 20, 2))
with mesh:
    template = jax.eval_shape(lambda: jts.init_train_state(
        cfg, opt, jax.random.PRNGKey(0)))
    restored, meta = Checkpointer(os.path.join(tmp, "ckpt")).restore(
        template, step=1, shardings=state_shardings(cfg, mesh,
                                                    template.params))
assert meta["step"] == 1, meta
assert len(restored.params["embed"]["table"].sharding.device_set) == 4
for k, v in flat(restored).items():
    out[f"port_ckpt/{{k}}"] = v
np.savez(os.path.join(tmp, "reference.npz"), **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's initial weights and batch for each family, its (4, 2)
    launcher run of reduced deepseek with a checkpoint at every step; then
    the reference's meshed steps and its restore of the port's step-1
    checkpoint onto (2, 2)."""
    tmp = tmp_path_factory.mktemp("families")
    for arch in FAMILIES:
        cfg = get_config(arch, reduced=True)
        state = tts.init_train_state(cfg, _opt(), seed=0, device="cpu")
        np.savez(tmp / f"init_{arch}.npz",
                 **_flat(tts.train_state_to_arrays(state).params))
        np.savez(tmp / f"batch_{arch}.npz", **family_batch(cfg))
    _quiet(tlaunch.run, tlaunch.TrainJob(
        cfg=get_config(CKPT_ARCH, reduced=True), ckpt_dir=str(tmp / "ckpt"),
        ckpt_every=1, mesh_shape=(4, 2), device="cpu", **CKPT))
    code = _REFERENCE.format(archs=FAMILIES, shapes=SHAPES, n_micro=N_MICRO,
                             ckpt_arch=CKPT_ARCH)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(tmp)],
                         capture_output=True, text=True, env=env,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    return tmp, dict(np.load(tmp / "reference.npz"))


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


def _meshed_state(cfg, shape, init):
    """The port's state from the initial weights, sharded on a CPU mesh
    of ``shape``."""
    mesh = _cpu_mesh(shape)
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


def _port_step(tmp, arch, shape):
    cfg = get_config(arch, reduced=True)
    mesh, state = _meshed_state(cfg, shape,
                                np.load(tmp / f"init_{arch}.npz"))
    batch = dict(np.load(tmp / f"batch_{arch}.npz"))
    return _meshed_step(cfg, mesh)(state, _torch(batch))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_meshed_step_matches_reference(world, arch, shape):
    """One step in 2 microbatches of 8 rows: loss, gradient norm, lr and
    the MoE aux loss 1e-5 relative; the new weights and first moments as
    the unmeshed step's."""
    tmp, ref = world
    cfg = get_config(arch, reduced=True)
    key = f"{arch}_{shape[0]}x{shape[1]}"
    state, metrics = _port_step(tmp, arch, shape)
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


def test_deepseek_meshes_drop_as_the_references(world):
    """``_moe_a2a``'s per-shard capacity drops other routings at (4, 2)
    than at (2, 2) (ROADMAP.md §3 item 6): the two meshes' losses differ,
    and by the reference's difference."""
    tmp, ref = world
    arch = "deepseek-v2-lite-16b"
    got = {s: float(_port_step(tmp, arch, s)[1]["loss"]) for s in SHAPES}
    want = {s: float(ref[f"{arch}_{s[0]}x{s[1]}/metric/loss"])
            for s in SHAPES}
    (a, b), (c, d) = (got[s] for s in SHAPES), (want[s] for s in SHAPES)
    assert a != b and c != d
    assert abs((a - b) - (c - d)) <= 1e-5 * abs(c)
    assert np.sign(a - b) == np.sign(c - d)


def test_port_checkpoint_restores_in_the_reference_remeshed(world):
    """The port's step-1 checkpoint of reduced deepseek, written on (4,
    2), restores onto the reference's (2, 2) shardings bit for bit."""
    tmp, ref = world
    d = tmp / "ckpt" / "step_0000000001"
    want = {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith("port_ckpt/")}
    assert {k.replace("/", "__") + ".npy" for k in want} == \
        {n for n in os.listdir(d) if n.endswith(".npy")}
    for k, v in want.items():
        mine = np.load(d / (k.replace("/", "__") + ".npy"))
        assert v.dtype == mine.dtype and np.array_equal(
            np.atleast_1d(v).view(np.uint8),
            np.atleast_1d(mine).view(np.uint8)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_takes_a_meshed_step(arch):
    """One ``make_train_step(micro_batch_axes=("data",))`` step of every
    reduced architecture on a CPU (4, 2) mesh, on a batch of its input
    kind: finite loss and gradient norm, the state still sharded."""
    cfg = get_config(arch, reduced=True)
    mesh = _cpu_mesh((4, 2))
    state = tts.shard_train_state(tts.init_train_state(
        cfg, _opt(), seed=0, device="cpu"), mesh)
    state, m = _meshed_step(cfg, mesh)(state, _torch(family_batch(cfg)))
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert (float(m["aux_loss"]) > 0) == (cfg.moe is not None)
    assert len(state.params["embed"]["table"].distinct()) == 8


@pytest.mark.parametrize("arch,shape,axes", [
    ("xlstm-1.3b", (4, 2), ("data", "model")),
    ("recurrentgemma-9b", (4, 2), ("data", "model")),
    ("recurrentgemma-9b", (2, 2, 2), ("pod", "data", "model")),
    ("recurrentgemma-9b", (1, 8), ("data", "model")),
    ("deepseek-v2-lite-16b", (1, 8), ("data", "model"))])
def test_meshed_launcher_run_equals_the_unmeshed_run(arch, shape, axes):
    """``TrainJob(mesh_shape=...)`` of the recurrent families, a (pod,
    data, model) mesh and a model axis of 8, which misaligns
    recurrentgemma's single KV head and MLA's 4 reduced heads (the whole
    MLA once a data entry; with one data entry deepseek's MoE takes the
    global-capacity dispatch, as the unmeshed step): the same losses and
    gradient norms as the unmeshed run within 1e-5 relative, the final
    weights as :func:`_hold_weights` holds them, none further apart than
    the two steps' AdamW updates could move them (2 · the summed lr).

    The weights are not held to 1e-6 everywhere: a data entry's weight
    gradients sum over its own rows, so they round otherwise than the
    unmeshed microbatch's, and AdamW's first update of an element whose
    two gradients nearly cancel in the first moment amplifies that
    rounding (xlstm at (4, 2): one element of ``mlstm_0/w_up`` 1.2e-6
    apart; the reference's own meshed and unmeshed runs of this job come
    up to 4.5e-7 apart on seeds 0-2)."""
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
    _hold_weights(got, want, f"{arch} {shape}")
    moved = 2 * sum(h["lr"] for h in plain["history"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=moved, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small"])
def test_meshed_remat_gives_the_gradients_of_none(arch, remat):
    """The recurrent blocks, the encoder and the cross-attention under
    ``full`` and ``dots`` (each block's weights gathered again in the
    recompute): the step equals the one without, exactly."""
    cfg = get_config(arch, reduced=True)
    mesh = _cpu_mesh((2, 2))
    batch = _torch(family_batch(cfg))
    got = []
    for policy in ("none", remat):
        c = dataclasses.replace(cfg, remat=policy)
        state = tts.shard_train_state(tts.init_train_state(
            c, _opt(), seed=0, device="cpu"), mesh)
        state, m = _meshed_step(c, mesh)(state, batch)
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    _flat(tts.train_state_to_arrays(state).params)))
    (l0, g0, p0), (l1, g1, p1) = got
    assert (l0, g0) == (l1, g1)
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k


def test_meshed_batches_keep_their_kinds(monkeypatch):
    """Each data entry's forward takes its own rows of every input:
    qwen2-vl's ``embeds`` and ``positions3`` (split on axis 1), its labels
    cut to the logits' length, explicit ``positions`` ``arange(S)``."""
    cfg = get_config("qwen2-vl-2b", reduced=True)
    mesh = _cpu_mesh((2, 2))
    state = tts.shard_train_state(tts.init_train_state(
        cfg, _opt(), seed=0, device="cpu"), mesh)
    batch = _torch(family_batch(cfg))
    seen = []
    real = tts.forward_meshed

    def spy(params, cfg_, plan, batches):
        seen.append(batches)
        return real(params, cfg_, plan, batches)

    monkeypatch.setattr(tts, "forward_meshed", spy)
    _meshed_step(cfg, mesh)(state, batch)
    rows = BATCH // (N_MICRO * 2)
    assert len(seen) == N_MICRO
    for i, parts in enumerate(seen):
        for d, part in enumerate(parts):
            lo = (i * 2 + d) * rows
            assert torch.equal(part["embeds"],
                               batch["embeds"][lo:lo + rows])
            assert torch.equal(part["positions3"],
                               batch["positions3"][:, lo:lo + rows])
            s = batch["embeds"].shape[1]
            assert torch.equal(part["positions"],
                               torch.arange(s).expand(rows, s))


def test_a_mesh_over_several_devices_raises_naming_item_5():
    """The one refusal left under a mesh: entries on more than one device
    wait for the transport between cards (ROADMAP.md §1 item 5).  A mesh
    of two cards cannot be made without them, so a CPU mesh's entries are
    renamed after its state is laid out."""
    cfg = get_config("xlstm-1.3b", reduced=True)
    mesh = _cpu_mesh((2, 2))
    state = tts.shard_train_state(tts.init_train_state(
        cfg, _opt(), seed=0, device="cpu"), mesh)
    mesh.devices = np.array([torch.device("cuda", i) for i in range(4)],
                            dtype=object).reshape(2, 2)
    with pytest.raises(NotImplementedError, match=r"item 5\)"):
        _meshed_step(cfg, mesh)(state, _torch(family_batch(cfg)))
