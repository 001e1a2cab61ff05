"""The port's checkpointer on the CPU, and checkpoints across the two
packages: tree paths in jax's flatten order, the reference's layout,
manifest and digests, atomic saves, ``keep``, verification and the
fall-back to an older step.

A ``TrainState`` written by either package restores in the other bit for
bit (``np.array_equal`` on every leaf, same dtype), and the two manifests
agree in leaf names, shapes, dtypes and ``sha256``.  Reduced qwen3-0.6b,
and reduced deepseek-v2-lite-16b and granite-moe-1b-a400m (two groups,
MLA's ``kv_norm``, the 3-D expert stacks and the shared experts).
"""
import collections
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.dist.sharding import tree_path_str as jax_tree_path_str
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.dist.sharding import (tree_flatten_with_path, tree_path_str,
                                       tree_unflatten)
from repro_torch.models import transformer as ttf
from repro_torch.resilience.faults import CheckpointCorruption
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

Pair = collections.namedtuple("Pair", ["zeta", "alpha"])


# ---------------------------------------------------------------------------
# tree paths
# ---------------------------------------------------------------------------

_leaf = st.integers(0, 99)
_trees = st.recursive(
    _leaf | st.none(),
    lambda kids: (st.lists(kids, max_size=3)
                  | st.tuples(kids, kids)
                  | st.builds(Pair, kids, kids)
                  | st.dictionaries(st.sampled_from(
                      ["b", "a", "w_up", "10", "2", "table"]), kids,
                      max_size=3)),
    max_leaves=12)


@settings(deadline=None, max_examples=60)
@given(_trees)
def test_flatten_order_and_names_are_jax(tree):
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat, treedef = tree_flatten_with_path(tree)
    assert [leaf for _, leaf in flat] == [leaf for _, leaf in want]
    assert [tree_path_str(kp) for kp, _ in flat] == \
        [jax_tree_path_str(kp) for kp, _ in want]
    doubled = tree_unflatten(treedef, [2 * leaf for _, leaf in flat])
    assert jax.tree.map(lambda x: 2 * x, tree) == doubled


def test_unflatten_refuses_extra_leaves():
    _, treedef = tree_flatten_with_path({"a": 1, "b": [2, None]})
    assert tree_unflatten(treedef, [5, 6]) == {"a": 5, "b": [6, None]}
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(treedef, [5, 6, 7])


# ---------------------------------------------------------------------------
# train states in the reference's layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """The reference's train state after one step (non-zero moments) and
    the port's state carried from it."""
    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    tcfg = get_config("qwen3-0.6b", reduced=True)
    opt = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    js = jts.init_train_state(jcfg, opt, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 17))
    js, _ = jax.jit(jts.make_train_step(jcfg, opt))(
        js, {"tokens": jnp.asarray(toks.astype(np.int32))})
    host = jax.tree.map(np.asarray, js)
    ts = tts.train_state_from_arrays(tcfg, host, "cpu")
    return tcfg, js, host, ts


def _leaves(tree):
    return {tree_path_str(kp): np.asarray(leaf)
            for kp, leaf in tree_flatten_with_path(tree)[0]}


def _assert_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w)
    for name in w:
        assert g[name].dtype == w[name].dtype, name
        assert np.array_equal(g[name], w[name]), name


def test_train_state_arrays_round_trip(states):
    tcfg, js, host, ts = states
    arrays = tts.train_state_to_arrays(ts)
    _assert_bitwise(arrays, host)
    again = tts.train_state_from_arrays(tcfg, arrays, "cpu")
    assert again.opt.step.dtype == torch.int32 and int(again.opt.step) == 1
    for (n, a), b in zip(ts.params.named_parameters(),
                         again.params.parameters()):
        assert torch.equal(a, b) and b.requires_grad, n
    for n in ts.opt.m:
        assert torch.equal(ts.opt.m[n], again.opt.m[n]), n
        assert torch.equal(ts.opt.v[n], again.opt.v[n]), n


def test_params_to_arrays_inverts_params_from_arrays(states):
    tcfg, _, host, ts = states
    _assert_bitwise(ttf.params_to_arrays(ts.params), host.params)
    model = ttf.params_from_arrays(tcfg, ttf.params_to_arrays(ts.params),
                                   "cpu")
    for a, b in zip(ts.params.parameters(), model.parameters()):
        assert torch.equal(a, b)
        # serving's parameters: on the host, frozen
        assert b.device.type == "cpu" and not b.requires_grad


def test_shapes_only_template_copies_nothing(states):
    """The restore template has the state's leaf names, shapes and dtypes,
    and every leaf is a zero-stride stand-in; a restore through it gives
    the saved state."""
    tcfg, _, host, ts = states
    template = tts.train_state_to_arrays(ts, shapes_only=True)
    got, want = _leaves(template), _leaves(host)
    assert list(got) == list(want)
    for name, a in got.items():
        assert (a.shape, a.dtype) == (want[name].shape, want[name].dtype)
        assert all(s == 0 for s in a.strides), name


def test_load_train_state_in_place(tmp_path, states):
    """``load_train_state_`` writes a restored state into a live one's
    own tensors: the same storage, gradients still on, every leaf equal to
    the checkpoint's."""
    tcfg, _, host, _ = states
    opt = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    live = tts.init_train_state(tcfg, opt, seed=5, device="cpu")
    ptrs = [p.data_ptr() for p in live.params.parameters()] + \
        [t.data_ptr() for t in live.opt.m.values()]
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, host, metadata={"step": 3})
    tree, _ = ckpt.restore(tts.train_state_to_arrays(live, shapes_only=True))
    assert tts.load_train_state_(live, tree) is live
    assert ptrs == [p.data_ptr() for p in live.params.parameters()] + \
        [t.data_ptr() for t in live.opt.m.values()]
    assert all(p.requires_grad for p in live.params.parameters())
    _assert_bitwise(tts.train_state_to_arrays(live), host)


def test_checkpoints_cross_packages(tmp_path, states):
    """The reference's checkpoint restores in the port and the port's in
    the reference, bit for bit; the manifests agree leaf for leaf."""
    tcfg, js, host, ts = states
    JCheckpointer(str(tmp_path / "ref")).save(7, js, metadata={"step": 7})
    Checkpointer(str(tmp_path / "port")).save(
        7, tts.train_state_to_arrays(ts), metadata={"step": 7})
    manifests = [json.load(open(tmp_path / d / "step_0000000007" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    names = list(manifests[0]["leaves"])
    assert "params__groups__0__attn_mlp_0__attn__wq" in names
    assert "opt__m__embed__table" in names and "opt__step" in names
    assert sorted(os.listdir(tmp_path / "ref" / "step_0000000007")) == \
        sorted(os.listdir(tmp_path / "port" / "step_0000000007"))

    template = tts.train_state_to_arrays(
        tts.init_train_state(tcfg, topt.AdamW(lr=topt.warmup_cosine(
            1e-3, 2, 10)), seed=5, device="cpu"))
    mine, meta = Checkpointer(str(tmp_path / "ref")).restore(template)
    assert meta == {"step": 7}
    _assert_bitwise(mine, host)
    theirs, meta = JCheckpointer(str(tmp_path / "port")).restore(js)
    assert meta == {"step": 7}
    _assert_bitwise(jax.tree.map(np.asarray, theirs), host)


@pytest.mark.parametrize("arch,names", [
    ("deepseek-v2-lite-16b",
     ("params__groups__0__mla_mlp_0__attn__kv_norm__scale",
      "params__groups__0__mla_mlp_0__ffn__w_gate",
      "params__groups__1__mla_moe_0__ffn__w_down",
      "params__groups__1__mla_moe_0__ffn__shared_up",
      "opt__v__groups__1__mla_moe_0__ffn__router")),
    ("granite-moe-1b-a400m",
     ("params__groups__0__attn_moe_0__ffn__w_up",
      "opt__m__groups__0__attn_moe_0__attn__wq"))])
def test_moe_mla_checkpoints_cross_packages(tmp_path, arch, names):
    """A train state of a reduced MoE/MLA model after one step: the
    port's arrays equal the reference's, each package's checkpoint
    restores in the other bit for bit, the manifests agree, and a restore
    into a live state goes through the shapes-only template."""
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    opt = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    js = jts.init_train_state(jcfg, opt, jax.random.PRNGKey(1))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 17))
    js, _ = jax.jit(jts.make_train_step(jcfg, opt))(
        js, {"tokens": jnp.asarray(toks.astype(np.int32))})
    host = jax.tree.map(np.asarray, js)
    ts = tts.train_state_from_arrays(tcfg, host, "cpu")
    _assert_bitwise(tts.train_state_to_arrays(ts), host)

    JCheckpointer(str(tmp_path / "ref")).save(2, js, metadata={"step": 2})
    Checkpointer(str(tmp_path / "port")).save(
        2, tts.train_state_to_arrays(ts), metadata={"step": 2})
    manifests = [json.load(open(tmp_path / d / "step_0000000002" /
                                "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    assert set(names) <= set(manifests[0]["leaves"])

    topt_ = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    live = tts.init_train_state(tcfg, topt_, seed=5, device="cpu")
    tree, meta = Checkpointer(str(tmp_path / "ref")).restore(
        tts.train_state_to_arrays(live, shapes_only=True))
    assert meta == {"step": 2}
    tts.load_train_state_(live, tree)
    _assert_bitwise(tts.train_state_to_arrays(live), host)
    theirs, _ = JCheckpointer(str(tmp_path / "port")).restore(js)
    _assert_bitwise(jax.tree.map(np.asarray, theirs), host)


# ---------------------------------------------------------------------------
# the checkpointer's own behaviour
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "blocks": [{"b": np.arange(5, dtype=np.int32)}, None],
            "step": np.asarray(3, dtype=np.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt = Checkpointer(str(tmp_path), keep=2)
    ckpt.save(3, tree, metadata={"step": 3})
    ckpt.save_async(7, tree, metadata={"step": 7})
    tree["w"].add_(1.0)              # after the host copy: not in step 7
    ckpt.wait()
    assert ckpt.all_steps() == [3, 7] and ckpt.latest_step() == 7
    restored, meta = ckpt.restore(_tree())
    assert meta == {"step": 7}
    assert isinstance(restored["w"], torch.Tensor)
    assert restored["w"].dtype == torch.float32
    assert torch.equal(restored["w"], _tree()["w"])
    assert restored["blocks"][1] is None
    assert restored["blocks"][0]["b"].dtype == np.int32
    assert np.array_equal(restored["blocks"][0]["b"], np.arange(5))
    assert sorted(os.listdir(tmp_path / "step_0000000007")) == [
        "blocks__0__b.npy", "manifest.json", "step.npy", "w.npy"]


def test_checkpoint_gc_and_atomicity(tmp_path):
    tree = {"w": np.arange(8, dtype=np.float32)}
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [3, 4]
    os.makedirs(tmp_path / "step_0000000009.tmp")      # a crashed save
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    ckpt.save(9, tree)
    assert ckpt.all_steps() == [4, 9]
    assert not os.path.exists(tmp_path / "step_0000000009.tmp")


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x01]))


@pytest.mark.parametrize("damage", ["flip", "truncate", "manifest", "gone"])
def test_corruption_raises_and_falls_back(tmp_path, damage):
    tree = {"w": np.arange(64, dtype=np.float32)}
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(1, tree, metadata={"step": 1})
    ckpt.save(2, {"w": tree["w"] + 1}, metadata={"step": 2})
    d = tmp_path / "step_0000000002"
    if damage == "flip":
        _flip_byte(d / "w.npy")
    elif damage == "truncate":
        with open(d / "w.npy", "r+b") as f:
            f.truncate(100)
    elif damage == "manifest":
        (d / "manifest.json").write_text("{not json")
    else:
        os.remove(d / "w.npy")
    with pytest.raises(CheckpointCorruption):
        ckpt.restore(tree)
    got, meta, step = ckpt.restore_latest_valid(tree)
    assert step == 1 and meta == {"step": 1}
    assert np.array_equal(got["w"], tree["w"])
    if damage == "flip":
        restored, _ = ckpt.restore(tree, step=2, verify=False)
        assert not np.array_equal(restored["w"], tree["w"] + 1)


def test_every_step_corrupt_raises(tmp_path):
    tree = {"w": np.arange(4, dtype=np.float32)}
    ckpt = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest_valid(tree)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tree)
    ckpt.save(1, tree)
    _flip_byte(tmp_path / "step_0000000001" / "w.npy")
    with pytest.raises(CheckpointCorruption, match="every checkpoint"):
        ckpt.restore_latest_valid(tree)


def test_restore_refuses_shardings(tmp_path):
    tree = {"w": np.arange(4, dtype=np.float32)}
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, tree)
    with pytest.raises(NotImplementedError, match="item 10"):
        ckpt.restore(tree, shardings={"w": object()})
    with pytest.raises(NotImplementedError, match="item 10"):
        ckpt.restore_latest_valid(tree, shardings={"w": object()})
