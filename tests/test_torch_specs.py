"""``repro_torch.configs.cells`` and ``repro_torch.launch.specs`` against
the reference's ``configs.cells`` and ``launch/specs.py``: the cells,
parameter counts, model FLOPs, input specs and decode caches of all ten
archs at their published widths, the microbatch count and activation
rules on three meshes, and the cells the port builds, all on fake tensors
(nothing is allocated), the meshed serving cells among them.  Also: a
fake full-width state shards over a mesh (``shard_train_state`` inside a
``FakeTensorMode``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro import configs as ref_configs
from repro.dist import sharding as ref_sharding
from repro.launch import specs as ref_specs
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.dist.sharding import ShardedTensor, tree_flatten_with_path
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.train import AdamW, warmup_cosine
from repro_torch.train.train_step import TrainState, init_train_state
from repro_torch.train.train_step import shard_train_state

ARCHS = configs.ARCHS
KINDS = ("train", "prefill", "decode")
MESHES = (((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((1,), ("data",)))


def _mesh(shape, axes):
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_arch_lists_are_the_references():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_are_the_references(arch):
    got = configs.cells(arch)
    assert got == ref_configs.cells(arch)
    assert got["long_500k"]["skip"] == \
        (not configs.get_config(arch).sub_quadratic)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_are_the_references(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert specs.count_params(cfg) == ref_specs.count_params(ref_cfg)
    for spec in configs.SHAPES.values():
        args = (spec["kind"], spec["seq_len"], spec["global_batch"])
        assert specs.model_flops(cfg, *args) == \
            ref_specs.model_flops(ref_cfg, *args)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_references(arch, kind):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for seq_len, batch in ((4096, 256), (32768, 32)):
        got = specs.input_specs(cfg, kind, seq_len, batch, "cpu")
        want = ref_specs.input_specs(ref_cfg, kind, seq_len, batch)
        assert {k: (tuple(v.shape), _dtype(v)) for k, v in got.items()} == \
            {k: (tuple(v.shape), _dtype(v)) for k, v in want.items()}
        assert all(isinstance(v, FakeTensor) for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_holds_the_references_bytes(arch):
    """The port's cache is one tuple a layer where the reference stacks
    each group's layers: the same bytes, in fake tensors."""
    got = specs.cache_shapes(configs.get_config(arch), 128, 32768, "cpu")
    want = ref_specs.cache_shapes(ref_configs.get_config(arch), 128, 32768)
    leaves = [t for _, t in tree_flatten_with_path(got)[0]]
    assert all(isinstance(t, FakeTensor) for t in leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) == sum(
        int(np.prod(x.shape)) * x.dtype.itemsize
        for x in jax.tree.leaves(want))


@pytest.mark.parametrize("shape,axes", MESHES, ids=["4x2", "2x2", "1"])
def test_micro_and_rules_are_the_references(shape, axes):
    mesh, ref_mesh = _mesh(shape, axes), AbstractMesh(shape, axes)
    for arch in ARCHS:
        cfg, ref_cfg = configs.get_config(arch), \
            ref_configs.get_config(arch)
        for spec in configs.SHAPES.values():
            b = spec["global_batch"]
            if b >= mesh.shape["data"]:     # else both divide by zero
                assert specs.train_micro(cfg, mesh, b) == \
                    ref_specs.train_micro(ref_cfg, ref_mesh, b)
            decode = spec["kind"] == "decode"
            got = sharding.activation_rules(cfg, mesh, decode=decode,
                                            batch=b)
            want = ref_sharding.activation_rules(ref_cfg, ref_mesh,
                                                 decode=decode, batch=b)
            assert {k: str(v) for k, v in got.items()} == \
                {k: str(v) for k, v in want.items()}


def _meta_want(arch, shape, ref_mesh, fsdp):
    spec = ref_configs.SHAPES[shape]
    ref_cfg = ref_configs.get_config(arch)
    kind, seq_len, batch = spec["kind"], spec["seq_len"], \
        spec["global_batch"]
    rules = ref_sharding.activation_rules(ref_cfg, ref_mesh,
                                          decode=(kind == "decode"),
                                          batch=batch)
    _, report = ref_sharding.shard_params(
        ref_specs.param_shapes(ref_cfg), ref_mesh, fsdp=fsdp,
        heads={"q": ref_cfg.n_heads, "kv": ref_cfg.n_kv_heads})
    return dict(arch=arch, shape=shape, kind=kind, seq_len=seq_len,
                global_batch=batch, params=ref_specs.count_params(ref_cfg),
                model_flops=ref_specs.model_flops(ref_cfg, kind, seq_len,
                                                  batch),
                activation_rules={k: str(v) for k, v in rules.items()},
                sharding_report=report)


def test_train_cell_on_one_entry_is_the_references():
    """qwen3-0.6b's ``train_4k`` cell on one card: the unmeshed step over
    fake tensors in the cell's mode, 256 microbatches, the first one's
    rows as views, and the reference's meta."""
    cell = specs.build_cell("qwen3-0.6b", "train_4k", _mesh((1,), ("data",)))
    want = _meta_want("qwen3-0.6b", "train_4k", AbstractMesh((1,), ("data",)),
                      fsdp=True)
    want["n_micro"] = ref_specs.train_micro(
        ref_configs.get_config("qwen3-0.6b"), AbstractMesh((1,), ("data",)),
        256)
    assert cell.meta == want and cell.meta["n_micro"] == 256
    assert [f.name for f in dataclasses.fields(specs.Cell)] == \
        [f.name for f in dataclasses.fields(ref_specs.Cell)] + \
        ["fake_mode", "micro"]
    state, batch = cell.args
    assert isinstance(state, TrainState) and cell.donate_argnums == (0,)
    assert all(isinstance(p, FakeTensor) for p in state.params.parameters())
    assert state.params.cfg.remat == "full"
    assert batch["tokens"].shape == (256, 4097)
    fn, (micro_state, micro) = cell.micro
    assert micro_state is state and callable(fn)
    assert micro["tokens"].shape == (1, 4097)
    assert micro["tokens"].untyped_storage().nbytes() == \
        batch["tokens"].untyped_storage().nbytes()
    assert isinstance(cell.fake_mode, FakeTensorMode)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cells_on_one_entry(shape):
    cell = specs.build_cell("qwen3-0.6b", shape, _mesh((1,), ("data",)))
    assert cell.meta == _meta_want("qwen3-0.6b", shape,
                                   AbstractMesh((1,), ("data",)),
                                   fsdp=False)
    model = cell.args[0]
    assert all(isinstance(p, FakeTensor) for p in model.parameters())
    batch = cell.args[-1]
    if shape == "prefill_32k":
        assert batch["tokens"].shape == (32, 32768)
        return
    layers = cell.args[1]["layers"]
    assert len(layers) == model.cfg.n_layers
    assert layers[0][0].shape == (128, 32768, model.cfg.n_kv_heads,
                                  model.cfg.head_dim_)
    assert int(batch["cache_pos"]) == 32767 and cell.donate_argnums == (1,)


def test_serving_cell_over_entries_refuses():
    """Refused until ROADMAP item 12.1 was ported; now the accepted call:
    qwen3-0.6b's meshed ``prefill_32k`` and ``decode_32k`` cells on (data
    4, model 2) entries, with the reference's meta, the parameters as the
    reference's tree of ``ShardedTensor``s of fake blocks laid out by
    ``shard_params(..., fsdp=False)``, and the decode cache laid out by
    ``cache_specs``: each layer's K and V the reference's spec of its
    stacked leaf without the repeats axis, in ``in_shardings`` and
    ``out_shardings`` alike."""
    mesh = _mesh((4, 2), ("data", "model"))
    ref_mesh = AbstractMesh((4, 2), ("data", "model"))
    cfg = configs.get_config("qwen3-0.6b")
    for shape in ("prefill_32k", "decode_32k"):
        cell = specs.build_cell("qwen3-0.6b", shape, mesh)
        assert cell.meta == _meta_want("qwen3-0.6b", shape, ref_mesh,
                                       fsdp=False)
        params, batch = cell.args[0], cell.args[-1]
        leaves = [st for _, st in tree_flatten_with_path(params)[0]]
        assert leaves and all(isinstance(st, ShardedTensor) and all(
            isinstance(b, FakeTensor) for b in st.blocks) for st in leaves)
        assert params["groups"][0]["attn_mlp_0"]["attn"]["wq"].spec == \
            sharding.P(None, None, "model")
        if shape == "prefill_32k":
            assert batch["tokens"].shape == (32, 32768)
            continue
        want = ref_sharding.cache_specs(ref_specs.cache_shapes(
            ref_configs.get_config("qwen3-0.6b"), 128, 32768)["layers"],
            ref_mesh, seq_len=32768, batch=128)[0]["attn_mlp_0"]
        layers = cell.args[1]["layers"]
        assert len(layers) == cfg.n_layers
        for k_v, sh in zip(layers, cell.in_shardings[1]["layers"]):
            for st, ns, ref in zip(k_v, sh, want):
                assert st.shape == (128, 32768, 8, 128)
                assert tuple(st.spec) == tuple(ns.spec) == \
                    tuple(ref)[1:] == ("data", "model", None, None)
                assert st.blocks[0].shape == (32, 16384, 8, 128)
        assert cell.out_shardings[1] is cell.in_shardings[1]
        assert int(batch["cache_pos"]) == 32767 and \
            cell.donate_argnums == (1,)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b",
                                  "recurrentgemma-9b", "qwen2-vl-2b",
                                  "whisper-small"])
def test_serving_cell_of_a_later_family_over_entries_refuses(arch):
    """MLA, the recurrent states, qwen2-vl's embeddings and whisper's
    cross-attention cache wait for item 12.2: their meshed serving cells
    raise, naming item 12."""
    for shape in ("prefill_32k", "decode_32k"):
        with pytest.raises(NotImplementedError, match="item 12"):
            specs.build_cell(arch, shape, _mesh((4, 2), ("data", "model")))


def test_fake_full_width_state_shards():
    """``shard_train_state`` inside a ``FakeTensorMode`` (its zero-stride
    stand-ins read the dtype off a real empty tensor): every leaf of the
    reference's layout a ``ShardedTensor`` of fake blocks, of the
    reference's shapes."""
    cfg = configs.get_config("qwen3-0.6b")
    mesh = _mesh((4, 2), ("data", "model"))
    opt = AdamW(lr=warmup_cosine(3e-4, 100, 10_000))
    with FakeTensorMode():
        state = shard_train_state(init_train_state(cfg, opt, 0, "cpu"),
                                  mesh)
    got = tree_flatten_with_path(state.params)[0]
    want = jax.tree_util.tree_flatten_with_path(
        ref_specs.param_shapes(ref_configs.get_config("qwen3-0.6b")))[0]
    assert [(sharding.tree_path_str(k), st.shape) for k, st in got] == \
        [(ref_sharding.tree_path_str(k), tuple(x.shape)) for k, x in want]
    for _, st in got + tree_flatten_with_path(state.opt.m)[0]:
        assert isinstance(st, ShardedTensor)
        assert all(isinstance(b, FakeTensor) for b in st.blocks)
    assert state.opt.m["embed"]["table"].dtype == torch.float32


def test_param_shapes_are_zero_stride_stand_ins():
    shapes = specs.param_shapes(configs.get_config("gemma3-1b"))
    leaves = [x for _, x in tree_flatten_with_path(shapes)[0]]
    assert leaves and all(isinstance(x, np.ndarray) and x.strides ==
                          (0,) * x.ndim for x in leaves)
