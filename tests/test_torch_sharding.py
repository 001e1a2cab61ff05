"""``repro_torch.dist`` (the sharding rules, the per-entry layout of a
tensor on the port's mesh and the int8 gradient exchange), the mesh's
differentiable collectives and ``_moe_a2a``, against ``repro.dist`` and
``repro.models.moe``.

The spec functions read only ``mesh.shape`` and ``mesh.axis_names``, so
both packages run on the same duck-typed meshes here.  What needs a real
jax mesh (a sharded array's ``addressable_shards``, ``shard_map``) runs in
one subprocess on 8 host devices, ``XLA_FLAGS`` set before jax starts.
Tolerances: specs, rules, reports, blocks and the int8 codec exactly (bit
for bit, the denormal cases included); ``_moe_a2a``'s dropped routings
exactly and its outputs within 1e-5.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.dist import compression as jcomp
from repro.dist import sharding as jsh
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.dist import compression as tcomp
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import (all_to_all, gather_blocks, make_mesh,
                                     psum)
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import MeshPlan
from repro_torch.models.moe import _moe_a2a
from repro_torch.train.train_step import train_state_template

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCHS = ["qwen3-0.6b", "gemma3-1b", "glm4-9b", "granite-34b",
         "granite-moe-1b-a400m", "deepseek-v2-lite-16b", "xlstm-1.3b",
         "recurrentgemma-9b", "qwen2-vl-2b", "whisper-small"]
MESHES = {"data8": (("data",), (8,)),
          "data4_model2": (("data", "model"), (4, 2)),
          "data2_model2": (("data", "model"), (2, 2)),
          "pod2_data2_model2": (("pod", "data", "model"), (2, 2, 2))}


class DuckMesh:
    """``mesh.shape`` and ``mesh.axis_names`` alone, as the reference's
    ``FakeMesh`` double."""

    def __init__(self, name):
        axes, shape = MESHES[name]
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _port_mesh(name):
    axes, shape = MESHES[name]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = jax_get_config(arch, reduced=True)
    return jax.eval_shape(lambda: jtf.init_params(cfg,
                                                  jax.random.PRNGKey(0)))


def _flat_specs(tree, flatten):
    return [(jsh.tree_path_str(kp), tuple(s), repr(s))
            for kp, s in flatten(tree)]


# ---------------------------------------------------------------------------
# the rules: the reference's, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_specs_and_reports_equal_reference(arch, mesh):
    """Over each architecture's reduced parameter tree (the port's own
    layout, ``train_state_template``), with FSDP on and off."""
    cfg = get_config(arch, reduced=True)
    heads = {"q": cfg.n_heads, "kv": cfg.n_kv_heads}
    for fsdp in (True, False):
        want, want_rep = jsh.shard_params(_ref_shapes(arch), DuckMesh(mesh),
                                          fsdp=fsdp, heads=heads)
        got, got_rep = tsh.shard_params(train_state_template(cfg).params,
                                        DuckMesh(mesh), fsdp=fsdp,
                                        heads=heads)
        assert got_rep == want_rep
        assert _flat_specs(got, lambda t: tsh.tree_flatten_with_path(
            t, lambda x: isinstance(x, tsh.PartitionSpec))[0]) == \
            _flat_specs(want, lambda t: jax.tree_util.tree_flatten_with_path(
                t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
            )[0])


def test_specs_read_a_port_mesh_as_its_double():
    cfg = get_config("gemma3-1b", reduced=True)
    shapes = train_state_template(cfg).params
    on_mesh = tsh.shard_params(shapes, _port_mesh("data4_model2"))
    on_double = tsh.shard_params(shapes, DuckMesh("data4_model2"))
    assert on_mesh == on_double


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_activation_rules_equal_reference(arch, mesh):
    """Train; decode at a batch that covers the data axes and at one that
    does not."""
    jcfg, tcfg = jax_get_config(arch, reduced=True), get_config(
        arch, reduced=True)
    for kw in ({}, {"decode": True, "batch": 8}, {"decode": True,
                                                  "batch": 3}):
        want = jsh.activation_rules(jcfg, DuckMesh(mesh), **kw)
        got = tsh.activation_rules(tcfg, DuckMesh(mesh), **kw)
        assert dict(got) == dict(want), kw


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_reference(mesh):
    """``batch_specs`` exactly the reference's; ``cache_specs`` in the
    port's per-layer layout (each layer's tuple, batch on axis 0) the
    reference's spec of the same layer's stacked leaf without its leading
    repeats axis, for attention (GQA), MQA (one KV head) and MLA caches
    (the decode fallback and the uneven lengths among the cases)."""
    shapes = {"tokens": np.zeros((8, 17), np.int32),
              "labels": np.zeros((8, 16), np.int32),
              "positions3": np.zeros((3, 8, 16), np.int32),
              "odd": np.zeros((6, 5), np.float32),
              "step": np.zeros((), np.int32)}
    want = jsh.batch_specs(shapes, DuckMesh(mesh))
    got = tsh.batch_specs(shapes, DuckMesh(mesh))
    assert {k: (tuple(v), repr(v)) for k, v in got.items()} == \
        {k: (tuple(v), repr(v)) for k, v in want.items()}
    for arch in ("qwen3-0.6b", "granite-34b", "deepseek-v2-lite-16b"):
        cfg = get_config(arch, reduced=True)
        for seq_len, batch in ((64, 8), (64, 3), (12, 8), (7, 2)):
            stacked = jax.eval_shape(lambda: jtf.init_cache(
                jax_get_config(arch, reduced=True), batch, seq_len))
            want = jsh.cache_specs(stacked, DuckMesh(mesh), seq_len, batch)
            got = tsh.cache_specs(
                ttf.init_cache(cfg, batch, seq_len, "cpu"), DuckMesh(mesh),
                seq_len, batch, cfg)
            for layer, slot in zip(got, ttf.layer_slots(cfg)):
                ref = want[slot.group][slot.key]
                assert [repr(tsh.P(*tuple(s)[1:])) for s in ref] == \
                    [repr(s) for s in layer], (arch, seq_len, batch, slot)


def _cache_case(case):
    """(config, mesh, seq_len, batch) of one ``cache_specs`` unit case."""
    arch = {"mqa": "granite-34b", "coincidence": "xlstm-1.3b"}.get(
        case, "qwen3-0.6b")
    seq_len, batch = {"divisible": (16, 8), "fallback": (16, 1),
                      "uneven": (14, 1), "mqa": (16, 8),
                      "coincidence": (32, 4)}[case]
    return get_config(arch, reduced=True), DuckMesh("data4_model2"), \
        seq_len, batch


@pytest.mark.parametrize("case", ["divisible", "fallback", "uneven", "mqa",
                                  "coincidence"])
def test_cache_specs_per_layer_layout(case):
    """``cache_specs`` on the port's per-layer cache at (data 4, model 2):
    a batch that the data axes divide goes over ``data`` and the sequence
    over ``model``; batch 1 falls back to the sequence over (data, model);
    a length of 14 does not split 8 ways and goes over ``model`` alone;
    an MQA cache (one KV head) is laid out as any other; and a recurrent
    state whose dimension equals ``seq_len`` by chance (reduced xlstm's
    mLSTM state, head dim 32) shards its batch only, its kind chosen by
    the layer plan, never by its shape."""
    cfg, mesh, seq_len, batch = _cache_case(case)
    layers = ttf.init_cache(cfg, batch, seq_len, "cpu")
    got = tsh.cache_specs(layers, mesh, seq_len, batch, cfg)
    seq = {"fallback": ("data", "model"), "uneven": "model"}.get(case,
                                                                 "model")
    bat = "data" if batch % 4 == 0 else None
    for layer, specs, slot in zip(layers, got, ttf.layer_slots(cfg)):
        assert len(specs) == len(layer)
        for t, spec in zip(layer, specs):
            want = [bat] + [None] * (t.dim() - 1)
            if ttf.is_attention(slot.kind):
                want[1] = seq
            assert tuple(spec) == tuple(want), (slot, tuple(t.shape))
    if case == "coincidence":
        assert any(seq_len in t.shape[1:] for t in layers[0])
    with pytest.raises(ValueError, match="cache layers"):
        tsh.cache_specs(layers[:-1], mesh, seq_len, batch, cfg)


@pytest.mark.parametrize("spec", [(), (None,), ("data", None),
                                  (("pod", "data"), None, "model"),
                                  (None, ("data", "model"))])
def test_partition_spec_prints_as_the_references(spec):
    assert repr(tsh.P(*spec)) == repr(jax.sharding.PartitionSpec(*spec))
    assert tuple(tsh.P(*spec)) == spec


def test_binding_is_seen_inside_and_gone_after():
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    mesh = _port_mesh("data4_model2")
    rules = tsh.activation_rules(cfg, mesh)
    seen = []

    def probe(x):
        seen.append((tsh.bound_axis("expert"), tsh.bound_axis("batch"),
                     tsh.bound_mesh() is mesh, tsh.bound_rules() is rules))
        return tsh.constrain(x, "batch", None)

    x = torch.ones(4, 2)
    assert tsh.bind_activation_rules(probe, rules)(x) is x
    assert seen == [("model", "data", True, True)]
    assert tsh.bound_rules() is None and tsh.bound_axis("batch") is None
    assert tsh.constrain(x, "batch", None) is x
    double = tsh.activation_rules(cfg, DuckMesh("data4_model2"))
    assert tsh.bind_activation_rules(lambda: tsh.bound_mesh(), double)() \
        is None


# ---------------------------------------------------------------------------
# the layout of a tensor: jax's addressable_shards, block for block
# ---------------------------------------------------------------------------

BLOCK_SPECS = {
    "data4_model2": [(), ("data",), (None, "model"), ("model", "data"),
                     (("data", "model"),), (None, ("model", "data")),
                     ("data", None, "model")],
    "pod2_data2_model2": [("pod",), (("pod", "data"), "model"),
                          (None, ("data", "pod")), ("model", None, "data"),
                          ((("pod", "data", "model")),)],
}
_X_SHAPE = (8, 16, 8)

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

MESHES, BLOCK_SPECS, X_SHAPE = {meshes!r}, {specs!r}, {shape!r}
out = {{}}
devs = np.array(jax.devices())
x = np.arange(np.prod(X_SHAPE), dtype=np.float32).reshape(X_SHAPE)
for name, specs in BLOCK_SPECS.items():
    axes, shape = MESHES[name]
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
    out[name + "__ids"] = np.array([d.id for d in mesh.devices.flat])
    for i, spec in enumerate(specs):
        arr = jax.device_put(x, NamedSharding(mesh, P(*spec)))
        for sh in arr.addressable_shards:
            out[f"{{name}}__{{i}}__{{sh.device.id}}"] = np.asarray(sh.data)

# compressed_psum_grads under shard_map over 4 entries
from repro.dist.compression import compressed_psum_grads
mesh4 = Mesh(devs[:4], ("data",))
g = np.load(sys.argv[2])
def local(w, b, ew, eb):
    means, errs = compressed_psum_grads({{"w": w[0], "b": b[0]}},
                                        {{"w": ew[0], "b": eb[0]}}, "data")
    return (means["w"][None], means["b"][None], errs["w"][None],
            errs["b"][None])
fn = jax.shard_map(local, mesh=mesh4, in_specs=(P("data"),) * 4,
                   out_specs=(P("data"),) * 4)
for k, v in zip(("mean_w", "mean_b", "err_w", "err_b"),
                fn(*(jnp.asarray(g[k]) for k in ("w", "b", "ew", "eb")))):
    out["psum_" + k] = np.asarray(v)

# _moe_a2a on (data 2, model 2): outputs, and each routing kept or not
from repro.configs import get_config
from repro.models.moe import _moe_a2a
cfg = get_config("granite-moe-1b-a400m", reduced=True)
mesh22 = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
with mesh22:
    for t in (64, 66):
        params = {{k: jnp.asarray(g[f"moe_{{k}}"])
                   for k in ("w_gate", "w_up", "w_down")}}
        xf, te, tp = (jnp.asarray(g[f"moe{{t}}_{{k}}"])
                      for k in ("xf", "te", "tp"))
        a2a = jax.jit(lambda w: _moe_a2a(xf, te, w, params, cfg, mesh22,
                                         ("data",)))
        out[f"moe{{t}}_out"] = np.asarray(a2a(tp))
        for j in range(te.shape[1]):
            o = a2a(jnp.zeros_like(tp).at[:, j].set(1.0))
            out[f"moe{{t}}_kept{{j}}"] = np.asarray(jnp.any(o != 0, axis=1))
np.savez(sys.argv[1], **out)
"""


def _psum_inputs():
    """Four entries' gradient and error trees: normal values, one entry's
    zero and one entry's denormal gradients."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 6, 3)).astype(np.float32)
    b = rng.normal(size=(4, 5)).astype(np.float32)
    w[1] = 0.0
    b[2] *= np.float32(1e-39)
    ew = (rng.normal(size=w.shape) * 1e-3).astype(np.float32)
    eb = np.zeros_like(b)
    return dict(w=w, b=b, ew=ew, eb=eb)


def _moe_inputs(t, seed):
    """Tokens, skewed routings (most first choices on expert 0, so the
    per-shard capacity drops some) and routing weights."""
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    m = cfg.moe
    rng = np.random.default_rng(seed)
    first = rng.choice(m.n_experts, size=t, p=[0.7, 0.1, 0.1, 0.1])
    second = (first + 1 + rng.integers(0, m.n_experts - 1, size=t)) \
        % m.n_experts
    te = np.stack([first, second], axis=1).astype(np.int32)
    tp = rng.random((t, m.top_k)).astype(np.float32)
    tp /= tp.sum(1, keepdims=True)
    xf = rng.normal(size=(t, cfg.d_model)).astype(np.float32)
    return xf, te, tp


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    inputs = _psum_inputs()
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    m = cfg.moe
    rng = np.random.default_rng(3)
    for name, shape in (("w_gate", (m.n_experts, cfg.d_model, m.d_expert)),
                        ("w_up", (m.n_experts, cfg.d_model, m.d_expert)),
                        ("w_down", (m.n_experts, m.d_expert, cfg.d_model))):
        inputs[f"moe_{name}"] = (rng.normal(size=shape) / 8).astype(
            np.float32)
    for t in (64, 66):
        for k, v in zip(("xf", "te", "tp"), _moe_inputs(t, t)):
            inputs[f"moe{t}_{k}"] = v
    np.savez(tmp / "in.npz", **inputs)
    code = _REFERENCE.format(meshes=MESHES, specs=BLOCK_SPECS,
                             shape=_X_SHAPE)
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", code, str(tmp / "out.npz"),
                          str(tmp / "in.npz")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), inputs


@pytest.mark.parametrize("name", sorted(BLOCK_SPECS))
def test_blocks_equal_jax_addressable_shards(reference, name):
    """Each entry's block of ``NamedSharding.shard`` is jax's block for the
    same spec on the device at the same place of the mesh; entries that
    hold the same block share one tensor, and ``unshard`` gives the whole
    back."""
    ref, _ = reference
    mesh = _port_mesh(name)
    ids = ref[name + "__ids"]
    x = torch.arange(int(np.prod(_X_SHAPE)),
                     dtype=torch.float32).reshape(_X_SHAPE)
    for i, spec in enumerate(BLOCK_SPECS[name]):
        st = tsh.NamedSharding(mesh, tsh.P(*spec)).shard(x)
        for k, block in enumerate(st.blocks):
            want = ref[f"{name}__{i}__{ids[k]}"]
            assert np.array_equal(block.numpy(), want), (spec, k)
        assert len(st.distinct()) == len({tuple(b.shape) + (
            b.flatten()[0].item(),) for b in st.blocks})
        assert torch.equal(st.unshard(), x)


@pytest.mark.parametrize("case", ["zeros", "denormal", "tiny_scale",
                                  "mixed", "normal", "signed_zero"])
@pytest.mark.parametrize("with_err", [False, True])
def test_ef_compress_and_dequantize_are_bit_equal(case, with_err):
    rng = np.random.default_rng(hash(case) % 2**32)
    x = {"zeros": np.zeros(7, np.float32),
         "denormal": np.array([1e-40, -2e-41, 0.0, 3e-39], np.float32),
         "tiny_scale": np.array([1e-37, 3e-38, -5e-38], np.float32),
         "mixed": np.array([1e-30, 1e-38, -3e-39, 2e-31], np.float32),
         "normal": rng.normal(size=(9, 4)).astype(np.float32),
         "signed_zero": np.array([-0.0, 0.0, 1.0, -2.0], np.float32)}[case]
    err = (rng.normal(size=x.shape) * np.float32(np.abs(x).max() * 0.01)
           ).astype(np.float32) if with_err else np.zeros_like(x)
    want = jcomp.ef_compress(jnp.asarray(x), jnp.asarray(err))
    got = tcomp.ef_compress(torch.from_numpy(x), torch.from_numpy(err))
    for a, b in zip(got, want):
        a, b = np.atleast_1d(a.numpy()), np.atleast_1d(np.asarray(b))
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                     b.view(np.uint8))
    deq_t = tcomp.dequantize_int8(got[0], got[1]).numpy()
    deq_j = np.asarray(jcomp.dequantize_int8(want[0], want[1]))
    assert np.array_equal(deq_t.view(np.uint8), deq_j.view(np.uint8))


def test_compressed_psum_grads_equals_reference_under_shard_map(reference):
    """Over a 4-entry CPU mesh: every entry's mean and every entry's new
    error bit for bit, one entry's gradient zero and one's denormal."""
    from repro_torch.launch.mesh import make_data_mesh

    ref, g = reference
    mesh = make_data_mesh(4, devices=["cpu"] * 4)
    grads = [{"w": torch.from_numpy(g["w"][k]), "b": torch.from_numpy(
        g["b"][k])} for k in range(4)]
    errs = [{"w": torch.from_numpy(g["ew"][k]), "b": torch.from_numpy(
        g["eb"][k])} for k in range(4)]
    means, new_errs = tcomp.compressed_psum_grads(grads, errs, "data", mesh)
    for k in range(4):
        for leaf in ("w", "b"):
            for got, key in ((means[k][leaf], "mean"),
                             (new_errs[k][leaf], "err")):
                want = ref[f"psum_{key}_{leaf}"][k]
                assert np.array_equal(got.numpy().view(np.uint8),
                                      want.view(np.uint8)), (k, leaf, key)


def test_compressed_psum_grads_refuses_a_wrong_count():
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(4, devices=["cpu"] * 4)
    tree = {"w": torch.zeros(3)}
    with pytest.raises(ValueError, match="one tree an entry"):
        tcomp.compressed_psum_grads([tree] * 3, [tree] * 3, "data", mesh)


@pytest.mark.parametrize("t", [64, 66])
def test_moe_a2a_drops_and_outputs_equal_reference(reference, t):
    """(data 2, model 2), reduced granite-moe's 4 experts, top 2: 64
    tokens split over data and model (16 a shard, ``c_src`` 10), 66 over
    data alone (33 a shard).  Each routing is kept or dropped as in the
    reference (the output of a one-hot routing weight is nonzero), and
    the outputs agree within 1e-5."""
    ref, g = reference
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    mesh = _port_mesh("data2_model2")
    plan = MeshPlan(mesh, ("data",))
    p = {}
    for name in ("w_gate", "w_up", "w_down"):
        w = g[f"moe_{name}"]
        spec = tsh.spec_for_param(f"ffn/{name}", w.shape, mesh, [])
        p[name] = tsh.NamedSharding(mesh, spec).shard(w)
    xf, te, tp = (torch.from_numpy(g[f"moe{t}_{k}"])
                  for k in ("xf", "te", "tp"))

    def run(weights):
        outs = _moe_a2a(plan, list(torch.chunk(xf, 2)),
                        list(torch.chunk(te.long(), 2)),
                        list(torch.chunk(weights, 2)), p, cfg)
        return torch.cat(outs).numpy()

    np.testing.assert_allclose(run(tp), ref[f"moe{t}_out"], rtol=1e-5,
                               atol=1e-5)
    dropped = 0
    for j in range(cfg.moe.top_k):
        one = torch.zeros_like(tp)
        one[:, j] = 1.0
        kept = np.any(run(one) != 0, axis=1)
        assert np.array_equal(kept, ref[f"moe{t}_kept{j}"]), j
        dropped += int((~kept).sum())
    assert dropped > 0, "the skewed routing dropped nothing"


# ---------------------------------------------------------------------------
# the mesh's differentiable collectives
# ---------------------------------------------------------------------------

def test_psum_sums_and_hands_each_part_the_gradient():
    mesh = _port_mesh("data4_model2")
    parts = [torch.full((3,), float(k + 1), requires_grad=True)
             for k in range(2)]
    out = psum(mesh, "model", parts)
    assert torch.equal(out, torch.full((3,), 3.0))
    (out * torch.arange(3.0)).sum().backward()
    for p in parts:
        assert torch.equal(p.grad, torch.arange(3.0))
    with pytest.raises(ValueError, match="one tensor an entry"):
        psum(mesh, "data", parts)


@pytest.mark.parametrize("split_axis,concat_axis", [(0, 0), (1, 0), (0, 2)])
def test_all_to_all_is_jax_semantics_and_routes_gradients_back(
        split_axis, concat_axis):
    """Entry ``i`` receives chunk ``i`` of every entry, in entry order;
    the backward is the inverse all_to_all."""
    mesh = _port_mesh("data2_model2")
    xs = [torch.randn(2, 4, 3, generator=torch.Generator().manual_seed(k),
                      requires_grad=True) for k in range(2)]
    out = all_to_all(mesh, "model", xs, split_axis, concat_axis)
    for i in range(2):
        want = torch.cat([torch.chunk(x, 2, dim=split_axis)[i] for x in xs],
                         dim=concat_axis)
        assert torch.equal(out[i], want)
    weights = [torch.randn(o.shape) for o in out]
    sum((o * w).sum() for o, w in zip(out, weights)).backward()
    back = all_to_all(mesh, "model", weights, concat_axis, split_axis)
    for x, b in zip(xs, back):
        assert torch.equal(x.grad, b)


def test_gather_blocks_backward_is_the_reduce_scatter():
    mesh = _port_mesh("data4_model2")
    whole = torch.randn(8, 6)
    st = tsh.NamedSharding(mesh, tsh.P("data", "model")).shard(whole)
    plan = MeshPlan(mesh, ("data",))
    blocks = st.distinct()
    for b in blocks:
        b.requires_grad_(True)
    w = plan.local(st, 1)
    assert torch.equal(w, whole[:, 3:])
    (w * 2).sum().backward()
    for i, b in enumerate(st.blocks):
        if i % 2:           # model entry 1's blocks: their rows of 2s
            assert torch.equal(b.grad, torch.full(b.shape, 2.0))
        else:               # model entry 0's took no part
            assert b.grad is None
    parts = [torch.ones(2, 1), torch.ones(2, 1) * 2]
    assert torch.equal(gather_blocks(mesh, "model", parts, 1),
                       torch.tensor([[1.0, 2.0], [1.0, 2.0]]))
