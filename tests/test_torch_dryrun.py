"""``repro_torch.launch.dryrun`` on fake tensors: the trip-weighted trace
equals a full trace; an ``entries`` cell's FLOPs and collectives equal
``FlopCounterMode``'s and ``recording``'s around the same step run on
real CPU tensors, the meshed prefill and decode cells' among them; the peak tracker; the refusals of the reference's
production meshes; records with the reference's keys (read off
``src/repro/launch/dryrun.py``, which is not imported: it forces 512
host devices when it is); ``main``; the flash kernel's custom operator
on fake CUDA tensors."""
import ast
import dataclasses
import json
import os
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.dist.sharding import activation_rules, bind_activation_rules
from repro_torch.kernels.flash_attention import attended_pairs, \
    flash_attention
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh, recording
from repro_torch.train import AdamW, make_train_step, warmup_cosine
from repro_torch.train.train_step import init_train_state, \
    shard_train_state

REF_DRYRUN = os.path.join(os.path.dirname(__file__), os.pardir, "src",
                          "repro", "launch", "dryrun.py")
TINY = {"train_tiny": dict(kind="train", seq_len=16, global_batch=16),
        "prefill_tiny": dict(kind="prefill", seq_len=16, global_batch=2),
        "decode_tiny": dict(kind="decode", seq_len=32, global_batch=2)}


def _opt():
    return AdamW(lr=warmup_cosine(3e-4, 100, 10_000))


def _cpu_mesh(shape, axes):
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes, devices=["cpu"] * n)


@pytest.fixture
def tiny_cells(monkeypatch):
    """The reduced configs and the TINY shapes, where ``build_cell`` and
    ``cells`` read the published ones."""
    shapes = dict(configs.SHAPES, **TINY)
    monkeypatch.setattr(configs, "SHAPES", shapes)
    monkeypatch.setattr(specs, "SHAPES", shapes)

    def reduced(name, reduced=True):
        return get_config(name, reduced=True)

    monkeypatch.setattr(configs, "get_config", reduced)
    monkeypatch.setattr(specs, "get_config", reduced)


def _same(a: dryrun.StepTrace, b: dryrun.StepTrace) -> None:
    assert a.flops == b.flops
    assert a.traffic_bytes == b.traffic_bytes
    assert a.collectives == b.collectives
    assert a.peak_bytes == b.peak_bytes
    assert (a.argument_bytes, a.output_bytes, a.alias_bytes) == \
        (b.argument_bytes, b.output_bytes, b.alias_bytes)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-1b-a400m"])
def test_weighted_trace_equals_a_full_trace(arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True), remat="full")
    opt = _opt()
    mode = FakeTensorMode()
    with mode:
        state = init_train_state(cfg, opt, 0, "cpu")
        batch = specs.input_specs(cfg, "train", 16, 8, "cpu")
    full = dryrun.trace_step(make_train_step(cfg, opt, 4), (state, batch),
                             mode)
    one = dryrun.trace_step(make_train_step(cfg, opt, 1),
                            (state, specs.first_micro(batch, 4)), mode,
                            n_micro=4)
    _same(one, full)
    assert full.flops_once == full.flops
    assert sum(one.flops_once.values()) * 3 < one.total_flops


def test_weighted_meshed_trace_equals_a_full_trace():
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              remat="full")
    opt, mesh = _opt(), _cpu_mesh((2, 2), ("data", "model"))
    rules = activation_rules(cfg, mesh, batch=8)
    mode = FakeTensorMode()
    with mode:
        state = shard_train_state(init_train_state(cfg, opt, 0, "cpu"), mesh)
        batch = specs.input_specs(cfg, "train", 8, 8, "cpu")

    def step(n):
        return bind_activation_rules(make_train_step(
            cfg, opt, n, micro_batch_axes=("data",)), rules)

    full = dryrun.trace_step(step(2), (state, batch), mode)
    one = dryrun.trace_step(step(1), (state, specs.first_micro(batch, 2)),
                            mode, n_micro=2)
    _same(one, full)
    assert full.collectives["count_all-gather"] > 0
    assert full.collectives["count_all-reduce"] > 0


def test_entries_cell_counts_equal_a_real_step(tiny_cells):
    """``run_cell``'s ``entries`` record of a reduced qwen3 train cell
    (16 x 16 tokens: 4 microbatches over (data 4, model 2), one traced,
    weighted by 4) against ``FlopCounterMode`` and the ``recording`` hook
    around the cell's own step on real CPU tensors."""
    rec = dryrun.run_cell("qwen3-0.6b", "train_tiny", "entries",
                          device="cpu")
    assert rec["status"] == "ok" and rec["meta"]["n_micro"] == 4
    mesh = _cpu_mesh(dryrun.ENTRIES, ("data", "model"))
    cell = specs.build_cell("qwen3-0.6b", "train_tiny", mesh)
    cfg = get_config("qwen3-0.6b", reduced=True)
    state = shard_train_state(init_train_state(cfg, _opt(), 0, "cpu"), mesh)
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (16, 17),
                                     generator=gen, dtype=torch.int32)}
    seen = []
    with FlopCounterMode(display=False) as fc, \
            recording(lambda name, *_: seen.append(name)):
        cell.fn(state, batch)
    assert rec["cost"]["per_device_flops"] == fc.get_total_flops()
    counts = {k[len("count_"):]: v for k, v in rec["collectives"].items()
              if k.startswith("count_")
              and k[len("count_"):] in dryrun._KINDS.values()}
    want = {}
    for name in seen:
        kind = dryrun._KINDS[name]
        want[kind] = want.get(kind, 0) + 1
    assert counts == want
    assert rec["chips"] == 1 and rec["meta"]["entries"] == 8


@pytest.mark.parametrize("shape", ["prefill_tiny", "decode_tiny"])
def test_entries_serving_cell_counts_equal_a_real_step(tiny_cells, shape):
    """``run_cell``'s ``entries`` record of a reduced qwen3 serving cell
    (batch 2 on (data 4, model 2): the batch fallback, the decode cache's
    32 slots over (data, model)) against ``FlopCounterMode`` and the
    ``recording`` hook around the cell's own step on real CPU tensors:
    the parameters and the cache laid out by the cell's ``in_shardings``,
    ``cache_pos`` the cell's last slot."""
    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models.transformer import (arrays_from_named,
                                                init_params, make_cache)

    rec = dryrun.run_cell("qwen3-0.6b", shape, "entries", device="cpu")
    assert rec["status"] == "ok" and rec["kind"] == shape.split("_")[0]
    mesh = _cpu_mesh(dryrun.ENTRIES, ("data", "model"))
    cell = specs.build_cell("qwen3-0.6b", shape, mesh)
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = init_params(cfg, 0, "cpu")
    params = shard_tree(arrays_from_named(dict(model.named_parameters()),
                                          cfg, on_device=True),
                        cell.in_shardings[0])
    gen = torch.Generator().manual_seed(0)
    if shape == "prefill_tiny":
        args = (params, {"tokens": torch.randint(
            0, cfg.vocab_size, (2, 16), generator=gen, dtype=torch.int32)})
    else:
        cache = {"layers": shard_tree(make_cache(cfg, 2, 32, "cpu")["layers"],
                                      cell.in_shardings[1]["layers"]),
                 "enc_out": None}
        args = (params, cache, {"tokens": torch.randint(
            0, cfg.vocab_size, (2, 1), generator=gen, dtype=torch.int32),
            "cache_pos": 31})
    seen = []
    with FlopCounterMode(display=False) as fc, \
            recording(lambda name, *_: seen.append(name)):
        cell.fn(*args)
    assert rec["cost"]["per_device_flops"] == fc.get_total_flops() > 0
    counts = {k[len("count_"):]: v for k, v in rec["collectives"].items()
              if k.startswith("count_")
              and k[len("count_"):] in dryrun._KINDS.values()}
    want = {}
    for name in seen:
        kind = dryrun._KINDS[name]
        want[kind] = want.get(kind, 0) + 1
    assert counts == want and want["all-reduce"] > 0
    if shape == "decode_tiny":
        assert "pmax" in seen
    assert rec["meta"]["entries"] == 8


def test_peak_tracker_on_a_known_sequence():
    live = dryrun.LiveBytes()
    a = torch.empty(1000, dtype=torch.uint8)
    live.add(a)
    b = torch.empty(500, dtype=torch.float32)       # 2,000 bytes
    live.add(b)
    live.add(b[10:])                                # a view: no new bytes
    del a
    c = torch.empty(2500, dtype=torch.uint8)
    live.add(c)                                     # 2,000 + 2,500
    del b, c
    d = torch.empty(4000, dtype=torch.uint8)
    live.add(d)
    assert live.peak == 4500
    live.sweep()
    assert live.upper == 4000


def test_trace_peak_of_a_known_step():
    def fn(x):
        t = torch.empty(1000, dtype=torch.uint8) + 1     # 2 x 1,000 live
        del t
        return x * 2                                     # 400 + 400
    mode = FakeTensorMode()
    with mode:
        x = torch.empty(100)
    tr = dryrun.trace_step(fn, (x,), mode)
    assert tr.argument_bytes == 400 and tr.output_bytes == 400
    assert tr.peak_bytes == 400 + 2000
    assert tr.temp_bytes == 2000 - 400
    assert tr.traffic_bytes == 1000 + 1000 + 400 + 400


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_meshes_refuse_naming_item_5(kind):
    with pytest.raises(NotImplementedError, match="item 5"):
        dryrun.run_cell("qwen3-0.6b", "train_4k", kind, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        dryrun.run_ph_cell("ph_round_64k", kind, device="cpu")


def _ref_tree():
    return ast.parse(open(REF_DRYRUN).read())


def _ref_function(name):
    return next(n for n in ast.walk(_ref_tree())
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _keys(call, terms) -> dict:
    """The keys of a ``dict(...)`` / ``rec.update(...)`` call, nested."""
    out = {}
    for a in call.args:
        if isinstance(a, ast.Name) and a.id == "terms":
            out.update({k: None for k in terms})
    for kw in call.keywords:
        v = kw.value
        out[kw.arg] = _keys(v, terms) if isinstance(v, ast.Call) and \
            isinstance(v.func, ast.Name) and v.func.id == "dict" else None
    return out


def _ref_terms():
    ret = next(n for n in ast.walk(_ref_function("roofline_terms"))
               if isinstance(n, ast.Return))
    return [k.value for k in ret.value.keys]


def _ref_record_keys(fn_name) -> dict:
    fn, terms = _ref_function(fn_name), _ref_terms()
    keys = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and (
                (isinstance(node.func, ast.Name) and node.func.id == "dict"
                 and any(kw.arg == "memory" for kw in node.keywords))
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "rec"
                    and any(kw.arg == "memory" for kw in node.keywords))
                or (isinstance(node.func, ast.Name)
                    and node.func.id == "dict" and any(
                        kw.arg == "overrides" for kw in node.keywords)
                    and any(kw.arg == "arch" for kw in node.keywords))):
            keys.update(_keys(node, terms))
    return keys


def _holds(got: dict, want: dict, extra: dict) -> None:
    """``got`` has ``want``'s keys, nested, and besides them ``extra``'s."""
    assert set(got) == set(want) | set(extra.get("", ())), \
        (sorted(got), sorted(want))
    for k, sub in want.items():
        if sub is not None:
            assert set(got[k]) == set(sub) | set(extra.get(k, ())), k


def test_roofline_terms_keys_and_peaks():
    terms = dryrun.roofline_terms({"bfloat16": 989e12, "float32": 67e12},
                                  3.35e12, {"total": 3.35e12, "ici": 1.0})
    assert list(terms) == _ref_terms()
    assert terms == {"compute_s": 2.0, "memory_s": 1.0, "collective_s": 1.0,
                     "collective_ici_s": 0.0, "collective_dcn_s": 0.0}
    assert dryrun.roofline_terms(989e12, 0.0, {})["compute_s"] == 1.0


@pytest.mark.parametrize("shape", sorted(TINY))
def test_cell_record_has_the_references_keys(tiny_cells, shape):
    rec = dryrun.run_cell("qwen3-0.6b", shape, "card", device="cpu")
    assert rec["status"] == "ok" and rec["compile_s"] == 0.0
    _holds(rec, _ref_record_keys("run_cell"),
           {"cost": ["flops_by_dtype"], "meta": ["entries", "device"]})
    json.dumps(rec)
    r = rec["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["collectives"]["ici"] == rec["collectives"]["dcn"] == 0.0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert len(rec["meta"]["sharding_report"]["replicated"]) <= 40


def test_ph_record_has_the_references_keys():
    for mesh_kind, entries in (("card", 1), ("entries", dryrun.PH_ENTRIES)):
        rec = dryrun.run_ph_cell("ph_round_64k", mesh_kind, device="cpu")
        _holds(rec, _ref_record_keys("run_ph_cell"),
               {"meta": ["entries", "device"]})
        assert rec["meta"]["global_batch"] == 256 * entries
        assert rec["memory"]["argument_bytes"] >= 8 * 2**20 * 65
    assert rec["collectives"]["count_collective-permute"] == 2
    assert rec["collectives"]["total"] > 0


def test_ph_shapes_are_the_references():
    node = next(n for n in _ref_tree().body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "PH_SHAPES")
    # the values are integer literals and powers of them (2**20)
    want = {k.value: {kw.arg: eval(ast.unparse(kw.value), {})
                      for kw in v.keywords}
            for k, v in zip(node.value.keys, node.value.values)}
    assert dryrun.PH_SHAPES == want


def test_skip_record(tiny_cells):
    rec = dryrun.run_cell("qwen3-0.6b", "long_500k", "card", device="cpu")
    assert rec["status"] == "skip" and "quadratic" in rec["skip_reason"]


def test_main_writes_a_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    for arch, shape in (("dory_ph", "ph_round_64k"),
                        ("qwen3-0.6b", "long_500k")):
        monkeypatch.setattr(sys, "argv", [
            "dryrun", "--arch", arch, "--shape", shape, "--mesh", "card",
            "--device", "cpu"])
        with pytest.raises(SystemExit) as exit_:
            dryrun.main()
        assert exit_.value.code == 0
    got = json.load(open(tmp_path / "card" / "dory_ph__ph_round_64k.json"))
    assert got["status"] == "ok" and got["mesh"] == "card"
    skip = json.load(open(tmp_path / "card" / "qwen3_0_6b__long_500k.json"))
    assert skip["status"] == "skip"
    out = capsys.readouterr().out
    assert "[ OK ] dory_ph" in out and "[SKIP] qwen3_0_6b" in out


def test_flash_operator_on_fake_cuda_tensors():
    """The card's route under a trace: the custom operator's fake
    implementation gives the output's shape and its formula 4 · d FLOPs a
    pair attended, as ``FlopCounterMode`` counts it; the plain version
    (its (BH, S, S) scores) never runs."""
    mode = FakeTensorMode()
    with mode:
        q = torch.empty((6, 128, 64), dtype=torch.bfloat16, device="cuda")
    for causal, window in ((True, -1), (True, 32), (False, -1)):
        tr = dryrun.trace_step(
            lambda q: flash_attention(q, q, q, causal, window), (q,), mode)
        want = 4 * 64 * 6 * attended_pairs(128, causal, window)
        assert tr.flops == {"bfloat16": float(want)}
        assert list(tr.ops) == ["flash_attention"]
        assert tuple(tr.out.shape) == (6, 128, 64)
        assert tr.out.device.type == "cuda"
        with mode, FlopCounterMode(display=False) as fc:
            flash_attention(q, q, q, causal, window)
        assert fc.get_total_flops() == want
    assert flash_attention.launches == 0
    assert attended_pairs(128, False, -1) == 128 * 128
    assert attended_pairs(4, True, 2) == 1 + 2 + 2 + 2
