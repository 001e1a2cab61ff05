"""The port's transformer and serving engine on the CPU against the JAX
package, with weights carried across (``params_from_arrays``), for reduced
qwen3-0.6b and gemma3-1b (gemma3's local layers exercise the flash
route's window mask through the model).

Tolerances: logits ``rtol = atol = 2e-4`` (reduced configs compute in
float32; sums in another order), as ``tests/test_archs.py`` holds decode
against forward.  Generated tokens are compared exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.steps import extend_cache as jax_extend_cache
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.config import MoEConfig
from repro_torch.serve import steps as tsteps
from repro_torch.serve.engine import Request, ServeEngine

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["qwen3-0.6b", "gemma3-1b"]


def _models(arch, seed=0):
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu")
    return jcfg, tcfg, jp, model


def test_configs_equal_reference():
    for arch in ARCHS:
        for reduced in (False, True):
            j = jax_get_config(arch, reduced=reduced)
            t = get_config(arch, reduced=reduced)
            for f in j.__dataclass_fields__:
                assert getattr(j, f) == getattr(t, f), (arch, f)
            assert t.cdtype == getattr(torch, str(j.cdtype))
            assert t.pdtype == getattr(torch, str(j.pdtype))


SERVE_EXPORTS = ("ServeEngine", "Request", "extend_cache",
                 "make_prefill_step", "make_decode_step", "sample_greedy",
                 "AdmissionDecision", "PHRequest", "PHResponse",
                 "PHServeEngine", "fingerprint_points")


@pytest.mark.parametrize("name", SERVE_EXPORTS)
def test_serve_package_exports(name):
    """``repro_torch.serve`` re-exports the ported names of
    ``repro.serve``, the PH service's included; ``sample_temperature``
    (item 10) stays absent until it is ported."""
    import repro.serve
    import repro_torch.serve

    assert hasattr(repro.serve, name)
    got = getattr(repro_torch.serve, name)
    assert got.__module__.startswith("repro_torch.serve.")
    assert name in repro_torch.serve.__all__
    assert not hasattr(repro_torch.serve, "sample_temperature")


def test_get_config_loads_the_ports_modules():
    cfg = get_config("qwen3-0.6b")
    assert type(cfg).__module__ == "repro_torch.models.config"
    assert sys.modules["repro_torch.configs.qwen3_0_6b"].CONFIG is cfg
    with pytest.raises(NotImplementedError, match="item 10"):
        get_config("deepseek-v2-lite-16b")


def test_port_serves_with_jax_and_repro_blocked():
    """The configs' string import resolves inside repro_torch: build a
    reduced qwen3 and run one prefill with jax and repro unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.transformer import init_params\n"
        "from repro_torch.serve.steps import make_prefill_step\n"
        "cfg = get_config('qwen3-0.6b', reduced=True)\n"
        "m = init_params(cfg, 0, 'cpu')\n"
        "logits, cache = make_prefill_step(cfg)(m, {'tokens': "
        "torch.zeros((2, 8), dtype=torch.int32)})\n"
        "assert logits.shape == (2, 8, cfg.padded_vocab), logits.shape\n"
        "assert len(cache['layers']) == cfg.n_layers\n"
        "assert type(cfg).__module__ == 'repro_torch.models.config'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, model = _models(arch)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want, _, jcache = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                  return_caches=True)
    got, aux, tcache = ttf.forward(model, {"tokens": torch.from_numpy(toks)},
                                   return_caches=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jk, jv = jcache["layers"][0]["attn_mlp_0"]
    for i, (k, v) in enumerate(tcache["layers"]):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk[i]), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv[i]), **TOL)
    # explicit positions take _sdpa_masked: same logits
    pos = torch.arange(16).expand(2, 16)
    alt, _ = ttf.forward(model, {"tokens": torch.from_numpy(toks),
                                 "positions": pos})
    np.testing.assert_allclose(alt.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jcfg, tcfg, jp, model = _models(arch, seed=2)
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    _, _, jc = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :6])},
                           return_caches=True)
    jc = jax_extend_cache(jcfg, jc, 6, 12)
    _, tc = tsteps.make_prefill_step(tcfg)(
        model, {"tokens": torch.from_numpy(toks[:, :6])})
    tc = tsteps.extend_cache(tcfg, tc, 6, 12)
    assert tc["layers"][0][0].shape == (2, 12, tcfg.n_kv_heads,
                                        tcfg.head_dim_)
    decode = tsteps.make_decode_step(tcfg)
    for i in range(6, 9):
        want, jc = jtf.decode_step(jp, jcfg, jc, {
            "tokens": jnp.asarray(toks[:, i:i + 1]),
            "cache_pos": jnp.int32(i)})
        got, tc = decode(model, tc, {"tokens": torch.from_numpy(
            toks[:, i:i + 1]), "cache_pos": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_from_an_empty_cache_matches_forward():
    """make_cache's zero cache, filled by decode steps from position 0."""
    cfg = get_config("gemma3-1b", reduced=True)
    model = ttf.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    full, _ = ttf.forward(model, {"tokens": toks})
    cache = ttf.make_cache(cfg, 2, 6, "cpu")
    for i in range(6):
        logits, cache = ttf.decode_step(model, cache, {
            "tokens": toks[:, i:i + 1], "cache_pos": i})
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, i].numpy(),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_suffix(arch):
    """Decode logits match teacher-forced forward logits (the port's own
    cache path against its flash-route prefill)."""
    cfg = get_config(arch, reduced=True)
    model = ttf.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32))
    full, _ = ttf.forward(model, {"tokens": toks})
    _, _, caches = ttf.forward(model, {"tokens": toks[:, :4]},
                               return_caches=True)
    cache = tsteps.extend_cache(cfg, caches, 4, 8)
    for i in range(4, 8):
        logits, cache = ttf.decode_step(model, cache, {
            "tokens": toks[:, i:i + 1], "cache_pos": i})
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, i].numpy(),
                                   **TOL)


def _requests(cfg, n, prompt_len, seed=0):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, cfg.vocab_size,
                               size=int(rng.integers(3, prompt_len + 3)),
                               dtype=np.int32)) for uid in range(n)]


def test_serve_engine_matches_jax():
    jcfg, tcfg, jp, model = _models("qwen3-0.6b", seed=4)
    kw = dict(max_batch=2, prompt_len=8, s_max=16)
    jeng = JServeEngine(jcfg, params=jp, **kw)
    teng = ServeEngine(tcfg, params=model, device="cpu", **kw)
    for uid, prompt in _requests(tcfg, 5, 8):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new=4))
        teng.submit(Request(uid=uid, prompt=prompt, max_new=4))
    want, got = jeng.run(), teng.run()
    assert got == want
    assert len(got) == 5 and all(len(v) == 4 for v in got.values())
    assert set(teng.stats()) == set(jeng.stats())
    assert teng.stats() == jeng.stats()


def test_serve_engine_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(get_config("qwen3-0.6b", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_params(get_config("qwen3-0.6b", reduced=True), 0)


def test_serve_engine_rejects_params_on_another_device():
    cfg = get_config("qwen3-0.6b", reduced=True)
    model = ttf.init_params(cfg, 0, "cpu")
    eng = ServeEngine(cfg, params=model, device="cpu")
    assert eng.params is model
    model.to("meta")
    with pytest.raises(ValueError, match="params on meta"):
        ServeEngine(cfg, params=model, device="cpu")


@pytest.mark.parametrize("change", [
    dict(moe=MoEConfig(n_experts=4, top_k=2, d_expert=32)),
    dict(enc_dec=True), dict(rope_kind="mrope"),
    dict(input_kind="embeddings")])
def test_unported_configs_raise(change):
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              **change)
    with pytest.raises(NotImplementedError, match="item 10"):
        ttf.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tsteps.make_prefill_step(cfg)


def test_init_params_is_seeded():
    cfg = get_config("gemma3-1b", reduced=True)
    a = ttf.init_params(cfg, 5, "cpu")
    b = ttf.init_params(cfg, 5, "cpu")
    c = ttf.init_params(cfg, 6, "cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed"], pc["embed"])
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    assert ttf.count_params(a) == jtf.count_params(jp)
    assert [blk.window for blk in a.blocks] == [
        jcfg.window_for_layer(i) for i in range(jcfg.n_layers)]


def test_sample_greedy_takes_the_first_of_ties():
    logits = torch.zeros((2, 3, 6))
    logits[0, -1, [1, 4]] = 2.0
    logits[1, -1, :] = 1.0
    got = tsteps.sample_greedy(logits)
    assert got.dtype == torch.int32 and got.tolist() == [[1], [0]]


def test_launch_serve_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.run_tokens(serve_args(requests=3, max_new=2))
    assert sorted(done) == [0, 1, 2]
    assert "served 3/3 requests" in capsys.readouterr().out
    # the PH workload, on a small cut of its traffic, runs to its summary
    serve.main(["--workload", "ph", "--device", "cpu", "--requests", "4",
                "--cloud-size", "16", "--reduce-engine", "packed"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 4/4 PH requests in ")
    assert [ln.split(" = ")[0].strip() for ln in out[1:]] == [
        "serve_ph_n_cold", "serve_ph_n_batched", "serve_ph_n_warm_tau",
        "serve_ph_n_warm_points", "serve_ph_n_rejected",
        "serve_ph_store_bytes"]


def serve_args(**kw):
    import argparse
    base = dict(workload="tokens", requests=16, seed=0, arch="qwen3-0.6b",
                full=False, device="cpu", max_batch=8, prompt_len=32,
                max_new=24, s_max=128)
    base.update(kw)
    return argparse.Namespace(**base)
