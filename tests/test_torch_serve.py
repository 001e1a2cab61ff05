"""The port's transformer and serving engine on the CPU against the JAX
package, with weights carried across (``params_from_arrays``), for reduced
qwen3-0.6b and gemma3-1b (gemma3's local layers exercise the flash
route's window mask through the model), and the engine for the MoE and
MLA architectures and the two larger dense ones; the configs of every
ported architecture; ``sample_temperature``'s contract.

Tolerances: logits ``rtol = atol = 2e-4`` (reduced configs compute in
float32; sums in another order), as ``tests/test_archs.py`` holds decode
against forward.  Generated tokens are compared exactly.

``sample_temperature`` cannot draw ``jax.random.categorical``'s tokens
from a torch generator, so its contract is the port's own: the same seed
gives the same tokens on the same device; over many draws the
frequencies match ``softmax(logits / temperature)`` (each within five
standard errors of a binomial count); at ``temperature -> 0`` the result
is ``sample_greedy``'s.
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
from repro_torch.configs import PORTED, get_config
from repro_torch.models import transformer as ttf
from repro_torch.models.config import MoEConfig, RGLRUConfig, XLSTMConfig
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
    """Every ported architecture's config, full and reduced, field by
    field (``dataclasses.asdict``, the MoE and MLA sub-configs too)."""
    import dataclasses

    for arch in PORTED:
        for reduced in (False, True):
            j = jax_get_config(arch, reduced=reduced)
            t = get_config(arch, reduced=reduced)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            assert t.cdtype == getattr(torch, str(j.cdtype))
            assert t.pdtype == getattr(torch, str(j.pdtype))


SERVE_EXPORTS = ("ServeEngine", "Request", "extend_cache",
                 "make_prefill_step", "make_decode_step", "sample_greedy",
                 "sample_temperature", "AdmissionDecision", "PHRequest",
                 "PHResponse", "PHServeEngine", "fingerprint_points")


@pytest.mark.parametrize("name", SERVE_EXPORTS)
def test_serve_package_exports(name):
    """``repro_torch.serve`` re-exports every name of ``repro.serve``,
    the PH service's and ``sample_temperature`` included."""
    import repro.serve
    import repro_torch.serve

    assert hasattr(repro.serve, name)
    got = getattr(repro_torch.serve, name)
    assert got.__module__.startswith("repro_torch.serve.")
    assert name in repro_torch.serve.__all__
    assert sorted(repro_torch.serve.__all__) == sorted(SERVE_EXPORTS)


def test_get_config_loads_the_ports_modules():
    cfg = get_config("qwen3-0.6b")
    assert type(cfg).__module__ == "repro_torch.models.config"
    assert sys.modules["repro_torch.configs.qwen3_0_6b"].CONFIG is cfg
    with pytest.raises(NotImplementedError, match="item 10"):
        get_config("xlstm-1.3b")


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
    dict(xlstm=XLSTMConfig(slstm_every=2, chunk=8)),
    dict(enc_dec=True), dict(rope_kind="mrope"),
    dict(input_kind="embeddings"),
    dict(rglru=RGLRUConfig(d_rnn=64, attn_window=16))])
def test_unported_configs_raise(change):
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              **change)
    with pytest.raises(NotImplementedError, match="item 10"):
        ttf.init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tsteps.make_prefill_step(cfg)


def test_moe_on_a_dense_config_builds_and_matches_jax():
    """An MoE FFN on qwen3's reduced config (refused until MoE was
    ported) builds, and its forward and aux match the reference's."""
    import dataclasses

    moe = dict(moe=MoEConfig(n_experts=4, top_k=2, d_expert=32))
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               **moe)
    tcfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True), **moe)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu")
    assert all(blk.kind == "attn_moe" for blk in model.blocks)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, want_aux = jtf.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = ttf.forward(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert float(aux) > 0


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


NEW_ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "glm4-9b",
             "granite-34b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_engine_matches_jax_new_archs(arch):
    """The engine, unchanged, serves the MoE, MLA and larger dense models:
    the same tokens as the reference's engine (left-padded prompts take
    MoE capacity at prefill in both)."""
    jcfg, tcfg, jp, model = _models(arch, seed=4)
    kw = dict(max_batch=2, prompt_len=8, s_max=16)
    jeng = JServeEngine(jcfg, params=jp, **kw)
    teng = ServeEngine(tcfg, params=model, device="cpu", **kw)
    for uid, prompt in _requests(tcfg, 3, 8, seed=1):
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new=3))
        teng.submit(Request(uid=uid, prompt=prompt, max_new=3))
    want, got = jeng.run(), teng.run()
    assert got == want
    assert len(got) == 3 and all(len(v) == 3 for v in got.values())
    assert teng.stats() == jeng.stats()


def _draws(logits, seed, n, temperature=1.0):
    gen = torch.Generator().manual_seed(seed)
    return torch.cat([tsteps.sample_temperature(logits, gen, temperature)
                      for _ in range(n)], dim=1)


def test_sample_temperature_is_seeded():
    logits = torch.from_numpy(np.random.default_rng(8).normal(
        size=(3, 2, 50)).astype(np.float32))
    a, b = _draws(logits, 3, 20), _draws(logits, 3, 20)
    assert a.dtype == torch.int32 and a.shape == (3, 20)
    assert torch.equal(a, b)
    assert not torch.equal(a, _draws(logits, 4, 20))
    one = tsteps.sample_temperature(logits, torch.Generator().manual_seed(3))
    assert one.shape == (3, 1) and torch.equal(one[:, 0], a[:, 0])


@pytest.mark.parametrize("temperature", [1.0, 0.5, 2.0])
def test_sample_temperature_frequencies_follow_the_softmax(temperature):
    """Each token's share of 20,000 draws within five binomial standard
    errors of ``softmax(logits[:, -1] / temperature)``."""
    logits = torch.tensor([[[9.0, 0.0, 0.0],
                            [0.0, 1.0, -1.0]]])      # only the last counts
    logits = torch.cat([logits, torch.tensor([[[0.2, 0.5, 0.0]]])], dim=1)
    n = 20_000
    gen = torch.Generator().manual_seed(11)
    got = tsteps.sample_temperature(logits.expand(n, 3, 3), gen,
                                    temperature)[:, 0]
    freq = torch.bincount(got.long(), minlength=3).double() / n
    p = torch.softmax(logits[0, -1].double() / temperature, dim=-1)
    se = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= 5 * se), (freq, p)


def test_sample_temperature_at_zero_is_greedy():
    logits = torch.from_numpy(np.random.default_rng(9).normal(
        size=(16, 3, 200)).astype(np.float32))
    greedy = tsteps.sample_greedy(logits)
    for seed in range(3):
        got = tsteps.sample_temperature(
            logits, torch.Generator().manual_seed(seed), 1e-7)
        assert torch.equal(got, greedy)


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


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "glm4-9b",
                                  "granite-34b"])
def test_launch_serve_new_archs_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--max-new", "2", "--prompt-len", "8", "--s-max", "16"])
    assert "served 3/3 requests" in capsys.readouterr().out


def serve_args(**kw):
    import argparse
    base = dict(workload="tokens", requests=16, seed=0, arch="qwen3-0.6b",
                full=False, device="cpu", max_batch=8, prompt_len=32,
                max_new=24, s_max=128)
    base.update(kw)
    return argparse.Namespace(**base)
