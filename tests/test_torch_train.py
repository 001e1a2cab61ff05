"""The port's trainer on the CPU against the JAX package: the token stream,
the loss, the optimizer and its schedule, the loss function's gradients,
the microbatched train step, activation checkpointing, the flash route's
refusal under autograd, the launcher and the TDA monitor.

Reduced qwen3-0.6b and gemma3-1b compute in float32; weights are carried
across with ``params_from_arrays`` / ``params_to_arrays``.  Tolerances:
tokens, shard maps and the monitor's PH values exactly; ``lm_loss`` rtol
1e-6; the schedule and one AdamW update on identical inputs rtol 1e-6
(``atol`` 1e-9 for moments and weights that round to near zero); the loss
function's gradients leaf by leaf within ``1e-5 * max |leaf|`` (rtol
1e-4), sums in another order; three train steps: loss, gradient norm and lr
rtol 1e-4 each step, and the final weights by the median (<= 1e-7) and the
99.9th percentile (<= 1e-6) of their absolute difference, since at step 1
AdamW turns a near-zero gradient whose last bit differs into a move of
2 lr; microbatching within the port (1 against 4) below 1e-5, as
``tests/test_system.py`` holds the reference; remat exactly.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.data import tokens as jtokens
from repro.launch import train as jlaunch
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_config
from repro_torch.data import tokens as ttokens
from repro_torch.dist.sharding import tree_flatten_with_path, tree_path_str
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCHS = ["qwen3-0.6b", "gemma3-1b"]


def _carried(arch, seed=0):
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu").requires_grad_(True)
    return jcfg, tcfg, jp, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _flat(tree):
    return [(tree_path_str(kp), np.asarray(leaf))
            for kp, leaf in tree_flatten_with_path(tree)[0]]


# ---------------------------------------------------------------------------
# (a) the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 8, 33, 512), (3, 17, 5, 9, 151936), (7, 2, 1, 2, 7),
    (1, 1000, 16, 65, 262144)])
def test_synthetic_tokens_equal_reference(seed, step, batch, seq, vocab):
    want = jtokens.synthetic_tokens(seed, step, batch, seq, vocab)
    got = ttokens.synthetic_tokens(seed, step, batch, seq, vocab)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_batch_at_over_hosts_equals_reference(n_hosts):
    kw = dict(vocab=512, global_batch=8, seq=17, seed=5, n_hosts=n_hosts)
    for host in range(n_hosts):
        want = jtokens.ShardedTokenStream(host_id=host, **kw)
        got = ttokens.ShardedTokenStream(host_id=host, **kw)
        assert got.local_batch == want.local_batch
        for step in (0, 3, 11):
            assert np.array_equal(got.batch_at(step)["tokens"],
                                  want.batch_at(step)["tokens"])
        for a, b, _ in zip(iter(got), iter(want), range(3)):
            assert np.array_equal(a["tokens"], b["tokens"])
        assert got.step == want.step


@settings(deadline=None, max_examples=40)
@given(st.integers(1, 12), st.data())
def test_reassign_shards_equals_reference(n_hosts, data):
    failed = data.draw(st.lists(st.integers(0, n_hosts - 1), unique=True,
                                max_size=n_hosts))
    if len(failed) == n_hosts:
        for fn in (jtokens.reassign_shards, ttokens.reassign_shards):
            with pytest.raises(RuntimeError, match="no survivors"):
                fn(n_hosts, failed)
        return
    assert ttokens.reassign_shards(n_hosts, failed) == \
        jtokens.reassign_shards(n_hosts, failed)


def test_data_package_exports_the_token_pipeline():
    import repro_torch.data as data

    for name in ("ShardedTokenStream", "reassign_shards",
                 "synthetic_tokens"):
        assert getattr(data, name) is getattr(ttokens, name)
        assert name in data.__all__


# ---------------------------------------------------------------------------
# (b) the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,v_pad,z_loss", [(500, 512, 1e-4),
                                                (500, 512, 0.0),
                                                (512, 512, 1e-4),
                                                (151936, 152064, 1e-4)])
def test_lm_loss_matches_reference(vocab, v_pad, z_loss):
    rng = np.random.default_rng(vocab)
    b, s = (2, 3) if v_pad > 1000 else (3, 7)
    logits = (rng.normal(size=(b, s, v_pad)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    want = jts.lm_loss(jnp.asarray(logits), jnp.asarray(labels), vocab,
                       z_loss)
    got = tts.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      vocab, z_loss)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) the schedule and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 20, 100), (1e-3, 30, 300),
                                               (3e-4, 2, 10), (1e-3, 0, 2)])
def test_warmup_cosine_matches_reference(peak, warmup, total):
    jl = jopt.warmup_cosine(peak, warmup, total)
    tl = topt.warmup_cosine(peak, warmup, total)
    for step in range(total + 6):
        want = float(jl(jnp.asarray(step, jnp.int32)))
        got = tl(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=step)


def _opt_inputs(grad_scale, seed=0):
    """A params tree in the reference's nested layout, grads, and an AdamW
    state three steps in with non-zero moments."""
    rng = np.random.default_rng(seed)

    def tree(f):
        return {"embed": {"table": f((33, 8))},
                "groups": [{"blk": {"w": f((2, 8, 16)), "b": f((2, 16))}}],
                "norm": {"scale": f((8,))}}

    params = tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = tree(lambda s: (rng.normal(size=s) * grad_scale)
                 .astype(np.float32))
    m = tree(lambda s: (rng.normal(size=s) * 0.01).astype(np.float32))
    v = tree(lambda s: (rng.random(size=s) * 1e-4).astype(np.float32))
    return params, grads, m, v


@pytest.mark.parametrize("grad_scale,clip_norm", [(10.0, 1.0), (1e-3, 1.0),
                                                  (1.0, 0.0), (1.0, 1e6)])
def test_adamw_update_matches_reference(grad_scale, clip_norm):
    """One update on identical params, grads and state: clipping hit
    (large grads), not hit (small grads, a huge norm) and off."""
    params, grads, m, v = _opt_inputs(grad_scale)
    kw = dict(weight_decay=0.1, clip_norm=clip_norm)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10), **kw)
    to = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10), **kw)
    j = jax.tree.map(jnp.asarray, (grads, params, m, v))
    want_p, want_s, want_n = jo.update(
        j[0], jopt.AdamWState(step=jnp.asarray(3, jnp.int32), m=j[2],
                              v=j[3]), j[1])
    t = jax.tree.map(torch.from_numpy, (grads, params, m, v))
    got_p, got_s, got_n = to.update(
        t[0], topt.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                              m=t[2], v=t[3]), t[1])
    assert int(got_s.step) == int(want_s.step) == 4
    assert got_s.step.dtype == torch.int32
    np.testing.assert_allclose(float(got_n), float(want_n), rtol=1e-6)
    for what, a, b in (("params", got_p, want_p), ("m", got_s.m, want_s.m),
                       ("v", got_s.v, want_s.v)):
        fa, fb = _flat(a), _flat(b)
        assert [n for n, _ in fa] == [n for n, _ in fb]
        for (name, x), (_, y) in zip(fa, fb):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-9,
                                       err_msg=f"{what} {name}")
    # the inputs are left as they were (a functional update)
    assert np.array_equal(t[1]["embed"]["table"].numpy(),
                          params["embed"]["table"])


def test_adamw_init_and_global_norm():
    params, grads, _, _ = _opt_inputs(1.0)
    to = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    state = to.init(jax.tree.map(torch.from_numpy, params))
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for name, a in _flat(state.m) + _flat(state.v):
        assert a.dtype == np.float32 and not a.any(), name
    want = jopt.global_norm(jax.tree.map(jnp.asarray, grads))
    got = topt.global_norm(jax.tree.map(torch.from_numpy, grads))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# (d) the loss function's gradients
# ---------------------------------------------------------------------------

def _port_grads(model, loss_fn, batch):
    tot, (loss, aux) = loss_fn(model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(tot, list(named.values()))
    return float(tot.detach()), float(loss.detach()), ttf.arrays_from_named(
        dict(zip(named, grads)), model.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_match_reference(arch):
    jcfg, tcfg, jp, model = _carried(arch)
    toks = _tokens(jcfg, 3, 17, 1)
    (jtot, (jloss, jaux)), jg = jax.value_and_grad(
        jts.make_loss_fn(jcfg), has_aux=True)(jp, {"tokens":
                                                   jnp.asarray(toks)})
    tot, loss, tg = _port_grads(model, tts.make_loss_fn(tcfg),
                                {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    np.testing.assert_allclose(tot, float(jtot), rtol=1e-6)
    want, got = _flat(jax.tree.map(np.asarray, jg)), _flat(tg)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# (e), (f) the train step
# ---------------------------------------------------------------------------

def _port_state(tcfg, jp, opt):
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu").requires_grad_(True)
    return tts.TrainState(params=model,
                          opt=opt.init(dict(model.named_parameters())))


def _hold_weights(got_tree, want_tree):
    """Median and 99.9th percentile of |port - reference| over every
    weight; the message names the largest outlier."""
    got, want = _flat(got_tree), _flat(want_tree)
    assert [n for n, _ in got] == [n for n, _ in want]
    diffs = [np.abs(a - b).ravel() for (_, a), (_, b) in zip(got, want)]
    d = np.concatenate(diffs)
    i = int(np.argmax(d))
    off = np.cumsum([0] + [x.size for x in diffs])
    leaf = int(np.searchsorted(off, i, side="right") - 1)
    name, a = got[leaf]
    idx = np.unravel_index(i - off[leaf], a.shape)
    where = (f"largest |diff| {d[i]:.3g} at {name}{list(idx)}: port "
             f"{a[idx]!r}, reference {want[leaf][1][idx]!r}")
    assert np.median(d) <= 1e-7, f"median {np.median(d)}; {where}"
    assert np.quantile(d, 0.999) <= 1e-6, \
        f"99.9th percentile {np.quantile(d, 0.999)}; {where}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(arch, n_micro):
    jcfg, tcfg, jp, _ = _carried(arch)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    to = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jts.make_train_step(jcfg, jo, n_micro=n_micro))
    tstep = tts.make_train_step(tcfg, to, n_micro=n_micro)
    js = jts.TrainState(params=jp, opt=jo.init(jp))
    ts = _port_state(tcfg, jp, to)
    for step in range(3):
        toks = _tokens(jcfg, 4, 17, 10 + step)
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=f"{k} step {step}")
    arrays = tts.train_state_to_arrays(ts)
    assert int(arrays.opt.step) == int(js.opt.step) == 3
    _hold_weights(arrays.params, jax.tree.map(np.asarray, js.params))
    _hold_weights(arrays.opt.m, jax.tree.map(np.asarray, js.opt.m))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "glm4-9b",
                                  "granite-34b"])
def test_one_train_step_matches_reference_new_archs(arch):
    """One step of the MoE, MLA and larger dense models, in 2
    microbatches: loss, the MoE aux loss (> 0 with experts), gradient
    norm and lr rtol 1e-4; the weights and first moments as
    :func:`_hold_weights` holds them."""
    jcfg, tcfg, jp, _ = _carried(arch)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    to = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    js = jts.TrainState(params=jp, opt=jo.init(jp))
    ts = _port_state(tcfg, jp, to)
    toks = _tokens(jcfg, 4, 17, 20)
    js, jm = jax.jit(jts.make_train_step(jcfg, jo, n_micro=2))(
        js, {"tokens": jnp.asarray(toks)})
    ts, tm = tts.make_train_step(tcfg, to, n_micro=2)(
        ts, {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert (float(tm["aux_loss"]) > 0) == (tcfg.moe is not None)
    arrays = tts.train_state_to_arrays(ts)
    _hold_weights(arrays.params, jax.tree.map(np.asarray, js.params))
    _hold_weights(arrays.opt.m, jax.tree.map(np.asarray, js.opt.m))


def test_grad_accum_is_a_rebracketing():
    """n_micro 1 and 4 give the same update within the port (float32
    accumulation of g / n_micro), as ``tests/test_system.py`` holds the
    reference."""
    cfg = get_config("qwen3_0_6b", reduced=True)
    opt = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    toks = torch.from_numpy(_tokens(cfg, 8, 17, 0))
    outs = []
    for n_micro in (1, 4):
        state = tts.init_train_state(cfg, opt, seed=0, device="cpu")
        state, metrics = tts.make_train_step(cfg, opt, n_micro=n_micro)(
            state, {"tokens": toks})
        outs.append((state, metrics))
    (s1, m1), (s4, m4) = outs
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    worst = max(float((a - b).detach().abs().max()) for a, b in
                zip(s1.params.parameters(), s4.params.parameters()))
    assert worst < 1e-5, f"microbatching changed the update: {worst}"


def test_train_step_refusals_name_item_10():
    cfg = get_config("qwen3_0_6b", reduced=True)
    opt = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    with pytest.raises(NotImplementedError, match="item 10"):
        tts.make_train_step(cfg, opt, micro_batch_axes=("data",))
    step = tts.make_train_step(cfg, opt)
    state = tts.init_train_state(cfg, opt, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 9, 0))
    for extra in ({"positions3": torch.zeros((3, 2, 9), dtype=torch.int32)},
                  {"embeds": torch.zeros((2, 9, cfg.d_model))}):
        with pytest.raises(NotImplementedError, match="item 10"):
            step(state, dict(extra, tokens=toks))


def test_init_train_state_is_seeded_and_trainable():
    cfg = get_config("gemma3_1b", reduced=True)
    opt = topt.AdamW(lr=topt.warmup_cosine(1e-3, 2, 10))
    a = tts.init_train_state(cfg, opt, seed=3, device="cpu")
    b = tts.init_train_state(cfg, opt, seed=3, device="cpu")
    assert all(p.requires_grad for p in a.params.parameters())
    assert all(torch.equal(p, q) for p, q in zip(a.params.parameters(),
                                                 b.params.parameters()))
    assert sorted(a.opt.m) == sorted(n for n, _ in
                                     a.params.named_parameters())
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tts.init_train_state(cfg, opt, seed=3)


# ---------------------------------------------------------------------------
# (g) activation checkpointing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(remat):
    import dataclasses

    cfg = get_config("gemma3_1b", reduced=True)
    toks = torch.from_numpy(_tokens(cfg, 2, 17, 4))
    grads = {}
    for policy in ("none", remat):
        c = dataclasses.replace(cfg, remat=policy)
        model = ttf.init_params(c, seed=1, device="cpu").requires_grad_(True)
        tot, _ = tts.make_loss_fn(c)(model, {"tokens": toks})
        grads[policy] = torch.autograd.grad(tot, list(model.parameters()))
    for a, b in zip(grads["none"], grads[remat]):
        assert torch.equal(a, b)


def test_remat_dots_saves_the_products_without_batch_dims():
    """Under ``"dots"`` the block's backward recomputes the attention's
    batched products and none of its ``x @ w`` projections."""
    import dataclasses
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    cfg = get_config("qwen3_0_6b", reduced=True)
    toks = torch.from_numpy(_tokens(cfg, 2, 9, 2))
    counts = {}
    for policy in ("none", "dots", "full"):
        c = dataclasses.replace(cfg, remat=policy)
        model = ttf.init_params(c, seed=1, device="cpu").requires_grad_(True)
        tot, _ = tts.make_loss_fn(c)(model, {"tokens": toks})
        with Count() as mode:
            torch.autograd.grad(tot, list(model.parameters()))
        counts[policy] = {op: sum(o is op for o in mode.ops) for op in
                          (torch.ops.aten.mm.default,
                           torch.ops.aten.bmm.default)}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert counts["dots"][mm] == counts["none"][mm] < counts["full"][mm]
    assert counts["none"][bmm] < counts["dots"][bmm] == counts["full"][bmm]


# ---------------------------------------------------------------------------
# (h) the flash route under autograd
# ---------------------------------------------------------------------------

def test_flash_route_raises_under_autograd():
    cfg = get_config("qwen3_0_6b", reduced=True)
    model = ttf.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 9, 0))
    ttf.forward(model, {"tokens": toks})        # frozen weights: serving
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        ttf.forward(model, {"tokens": toks})
    with torch.no_grad():
        flash, _ = ttf.forward(model, {"tokens": toks})
    pos = torch.arange(9).expand(2, 9)
    logits, _ = ttf.forward(model, {"tokens": toks, "positions": pos})
    assert logits.requires_grad
    torch.testing.assert_close(logits.detach(), flash, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# (k) the launcher
# ---------------------------------------------------------------------------

def _seed_ckpt(directory, jcfg, seed=0):
    """The reference's initial train state as a step -1 checkpoint, so a
    ``restore=True`` run of either package starts at step 0 from the same
    weights."""
    from repro.checkpoint import Checkpointer as JCheckpointer

    opt = jopt.AdamW(lr=jopt.warmup_cosine(3e-4, 20, 100))
    state = jts.init_train_state(jcfg, opt, jax.random.PRNGKey(seed))
    JCheckpointer(directory).save(-1, state, metadata={"step": -1})


def _quiet(fn, *a, **k):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a, **k)
    return res, out.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
def test_run_history_matches_reference(tmp_path, arch):
    jcfg, tcfg = jax_get_config(arch, reduced=True), get_config(arch,
                                                                reduced=True)
    kw = dict(steps=4, global_batch=4, seq_len=16, n_micro=2, lr=1e-3,
              warmup=2, ckpt_every=10_000, log_every=1)
    for d in ("j", "t"):
        _seed_ckpt(str(tmp_path / d), jcfg)
    want, want_out = _quiet(jlaunch.run, jlaunch.TrainJob(
        cfg=jcfg, ckpt_dir=str(tmp_path / "j"), **kw), restore=True)
    got, got_out = _quiet(tlaunch.run, tlaunch.TrainJob(
        cfg=tcfg, ckpt_dir=str(tmp_path / "t"), device="cpu", **kw),
        restore=True)
    assert [h["step"] for h in got["history"]] == [0, 1, 2, 3]
    assert [sorted(h) for h in got["history"]] == \
        [sorted(h) for h in want["history"]]
    for g, w in zip(got["history"], want["history"]):
        for k in ("loss", "grad_norm", "lr", "aux_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       err_msg=f"{k} step {w['step']}")
    assert [list(json.loads(ln)) for ln in got_out.splitlines()] == \
        [list(json.loads(ln)) for ln in want_out.splitlines()]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


def test_run_resumes_as_uninterrupted(tmp_path):
    cfg = get_config("qwen3_0_6b", reduced=True)
    job = tlaunch.TrainJob(cfg=cfg, steps=6, global_batch=4, seq_len=16,
                           n_micro=2, lr=1e-3, warmup=2, ckpt_every=3,
                           log_every=1, ckpt_dir=str(tmp_path), device="cpu")
    whole, _ = _quiet(tlaunch.run, job)
    os.rename(tmp_path / "step_0000000005", tmp_path / "step_0000000005.tmp")
    resumed, _ = _quiet(tlaunch.run, job, restore=True)
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    assert resumed["history"] == whole["history"][4:]
    for a, b in zip(whole["state"].params.parameters(),
                    resumed["state"].params.parameters()):
        assert torch.equal(a, b)


def test_traced_run_spans_every_step():
    """With tracing on, one ``train/step`` span a step, logged or not,
    each carrying its step."""
    from repro_torch.obs.trace import Tracer, tracing

    job = tlaunch.TrainJob(cfg=get_config("qwen3_0_6b", reduced=True),
                           steps=4, global_batch=2, seq_len=8, log_every=3,
                           device="cpu")
    tr = Tracer()
    with tracing(tr):
        out, _ = _quiet(tlaunch.run, job)
    spans = [sp for sp in tr.spans if sp.name == "train/step"]
    assert [sp.attrs["step"] for sp in spans] == [0, 1, 2, 3]
    assert [h["step"] for h in out["history"]] == [0, 3]
    assert all(sp.dur > 0 for sp in spans)


def test_run_refuses_a_mesh():
    job = tlaunch.TrainJob(cfg=get_config("qwen3_0_6b", reduced=True),
                           mesh_shape=(2, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        tlaunch.run(job)


def test_cli_prints_the_reference_lines():
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "15", "--batch",
            "8", "--seq", "32"]
    _, out = _quiet(tlaunch.main, argv + ["--device", "cpu"])
    lines = out.splitlines()
    rows = [json.loads(ln) for ln in lines[:-1]]
    assert [r["step"] for r in rows] == [0, 10, 14]
    assert all(list(r) == ["aux_loss", "grad_norm", "loss", "lr", "step"]
               for r in rows)
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert lines[-1].startswith("done: 15 steps in ")
    assert lines[-1].split("final loss ")[1] == f"{rows[-1]['loss']:.4f}"


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b", "glm4-9b",
                                  "granite-34b"])
def test_cli_trains_the_new_archs(arch):
    """``--arch`` takes the four architectures of the MoE/MLA slice; the
    MoE models log a positive aux loss."""
    argv = ["--arch", arch, "--reduced", "--steps", "3", "--batch", "4",
            "--seq", "16", "--n-micro", "2", "--device", "cpu"]
    _, out = _quiet(tlaunch.main, argv)
    lines = out.splitlines()
    rows = [json.loads(ln) for ln in lines[:-1]]
    assert [r["step"] for r in rows] == [0, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert all((r["aux_loss"] > 0) == ("moe" in arch or "deepseek" in arch)
               for r in rows)
    assert lines[-1].startswith("done: 3 steps in ")


# ---------------------------------------------------------------------------
# (l) the TDA monitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_tda_summary_matches_reference(monkeypatch, seed):
    """Given the reference's logits, the monitor's PH part returns the
    reference's values exactly."""
    cfg = jax_get_config("qwen3-0.6b", reduced=True)
    params = jtf.init_params(cfg, jax.random.PRNGKey(seed))
    batch = {"tokens": _tokens(cfg, 4, 17, seed)}
    sub = {"tokens": jnp.asarray(batch["tokens"][:4, :-1])}
    logits, _ = jtf.forward(params, cfg, sub)
    monkeypatch.setattr(jtf, "forward",
                        lambda p, c, b: (logits, jnp.zeros(())))
    want = jlaunch.tda_monitor(params, cfg, batch)
    got = tlaunch._tda_summary(
        np.asarray(logits[..., :64], dtype=np.float64), "cpu")
    assert got == want


def test_tda_monitor_on_hidden_states():
    cfg = get_config("qwen3_0_6b", reduced=True)
    model = ttf.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    batch = {"tokens": _tokens(cfg, 4, 17, 0)}
    out = tlaunch.tda_monitor(model, cfg, batch)
    assert sorted(out) == ["tda_b0", "tda_h0_pairs", "tda_h1_pairs"]
    assert out["tda_h0_pairs"] > 0
    assert np.isfinite(list(out.values())).all()
