"""The port's entry points take the reference's parameters in the
reference's order, with only a trailing ``device`` added where they run
on the card and nothing added where they run on the host only, raise the
reference's ``ValueError`` where it does, take the port's own mesh and
nothing else for ``mesh=``, and refuse each value they cannot take yet
with ``NotImplementedError`` naming its ROADMAP.md item.  The GF(2)
sanitizer (``sanitize=True``, ``REPRO_SANITIZE``), refused until it was
ported, runs and matches the reference."""
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import build_filtration as ref_build
from repro.core import compute_ph as ref_compute_ph
from repro.core.h0 import compute_h0 as ref_h0
from repro.core.homology import make_h1_adapter as ref_h1_adapter
from repro.core import resume as ref_resume
from repro.core.packed_reduce import reduce_dimension_packed as ref_packed
from repro.core.reduction import clearance_commit as ref_clearance
from repro.core.reduction import reduce_dimension as ref_reduce
from repro.core.reduction import seed_column as ref_seed_column
from repro.core.serial_parallel import reduce_dimension_batched as ref_batched
from repro.scale.sparse_input import build_filtration_coo as ref_coo
from repro.analyze import __main__ as ref_analyze_main
from repro.analyze import collectives as ref_collectives
from repro.analyze import lint as ref_lint
from repro.serve import ph as ref_ph
from repro_torch import compute_ph
from repro_torch.analyze import __main__ as analyze_main
from repro_torch.analyze import collectives, lint
from repro_torch.core.filtration import build_filtration
from repro_torch.core.h0 import compute_h0
from repro_torch.core.homology import make_h1_adapter
from repro_torch.core import resume
from repro_torch.core.packed_reduce import reduce_dimension_packed
from repro_torch.core.reduction import (clearance_commit, reduce_dimension,
                                        seed_column)
from repro_torch.core.serial_parallel import reduce_dimension_batched
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.scale import build_filtration_coo
from repro_torch.serve import ph


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


def _same_default(a, b) -> bool:
    return (a.default is b.default or a.default == b.default
            or (isinstance(a.default, float) and np.isnan(a.default)
                and np.isnan(b.default)))


@pytest.mark.parametrize("ref,port", [(ref_compute_ph, compute_ph),
                                      (ref_packed, reduce_dimension_packed),
                                      (ref_resume.make_reducer,
                                       resume.make_reducer),
                                      (ref_collectives.check_repo,
                                       collectives.check_repo),
                                      (ref_collectives.repo_programs,
                                       collectives.repo_programs)])
def test_signature_matches_reference(ref, port):
    want, got = _params(ref), _params(port)
    assert [p.name for p in got] == [p.name for p in want] + ["device"]
    for a, b in zip(want, got):
        assert a.kind == b.kind, a.name
        assert _same_default(a, b), a.name
    assert got[-1].default is None


_RESUME = ("cold_reduce", "warm_tau_growth", "edge_order_map",
           "warm_point_arrival", "split_batch_state", "union_filtration",
           "batched_cold_reduce", "canonical_diagram")


@pytest.mark.parametrize("ref,port", [
    (ref_reduce, reduce_dimension), (ref_batched, reduce_dimension_batched),
    (ref_coo, build_filtration_coo), (ref_seed_column, seed_column),
    (ref_clearance, clearance_commit),
    (ref_ph.fingerprint_points, ph.fingerprint_points),
    (ref_ph.PHServeEngine.admission_account,
     ph.PHServeEngine.admission_account),
    (ref_ph.PHServeEngine.submit, ph.PHServeEngine.submit),
    (ref_ph.PHServeEngine.step, ph.PHServeEngine.step),
    (ref_ph.PHServeEngine.run, ph.PHServeEngine.run),
] + [(getattr(ref_resume, n), getattr(resume, n)) for n in _RESUME]
  + [(getattr(ref_lint, n), getattr(lint, n))
     for n in ("lint_source", "lint_file", "lint_paths")]
  + [(getattr(ref_collectives, n), getattr(collectives, n))
     for n in ("check_exchange_consistency", "schedule_signature",
               "verify_axes", "collective_schedule_from_hlo")]
  + [(ref_analyze_main.main, analyze_main.main)],
    ids=lambda f: f.__qualname__)
def test_host_signature_is_the_reference(ref, port):
    """Host-only entry points, and those that reach the card only through
    ``**reducer_opts`` (``device`` travels there to ``make_reducer``):
    exactly the reference's parameters."""
    want, got = _params(ref), _params(port)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(want, got):
        assert a.kind == b.kind, a.name
        assert _same_default(a, b), a.name


def test_serve_engine_signature_adds_device_before_reducer_opts():
    """``PHServeEngine``: the reference's named parameters, then
    ``device``, then the reducer options."""
    want = _params(ref_ph.PHServeEngine.__init__)
    got = _params(ph.PHServeEngine.__init__)
    assert [p.name for p in got] == \
        [p.name for p in want[:-1]] + ["device", want[-1].name]
    for a, b in zip(want[:-1], got):
        assert a.kind == b.kind and _same_default(a, b), a.name
    assert got[-2].default is None
    assert got[-1].kind is inspect.Parameter.VAR_KEYWORD


@pytest.mark.parametrize("cls", ["PHRequest", "AdmissionDecision",
                                 "PHResponse"])
def test_serve_records_are_the_reference(cls):
    want = dataclasses.fields(getattr(ref_ph, cls))
    got = dataclasses.fields(getattr(ph, cls))
    assert [(f.name, f.default) for f in got] == \
        [(f.name, f.default) for f in want]


@pytest.mark.parametrize("cls", ["DimState", "ReductionCheckpoint"])
def test_resume_records_are_the_reference(cls):
    want = dataclasses.fields(getattr(ref_resume, cls))
    got = dataclasses.fields(getattr(resume, cls))
    assert [f.name for f in got] == [f.name for f in want]


def _cloud():
    return np.random.default_rng(5).normal(size=(14, 3))


def _cpu_mesh(p):
    return make_data_mesh(p, devices=["cpu"] * p)


@pytest.mark.parametrize("kw,ref_kw", [
    (dict(sanitize=True), dict(sanitize=True)),
    (dict(sanitize=True, engine="packed", mesh=_cpu_mesh(2)),
     dict(sanitize=True, engine="packed", n_shards=2)),
])
def test_compute_ph_refusals_name_their_item(kw, ref_kw):
    """What was refused with §1 item 7 runs: the sanitizer on the single
    engine and over a cpu x 2 mesh, with the reference's diagrams and
    check count (the mesh against the reference's ``n_shards=2``)."""
    mine = compute_ph(points=_cloud(), maxdim=1, device="cpu", **kw)
    ref = ref_compute_ph(points=_cloud(), maxdim=1, **ref_kw)
    for d in (0, 1):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["sanitize_checks"] == ref.stats["sanitize_checks"] > 0


_ENV_RUN = r"""
import numpy as np
from repro.core import compute_ph as ref_compute_ph
from repro_torch import compute_ph
from repro_torch.analyze import active_sanitizer
assert active_sanitizer() is not None
pts = np.random.default_rng(5).normal(size=(14, 3))
ref = ref_compute_ph(points=pts, maxdim=1)
mine = compute_ph(points=pts, maxdim=1, device="cpu")
for d in (0, 1):
    assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
assert mine.stats["sanitize_checks"] == ref.stats["sanitize_checks"] > 0
print("ok")
"""


@pytest.mark.parametrize("value", ["1", "yes"])
def test_repro_sanitize_env_is_refused(value):
    """``REPRO_SANITIZE`` set when the sanitizer module is imported (a
    fresh process) arms it in both packages, so ``compute_ph(sanitize=
    None)`` runs the checks: the reference's diagrams and check count."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               REPRO_SANITIZE=value, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _ENV_RUN],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == "ok"


@pytest.mark.parametrize("value,sanitize", [("1", False), ("0", None),
                                            ("", None)])
def test_repro_sanitize_env_off_runs(monkeypatch, value, sanitize):
    """``sanitize=False`` with the variable set, or the variable at "0" or
    empty, runs normally: the reference's diagrams.  The variable is read
    at import, so setting it in a running process changes nothing, in
    either package."""
    monkeypatch.setenv("REPRO_SANITIZE", value)
    kw = dict(points=_cloud(), maxdim=1, engine="packed")
    mine = compute_ph(device="cpu", sanitize=sanitize, **kw)
    ref = ref_compute_ph(sanitize=False, **kw)
    for d in (0, 1):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert "sanitize_checks" not in mine.stats


@pytest.mark.parametrize("case", ["packed", "tiled", "mismatch"])
def test_compute_ph_mesh_cases(case):
    """``mesh=`` in ``compute_ph``: a foreign mesh object (a jax mesh, or
    anything but the port's ``Mesh``) raises ``TypeError``; a real mesh
    runs the sharded harvest with the reference's diagrams; an
    ``n_shards`` that disagrees with the mesh raises the reference's
    ``ValueError``."""
    kw = dict(points=_cloud(), maxdim=1, device="cpu")
    if case == "packed":
        with pytest.raises(TypeError, match="Mesh"):
            compute_ph(mesh=object(), engine="packed", **kw)
    elif case == "tiled":
        mine = compute_ph(mesh=_cpu_mesh(2), backend="tiled", tile_m=4,
                          tile_n=4, **kw)
        ref = ref_compute_ph(points=_cloud(), maxdim=1)
        for d in (0, 1):
            assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
        assert mine.stats["n_shards"] == 2
    else:
        with pytest.raises(ValueError, match="n_shards=2 disagrees with "
                           "the mesh's data-axis size 3"):
            compute_ph(mesh=_cpu_mesh(3), engine="packed", n_shards=2, **kw)


@pytest.mark.parametrize("kw", [dict(n_shards=2),
                                dict(n_shards=3, exchange_every=1),
                                dict(exchange_every=2),
                                dict(n_shards=1, exchange_every=7),
                                dict(n_shards=0)])
def test_compute_ph_takes_n_shards_and_exchange_every(kw):
    """The distributed reduction's options, at P = 1 too: the reference's
    diagrams and shard count."""
    kw = dict(points=_cloud(), maxdim=2, engine="packed", batch_size=8, **kw)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["h1_n_shards"] == ref.stats["h1_n_shards"]


@pytest.mark.parametrize("kw,match", [
    (dict(n_shards=2, engine="batch"), "engine='packed'"),
    (dict(n_shards=2, engine="single"), "engine='packed'"),
    (dict(exchange_every=0, engine="packed"), "exchange_every"),
    (dict(mesh=object()), "mesh sharding requires backend='tiled'"),
    (dict(mesh=object(), engine="batch", backend="tiled",
          filtration=object()), "mesh sharding requires"),
])
def test_compute_ph_value_errors_match_reference(kw, match):
    for fn in (ref_compute_ph, lambda **k: compute_ph(device="cpu", **k)):
        with pytest.raises(ValueError, match=match):
            fn(points=_cloud(), maxdim=1, **kw)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_compute_ph_takes_engine_batch(mode):
    kw = dict(points=_cloud(), maxdim=2, engine="batch", mode=mode,
              batch_size=4)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d
    assert mine.stats["h1_batch_size"] == 4


def test_compute_ph_takes_exchange_every():
    kw = dict(points=_cloud(), maxdim=2, engine="packed", exchange_every=4)
    ref, mine = ref_compute_ph(**kw), compute_ph(device="cpu", **kw)
    for d in (0, 1, 2):
        assert np.array_equal(ref.diagrams[d], mine.diagrams[d]), d


def _h1(build, h0, adapter):
    f = build(points=_cloud())
    cols = np.arange(f.n_e - 1, -1, -1, dtype=np.int64)
    return adapter(f), cols, h0(f).death_edges


def _records_equal(mine: list, want: list) -> None:
    """Two hook logs (commit records or essential records), entry by
    entry: the same keys, scalars and arrays."""
    assert len(mine) == len(want)
    for m, w in zip(mine, want):
        assert sorted(m) == sorted(w)
        for k, v in w.items():
            if isinstance(v, np.ndarray) or isinstance(m[k], np.ndarray):
                assert np.array_equal(np.asarray(m[k]), np.asarray(v)), k
            else:
                assert m[k] == v, k


def _hooked(fn, build, h0, adapter_of, hook, **kw):
    """``fn`` on the H1 columns of ``_cloud`` at tau 1.5 (finite and
    essential classes both) with one warm-restart hook: the log it fills,
    or (for ``seed_gens``) the result of a run seeded with the
    δ-expansions a first implicit run recorded."""
    f = build(points=_cloud(), tau_max=1.5)
    adapter, cleared = adapter_of(f), h0(f).death_edges
    cols = np.arange(f.n_e - 1, -1, -1, dtype=np.int64)
    sink = "commit_sink" if fn.__name__ == "reduce_dimension_packed" \
        else "commit_log"
    if hook != "seed_gens":
        log: list = []
        res = fn(adapter, cols, mode="implicit", cleared=cleared,
                 **{sink if hook == "commit_log" else hook: log}, **kw)
        return res, log
    clog: list = []
    elog: list = []
    fn(adapter, cols, mode="implicit", cleared=cleared,
       **{sink: clog, "essential_log": elog}, **kw)
    seeds = {int(r["col_id"]): np.asarray(r["gens"], dtype=np.int64)
             for r in clog + elog if r.get("gens") is not None}
    return fn(adapter, cols, mode="implicit", cleared=cleared,
              seed_gens=seeds, **kw), seeds


def _assert_hook_matches(ref_fn, fn, hook, **kw):
    want, want_log = _hooked(ref_fn, ref_build, ref_h0, ref_h1_adapter,
                             hook, **kw)
    mine, mine_log = _hooked(fn, build_filtration, compute_h0,
                             make_h1_adapter, hook,
                             **(dict(kw, device="cpu")
                                if fn is reduce_dimension_packed else kw))
    assert np.array_equal(want.diagram(), mine.diagram())
    for f in ("pivot_lows", "pivot_cols", "essential_ids", "pair_cols"):
        assert np.array_equal(getattr(want, f), getattr(mine, f)), f
    if hook == "seed_gens":
        assert sorted(mine_log) == sorted(want_log)
        assert mine_log, "the first run recorded no expansion to seed"
    else:
        _records_equal(mine_log, want_log)
        assert mine_log, f"{hook} stayed empty"


@pytest.mark.parametrize("hook,kw", [
    ("seed_gens", dict(use_kernels=True)),
    ("commit_log", dict(n_shards=2)),
    ("essential_log", dict(n_shards=2, use_kernels=True)),
])
def test_reduce_dimension_packed_refusals_name_their_item(hook, kw):
    """The packed engine's warm-restart hooks (refused until the resume
    layer was ported): seeded from a first run's recorded δ-expansions,
    its commit sink (P = 2 drains copies of the wire records) and its
    essential log equal the reference's, on the kernel path too."""
    _assert_hook_matches(ref_packed, reduce_dimension_packed, hook,
                         batch_size=8, **kw)


@pytest.mark.parametrize("case", ["foreign", "mismatch", "runs"])
def test_reduce_dimension_packed_mesh_cases(case):
    """``mesh=`` in ``reduce_dimension_packed``: a foreign object raises
    ``TypeError``, an ``n_shards`` that disagrees with the mesh the
    reference's ``ValueError``, and a real mesh runs the loop-back's
    split."""
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    kw = dict(cleared=cleared, batch_size=8)
    if case == "foreign":
        with pytest.raises(TypeError, match="Mesh"):
            reduce_dimension_packed(adapter, cols, mesh=object(), **kw)
    elif case == "mismatch":
        with pytest.raises(ValueError, match="n_shards=4 disagrees"):
            reduce_dimension_packed(adapter, cols, mesh=_cpu_mesh(2),
                                    n_shards=4, **kw)
    else:
        mine = reduce_dimension_packed(adapter, cols, mesh=_cpu_mesh(2),
                                       **kw)
        loop = reduce_dimension_packed(adapter, cols, n_shards=2,
                                       device="cpu", **kw)
        assert np.array_equal(loop.diagram(), mine.diagram())
        for k in ("n_shards", "n_supersteps", "n_exchange_rounds",
                  "exchange_bytes", "n_tournament_reductions"):
            assert mine.stats[k] == loop.stats[k], k


@pytest.mark.parametrize("kw", [dict(n_shards=2), dict(n_shards=4,
                                                       exchange_every=1),
                                dict(exchange_every=1)])
def test_reduce_dimension_packed_takes_shards_and_cadence(kw):
    adapter, cols, cleared = _h1(ref_build, ref_h0, ref_h1_adapter)
    ref = ref_packed(adapter, cols, cleared=cleared, batch_size=8, **kw)
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    mine = reduce_dimension_packed(adapter, cols, cleared=cleared,
                                   batch_size=8, device="cpu", **kw)
    assert np.array_equal(ref.diagram(), mine.diagram())
    for k in ("n_shards", "n_supersteps", "n_exchange_rounds",
              "exchange_bytes", "n_tournament_reductions",
              "n_sweep_probes"):
        assert mine.stats[k] == ref.stats[k], k


def test_reduce_dimension_packed_refuses_cadence_below_one():
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    with pytest.raises(ValueError, match="exchange_every"):
        reduce_dimension_packed(adapter, cols, cleared=cleared,
                                exchange_every=0, device="cpu")


@pytest.mark.parametrize("use_kernels", [False, True])
def test_reduce_dimension_packed_positional_reference_call(use_kernels):
    """The reference's positional order, every parameter given: adapter,
    column_ids, mode, cleared, batch_size, store_budget_bytes, use_kernels,
    n_shards, mesh, cache, exchange_every, seed_gens, commit_sink,
    essential_log."""
    args = ("explicit", None, 8, None, use_kernels, 1, None, None, 4, None,
            None, None)
    adapter, cols, cleared = _h1(ref_build, ref_h0, ref_h1_adapter)
    ref = ref_packed(adapter, cols, args[0], cleared, *args[2:])
    adapter, cols, cleared = _h1(build_filtration, compute_h0,
                                 make_h1_adapter)
    mine = reduce_dimension_packed(adapter, cols, args[0], cleared,
                                   *args[2:], device="cpu")
    assert np.array_equal(ref.diagram(), mine.diagram())
    np.testing.assert_array_equal(ref.pivot_lows, mine.pivot_lows)
    assert mine.stats["n_shards"] == 1


@pytest.mark.parametrize("hook", ["seed_gens", "commit_log",
                                  "essential_log"])
@pytest.mark.parametrize("fn", [reduce_dimension, reduce_dimension_batched])
def test_host_engine_refusals_name_their_item(fn, hook):
    """The host engines' warm-restart hooks (refused until the resume layer
    was ported): each equals the reference's."""
    ref_fn = ref_reduce if fn is reduce_dimension else ref_batched
    kw = {} if fn is reduce_dimension else dict(batch_size=8)
    _assert_hook_matches(ref_fn, fn, hook, **kw)


# ---------------------------------------------------------------------------
# the trainer (ROADMAP.md §1 item 10a)
# ---------------------------------------------------------------------------

from repro import checkpoint as ref_checkpoint  # noqa: E402
from repro import train as ref_train  # noqa: E402
from repro.launch import train as ref_launch_train  # noqa: E402
from repro_torch import checkpoint as port_checkpoint  # noqa: E402
from repro_torch import train as port_train  # noqa: E402
from repro_torch.launch import train as port_launch_train  # noqa: E402

_CKPT_METHODS = ("__init__", "save", "save_async", "wait", "restore",
                 "restore_latest_valid", "all_steps", "latest_step")


@pytest.mark.parametrize("ref,port", [
    (ref_launch_train.run, port_launch_train.run),
    (ref_launch_train.tda_monitor, port_launch_train.tda_monitor),
    (ref_train.make_train_step, port_train.make_train_step),
    (ref_train.make_loss_fn, port_train.make_loss_fn),
    (ref_train.lm_loss, port_train.lm_loss),
    (ref_train.global_norm, port_train.global_norm),
    (ref_train.warmup_cosine, port_train.warmup_cosine),
    (ref_train.AdamW.init, port_train.AdamW.init),
    (ref_train.AdamW.update, port_train.AdamW.update),
] + [(getattr(ref_checkpoint.Checkpointer, n),
      getattr(port_checkpoint.Checkpointer, n)) for n in _CKPT_METHODS],
    ids=lambda f: f.__qualname__)
def test_trainer_signature_is_the_reference(ref, port):
    """The trainer's functions and the checkpointer's methods: exactly the
    reference's parameters (the device comes with the job or the
    template)."""
    want, got = _params(ref), _params(port)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(want, got):
        assert a.kind == b.kind, a.name
        assert _same_default(a, b), a.name


@pytest.mark.parametrize("ref,port,extra", [
    (ref_launch_train.TrainJob, port_launch_train.TrainJob, ["device"]),
    (ref_train.AdamW, port_train.AdamW, []),
    (ref_train.TrainState, port_train.TrainState, []),
    (ref_train.AdamWState, port_train.AdamWState, []),
], ids=lambda x: getattr(x, "__qualname__", str(x)))
def test_trainer_records_are_the_reference(ref, port, extra):
    """``TrainJob``'s fields are the reference's, then ``device`` (the card
    unless it says otherwise); ``AdamW``, ``TrainState`` and
    ``AdamWState`` exactly the reference's."""
    if dataclasses.is_dataclass(ref):
        want = [(f.name, f.default) for f in dataclasses.fields(ref)]
        got = [(f.name, f.default) for f in dataclasses.fields(port)]
        assert got == want + [(n, None) for n in extra]
    else:
        assert port._fields == ref._fields


def test_init_train_state_takes_seed_and_device():
    """Where the reference takes a jax key, the port takes ``seed`` and
    ``device`` (an explicit generator on the target device)."""
    assert [p.name for p in _params(ref_train.init_train_state)] == \
        ["cfg", "opt", "key"]
    got = _params(port_train.init_train_state)
    assert [p.name for p in got] == ["cfg", "opt", "seed", "device"]
    assert got[-1].default is None


def _lm_entry_points():
    from repro.models import attention as ref_attention
    from repro.models import layers as ref_layers
    from repro.models import transformer as ref_transformer
    from repro_torch.models import attention, layers, transformer

    return [
        (ref_layers.apply_mrope, layers.apply_mrope, 0, []),
        (ref_layers.sinusoidal_positions, layers.sinusoidal_positions, 0,
         ["device"]),
        (ref_attention.cross_attention_apply, attention.cross_attention_apply,
         0, []),
        # the port names the parameter dict ``p``
        (ref_attention.attention_apply, attention.attention_apply, 1, []),
        (ref_transformer._sinusoidal_at, transformer._sinusoidal_at, 0,
         ["device"]),
    ]


@pytest.mark.parametrize("i", range(5))
def test_lm_entry_points_take_the_references_parameters(i):
    """The M-RoPE, sinusoid and cross-attention entry points (and
    ``attention_apply`` with ``positions3`` before ``causal``) take the
    reference's parameters in its order, defaults and kinds included, with
    a trailing ``device`` where they allocate."""
    ref, port, skip, added = _lm_entry_points()[i]
    want, got = _params(ref)[skip:], _params(port)[skip:]
    assert [p.name for p in got] == [p.name for p in want] + added
    for a, b in zip(want, got):
        assert a.kind == b.kind and _same_default(a, b), a.name
    assert all(p.default is None for p in got[len(want):])


def test_trainer_packages_export_the_reference_names():
    assert port_train.__all__ == ref_train.__all__
    assert port_checkpoint.__all__ == ref_checkpoint.__all__
    for name in port_train.__all__:
        assert getattr(port_train, name).__module__.startswith(
            "repro_torch.train.")


def _trainer_accepts(case, tmp_path):
    """What the sharded trainer's four entry points give against the
    reference's results: ``mesh_shape`` (a (2, 2) run of reduced qwen3
    from the reference's initial state, its losses and gradient norms
    against the reference's unmeshed run of the same job),
    ``micro_batch_axes`` (one meshed step against the reference's jitted
    step on the same weights) and ``restore`` / ``restore_latest_valid``
    onto shardings (each leaf laid out on a (2, 2) CPU mesh, whole again
    equal to the reference's restore).  Returns pairs (port, reference)
    to hold within 1e-5 relative."""
    import contextlib
    import io

    import jax
    import jax.numpy as jnp
    import torch

    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro.configs import get_config as jax_get_config
    from repro.launch import train as jlaunch
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import (NamedSharding, P,
                                           activation_rules,
                                           bind_activation_rules)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import train_step as port_ts

    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    cfg = get_config("qwen3-0.6b", reduced=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    jstate = jts.init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    if case == "mesh_shape":
        for d in ("j", "t"):
            JCheckpointer(str(tmp_path / d)).save(-1, jstate,
                                                  metadata={"step": -1})
        kw = dict(steps=3, global_batch=4, seq_len=16, n_micro=2, lr=1e-3,
                  warmup=2, ckpt_every=10_000, log_every=1)
        with contextlib.redirect_stdout(io.StringIO()):
            want = jlaunch.run(jlaunch.TrainJob(
                cfg=jcfg, ckpt_dir=str(tmp_path / "j"), **kw), restore=True)
            got = port_launch_train.run(port_launch_train.TrainJob(
                cfg=cfg, ckpt_dir=str(tmp_path / "t"), mesh_shape=(2, 2),
                device="cpu", **kw), restore=True)
        return [(g[k], w[k]) for g, w in zip(got["history"], want["history"])
                for k in ("loss", "grad_norm")]
    if case == "micro_batch_axes":
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (8, 17)).astype(np.int32)
        _, jm = jax.jit(jts.make_train_step(jcfg, jo, n_micro=2))(
            jstate, {"tokens": jnp.asarray(toks)})
        to = port_train.AdamW(lr=port_train.warmup_cosine(1e-3, 2, 10))
        state = port_ts.train_state_from_arrays(
            cfg, jax.tree.map(np.asarray, jstate), "cpu")
        step = bind_activation_rules(port_train.make_train_step(
            cfg, to, n_micro=2, micro_batch_axes=("data",)),
            activation_rules(cfg, mesh))
        _, tm = step(port_ts.shard_train_state(state, mesh),
                     {"tokens": torch.from_numpy(toks)})
        return [(float(tm[k]), float(jm[k])) for k in ("loss", "grad_norm")]
    ckpt = port_checkpoint.Checkpointer(str(tmp_path))
    tree = {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
            "b": np.arange(3, dtype=np.int32)}
    ckpt.save(0, tree)
    shardings = {"w": NamedSharding(mesh, P("data", "model")),
                 "b": NamedSharding(mesh, P())}
    got = getattr(ckpt, case)(tree, shardings=shardings)[0]
    want = JCheckpointer(str(tmp_path)).restore(tree)[0]
    assert len(got["w"].distinct()) == 4 and len(got["b"].distinct()) == 1
    return [(got[k].unshard().numpy(), np.asarray(want[k])) for k in tree]


def _embedding_batch_step(case):
    """One train step of reduced qwen2-vl-2b in 2 microbatches on an
    ``embeds`` + ``labels`` batch (with an image-grid ``positions3`` in
    the ``positions3`` case), in both packages from the reference's
    weights; returns both metrics."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as jtf
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as ttf

    jcfg = jax_get_config("qwen2-vl-2b", reduced=True)
    tcfg = get_config("qwen2-vl-2b", reduced=True)
    rng = np.random.default_rng(7)
    b, s = 4, 12
    batch = {"embeds": rng.normal(size=(b, s, tcfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, tcfg.vocab_size, (b, s)).astype(
                 np.int32)}
    if case == "positions3":
        p3 = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        p3[1, :, 2:8] = 2 + np.arange(6) // 3       # a 2 x 3 image grid
        p3[2, :, 2:8] = 2 + np.arange(6) % 3
        p3[:, :, 8:] -= 3
        batch["positions3"] = p3
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    jo = jopt.AdamW(lr=jopt.warmup_cosine(1e-3, 2, 10))
    _, jm = jax.jit(jts.make_train_step(jcfg, jo, n_micro=2))(
        jts.TrainState(params=jp, opt=jo.init(jp)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = ttf.params_from_arrays(tcfg, jax.tree.map(np.asarray, jp),
                                   "cpu").requires_grad_(True)
    to = port_train.AdamW(lr=port_train.warmup_cosine(1e-3, 2, 10))
    _, tm = port_train.make_train_step(tcfg, to, n_micro=2)(
        port_train.TrainState(params=model,
                              opt=to.init(dict(model.named_parameters()))),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return jm, tm


# the architectures a mesh refused until item 10.8 was ported
MESH_REFUSED = ("deepseek-v2-lite-16b", "xlstm-1.3b", "recurrentgemma-9b",
                "qwen2-vl-2b", "whisper-small")


@pytest.mark.parametrize("case", ["mesh_shape", "micro_batch_axes",
                                  "restore", "restore_latest_valid",
                                  "positions3", "embeds",
                                  *(f"mesh:{a}" for a in MESH_REFUSED)])
def test_trainer_refusals_name_item_10(case, tmp_path):
    """The sharded trainer's entry points (a mesh, pinned microbatch axes,
    restoring onto shardings), refused until item 10.7 was ported, now
    run and give the reference's results within 1e-5 relative
    (:func:`_trainer_accepts`).  The five architectures a mesh refused
    until their meshed forward was ported (item 10.8) train on one: the
    launcher for a token decoder, one ``make_train_step(micro_batch_axes=)``
    step for qwen2-vl and whisper, against the reference's unmeshed call
    within 1e-5 relative
    (``tests/test_torch_train_mesh_families.py``'s
    ``accepted_against_reference``).  The batches refused until qwen2-vl
    was ported, ``embeds`` and ``positions3``, now train: one step's loss
    and gradient norm equal the reference's within 1e-5 relative."""
    if case in ("positions3", "embeds"):
        jm, tm = _embedding_batch_step(case)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        return
    if case.startswith("mesh:"):
        from test_torch_train_mesh_families import accepted_against_reference

        for got, want in accepted_against_reference(case[len("mesh:"):],
                                                    tmp_path):
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=case)
        return
    for got, want in _trainer_accepts(case, tmp_path):
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=case)


# ---------------------------------------------------------------------------
# the distributed package's exports and the LM substrate's sampler
# ---------------------------------------------------------------------------

def test_dist_exports_the_ported_part_of_the_references():
    """``repro_torch.dist`` exports every name of the reference's
    ``__all__`` but ``tile_specs`` (its one choice is ``data_axis``), in
    the reference's order; beside them its own: the Elias-Fano codec and
    the data axis."""
    import repro.dist as ref_dist
    import repro_torch.dist as port_dist
    from repro_torch.dist import compression, sharding

    ported = [n for n in ref_dist.__all__
              if hasattr(sharding, n) or hasattr(compression, n)]
    assert ported == [n for n in ref_dist.__all__ if n != "tile_specs"]
    assert [n for n in port_dist.__all__ if n in ref_dist.__all__] == ported
    assert set(port_dist.__all__) - set(ported) == {
        "ef_encode_sorted", "ef_decode_sorted", "pack_column_payload",
        "unpack_column_payload", "data_axis"}
    for name in port_dist.__all__:
        assert getattr(port_dist, name).__module__.startswith(
            "repro_torch.dist.")
    assert port_dist.tree_path_str is sharding.tree_path_str
    for name in ported:
        ref_params = list(inspect.signature(
            getattr(ref_dist, name)).parameters)
        port_params = list(inspect.signature(
            getattr(port_dist, name)).parameters)
        if name == "compressed_psum_grads":
            # the port's collectives name their mesh
            assert port_params == ref_params + ["mesh"]
        elif name == "cache_specs":
            # the port chooses a cache's layers by the config's plan
            assert port_params == ref_params + ["cfg"]
        else:
            assert port_params == ref_params, name


def test_sample_temperature_signature_is_the_references():
    """The reference's parameters; ``key`` is a ``torch.Generator``."""
    from repro.serve import steps as ref_steps
    from repro_torch.serve import steps as port_steps

    want = _params(ref_steps.sample_temperature)
    got = _params(port_steps.sample_temperature)
    assert [(p.name, p.kind, p.default) for p in got] == \
        [(p.name, p.kind, p.default) for p in want]


# ---------------------------------------------------------------------------
# the recurrent blocks (models/ssm.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["_causal_conv", "_mlstm_chunk",
                                  "mlstm_apply", "_slstm_cell",
                                  "slstm_apply", "rglru_apply"])
def test_ssm_apply_signature_is_the_references(name):
    """The blocks' functions compute on what they are given: exactly the
    reference's parameters."""
    from repro.models import ssm as ref_ssm
    from repro_torch.models import ssm as port_ssm

    want = _params(getattr(ref_ssm, name))
    got = _params(getattr(port_ssm, name))
    assert [(p.name, p.kind, p.default) for p in got] == \
        [(p.name, p.kind, p.default) for p in want]


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_ssm_allocating_signatures_add_device(kind):
    """``*_init_cache`` allocates: the reference's parameters, then
    ``device``.  ``*_params`` takes ``attn_params``'s convention in the
    port, ``(cfg, gen, device)``, where the reference takes a jax key
    first."""
    from repro.models import ssm as ref_ssm
    from repro_torch.models import attention as port_attn
    from repro_torch.models import ssm as port_ssm

    want = _params(getattr(ref_ssm, f"{kind}_init_cache"))
    got = _params(getattr(port_ssm, f"{kind}_init_cache"))
    assert [p.name for p in got] == [p.name for p in want] + ["device"]
    assert got[-1].default is None
    assert [p.name for p in _params(getattr(ref_ssm, f"{kind}_params"))] \
        == ["key", "cfg"]
    assert [(p.name, p.default)
            for p in _params(getattr(port_ssm, f"{kind}_params"))] == \
        [(p.name, p.default) for p in _params(port_attn.attn_params)] == \
        [("cfg", inspect.Parameter.empty), ("gen", inspect.Parameter.empty),
         ("device", None)]


# ---------------------------------------------------------------------------
# the dry-run tooling (ROADMAP.md §1 item 11)
# ---------------------------------------------------------------------------

def _ast_params(path, name):
    """A function's parameters read off its source: the reference's
    ``launch/dryrun.py`` forces 512 host devices when it is imported."""
    import ast

    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == name)
    a = fn.args
    defaults = [None] * (len(a.args) - len(a.defaults)) + [
        ast.literal_eval(d) for d in a.defaults]
    return [(p.arg, d) for p, d in zip(a.args, defaults)]


@pytest.mark.parametrize("name", ["build_cell", "count_params",
                                  "model_flops", "input_specs", "cells",
                                  "analyze_module"])
def test_dryrun_tooling_signature_is_the_references(name):
    """Host-only (or fake-tensor) entry points take exactly the
    reference's parameters; ``input_specs``, which makes its fake tensors
    on a device, adds ``device`` last.  (``collective_schedule_from_hlo``
    sits in :func:`test_host_signature_is_the_reference`.)"""
    from repro import configs as ref_configs
    from repro.launch import hlo as ref_hlo
    from repro.launch import specs as ref_specs
    from repro_torch import configs as port_configs
    from repro_torch.launch import hlo as port_hlo
    from repro_torch.launch import specs as port_specs

    ref_mod, port_mod = {"cells": (ref_configs, port_configs),
                         "analyze_module": (ref_hlo, port_hlo)}.get(
        name, (ref_specs, port_specs))
    want, got = _params(getattr(ref_mod, name)), _params(getattr(port_mod,
                                                                 name))
    extra = ["device"] if name == "input_specs" else []
    assert [p.name for p in got] == [p.name for p in want] + extra
    for a, b in zip(want, got):
        assert a.kind == b.kind and _same_default(a, b), a.name
    if extra:
        assert got[-1].default is None


@pytest.mark.parametrize("name", ["run_cell", "run_ph_cell"])
def test_dryrun_cell_signature_adds_device(name):
    """``run_cell`` and ``run_ph_cell`` trace on the card by default: the
    reference's parameters and defaults, then ``device``."""
    from repro_torch.launch import dryrun

    ref = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro",
                       "launch", "dryrun.py")
    got = _params(getattr(dryrun, name))
    want = _ast_params(ref, name)
    assert [(p.name, None if p.default is inspect.Parameter.empty
             else p.default) for p in got] == want + [("device", None)]


def test_no_refusal_names_item_12():
    """Item 12 (serving over the Mesh) is ported for every family: no
    message of the port names it."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "src" / \
        "repro_torch"
    hits = [str(p) for p in root.rglob("*.py") if "item 12" in p.read_text()]
    assert hits == []


def test_no_refusal_names_item_11():
    """Item 11 is ported: no message of the port names it."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "src" / \
        "repro_torch"
    hits = [str(p) for p in root.rglob("*.py") if "item 11" in p.read_text()]
    assert hits == []
