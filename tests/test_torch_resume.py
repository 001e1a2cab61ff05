"""The port's warm resume (``repro_torch.core.resume``) on the CPU against
the JAX package's ``repro.core.resume``, on the same numpy clouds from a
seed, at the reference tests' sizes (clouds of 18–30 points, maxdim 2).

Tolerance: exact throughout (``np.array_equal``).  Diagrams, every
``DimState`` field, the recorded δ-expansions and ``content_hash`` must
equal the reference's for each engine: ``single``, ``batch``, ``packed``,
``packed`` at ``n_shards=2``, and ``packed`` on its kernel path
(``use_kernels=True``, whose plain versions run on the CPU) at P = 1,
against the reference's kernel path (Pallas in interpret mode), and at
``n_shards=2``, against the reference's numpy path (``ENGINES``).
Checkpoints saved by either package load in the other, and the
``resume.load`` fault fires at the same load ordinal in both.
"""
import numpy as np
import pytest

from repro.core import build_filtration as ref_build
from repro.core import resume as ref
from repro.core.packed_reduce import reduce_dimension_packed as ref_packed
from repro.resilience import faults as ref_faults
from repro_torch.core import build_filtration
from repro_torch.core import resume
from repro_torch.core.packed_reduce import reduce_dimension_packed
from repro_torch.resilience import faults

DIMS = (0, 1, 2)


def _kernels(engine, n_shards, **kw):
    """The packed engine's kernel path (``use_kernels=True``) of ``engine``
    as a reducer."""
    def run(adapter, cols, cleared, seed_gens, commit_log, essential_log):
        return engine(
            adapter, cols, mode="implicit", cleared=cleared, batch_size=16,
            use_kernels=True, n_shards=n_shards, seed_gens=seed_gens,
            commit_sink=commit_log, essential_log=essential_log, **kw)
    return run


# (port options, reference options; None: the same without ``device``).
# At P = 1 the kernel path's serial pre-pass may record other (valid)
# δ-expansions than the numpy path's serial pass — in the reference as in
# the port — so it is held against the reference's kernel path (Pallas in
# interpret mode); at P = 2 no serial kernel runs and the reference's numpy
# path gives the same checkpoint.
ENGINES = [
    pytest.param(dict(engine="single"), None, id="single"),
    pytest.param(dict(engine="batch", batch_size=8), None, id="batch"),
    pytest.param(dict(engine="packed", batch_size=16), None, id="packed"),
    pytest.param(dict(engine="packed", batch_size=16, n_shards=2), None,
                 id="packed-p2"),
    pytest.param(dict(reducer=_kernels(reduce_dimension_packed, None,
                                       device="cpu")),
                 dict(reducer=_kernels(ref_packed, None)),
                 id="packed-kernels"),
    pytest.param(dict(reducer=_kernels(reduce_dimension_packed, 2,
                                       device="cpu")),
                 dict(engine="packed", batch_size=16, n_shards=2),
                 id="packed-kernels-p2"),
]


def cloud(seed, n, d=3):
    return np.random.default_rng(seed).normal(size=(n, d))


def _port_kw(opts):
    kw = dict(opts)
    if "reducer" not in kw:
        kw.update(mode="implicit", device="cpu")
    return kw


def _ref_kw(opts, ref_opts):
    kw = dict(ref_opts if ref_opts is not None else opts)
    if "reducer" not in kw:
        kw["mode"] = "implicit"
    return kw


def assert_state_equal(mine, want):
    """Two (diagrams, checkpoint) results, field by field."""
    (dm, cm), (dw, cw) = mine, want
    assert set(dm) == set(dw)
    for d in dw:
        assert np.array_equal(dm[d], dw[d]), d
    assert (cm.n, cm.n_e, cm.maxdim, cm.tau_max) == \
        (cw.n, cw.n_e, cw.maxdim, cw.tau_max)
    assert np.array_equal(cm.edges, cw.edges)
    assert cm.edges.dtype == cw.edges.dtype
    assert set(cm.dims) == set(cw.dims)
    for d, sw in cw.dims.items():
        sm = cm.dims[d]
        for f in ("pairs", "pair_cols", "essentials", "essential_ids",
                  "pivot_lows", "pivot_cols"):
            a, b = getattr(sm, f), getattr(sw, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (d, f)
        assert sorted(sm.gens) == sorted(sw.gens), d
        for c, g in sw.gens.items():
            assert np.array_equal(sm.gens[c], g), (d, c)
    assert cm.nbytes() == cw.nbytes()
    assert cm.content_hash() == cw.content_hash()


def _both(fn_name, pts_tau, opts, ref_opts, ckpts=None, **kw):
    """Run ``fn_name`` in both packages on the same cloud and threshold."""
    pts, tau = pts_tau
    args_m = [build_filtration(points=pts, tau_max=tau)]
    args_w = [ref_build(points=pts, tau_max=tau)]
    if ckpts is not None:
        args_m.append(ckpts[0])
        args_w.append(ckpts[1])
    mine = getattr(resume, fn_name)(*args_m, **_port_kw(opts), **kw)
    want = getattr(ref, fn_name)(*args_w, **_ref_kw(opts, ref_opts), **kw)
    assert_state_equal(mine, want)
    return mine, want


@pytest.mark.parametrize("opts,ref_opts", ENGINES)
def test_cold_reduce_matches_reference(opts, ref_opts):
    pts = cloud(0, 22)
    (dm, cm), _ = _both("cold_reduce", (pts, 1.8), opts, ref_opts)
    # the reference's single engine gives the same diagrams whatever
    # engine ran
    ds, _ = ref.cold_reduce(ref_build(points=pts, tau_max=1.8),
                            mode="implicit", engine="single")
    for d in DIMS:
        assert np.array_equal(dm[d], ds[d]), d
    for d in (1, 2):
        for e in cm.dims[d].essential_ids:
            assert int(e) in cm.dims[d].gens


@pytest.mark.parametrize("opts,ref_opts", ENGINES)
def test_warm_tau_growth_matches_reference(opts, ref_opts):
    pts = cloud(1, 26)
    (_, cm), (_, cw) = _both("cold_reduce", (pts, 1.3), opts, ref_opts)
    (_, c1), _ = _both("warm_tau_growth", (pts, 2.2), opts, ref_opts,
                       ckpts=(cm, cw))
    assert c1.tau_max == 2.2


@pytest.mark.parametrize("opts,ref_opts", ENGINES)
def test_warm_point_arrival_matches_reference(opts, ref_opts):
    pts = cloud(5, 20)
    (_, cm), (_, cw) = _both("cold_reduce", (pts, 1.9), opts, ref_opts)
    grown = np.concatenate([pts, cloud(6, 7)], axis=0)
    (_, c1), _ = _both("warm_point_arrival", (grown, 1.9), opts, ref_opts,
                       ckpts=(cm, cw))
    assert c1.n == 27


@pytest.mark.parametrize("opts,ref_opts", ENGINES)
def test_chained_updates_match_reference(opts, ref_opts):
    """tau growth -> point arrival (with tau growth) -> tau growth, each
    warm, each equal to the reference's, and the last equal to a cold
    reduction of the final cloud."""
    pts = cloud(9, 21)
    ck = _both("cold_reduce", (pts, 1.2), opts, ref_opts)
    ck = _both("warm_tau_growth", (pts, 1.8), opts, ref_opts,
               ckpts=(ck[0][1], ck[1][1]))
    grown = np.concatenate([pts, cloud(10, 6)], axis=0)
    ck = _both("warm_point_arrival", (grown, 2.0), opts, ref_opts,
               ckpts=(ck[0][1], ck[1][1]))
    (dm, _), _ = _both("warm_tau_growth", (grown, 2.4), opts, ref_opts,
                       ckpts=(ck[0][1], ck[1][1]))
    cold, _ = resume.cold_reduce(build_filtration(points=grown, tau_max=2.4),
                                 mode="implicit", engine="single",
                                 device="cpu")
    for d in DIMS:
        assert np.array_equal(resume.canonical_diagram(dm[d]),
                              resume.canonical_diagram(cold[d])), d


@pytest.mark.parametrize("opts,ref_opts", ENGINES)
def test_batched_cold_reduce_matches_reference(opts, ref_opts):
    clouds = [cloud(20 + k, n) for k, n in enumerate((13, 8, 19, 6))]
    taus = [1.7, 2.4, 1.4, np.inf]
    mine = resume.batched_cold_reduce(
        [build_filtration(points=p, tau_max=t) for p, t in zip(clouds, taus)],
        **_port_kw(opts))
    want = ref.batched_cold_reduce(
        [ref_build(points=p, tau_max=t) for p, t in zip(clouds, taus)],
        **_ref_kw(opts, ref_opts))
    assert len(mine) == len(want) == 4
    for k, (m, w) in enumerate(zip(mine, want)):
        assert_state_equal(m, w)
        # each cloud's split equals its standalone cold reduction
        alone = resume.cold_reduce(
            build_filtration(points=clouds[k], tau_max=taus[k]),
            mode="implicit", engine="single", device="cpu")
        assert m[1].content_hash() == alone[1].content_hash(), k


def test_union_filtration_matches_reference():
    clouds = [cloud(30, 16), cloud(31, 11)]
    mine = resume.union_filtration(
        [build_filtration(points=p, tau_max=1.5) for p in clouds])
    want = ref.union_filtration(
        [ref_build(points=p, tau_max=1.5) for p in clouds])
    for f in ("n", "n_e", "edges", "edge_len", "degree", "nbr_vtx",
              "nbr_vtx_ord", "nbr_edge_ord", "nbr_edge_vtx"):
        assert np.array_equal(getattr(mine[0], f), getattr(want[0], f)), f
    assert np.array_equal(mine[1], want[1])
    assert np.array_equal(mine[2], want[2])


def test_edge_order_map_matches_reference():
    pts = cloud(11, 15)
    grown = np.concatenate([pts, cloud(12, 4)], axis=0)
    _, cm = resume.cold_reduce(build_filtration(points=pts, tau_max=1.6),
                               mode="implicit", device="cpu")
    _, cw = ref.cold_reduce(ref_build(points=pts, tau_max=1.6),
                            mode="implicit")
    em = resume.edge_order_map(cm, build_filtration(points=grown,
                                                    tau_max=1.6))
    ew = ref.edge_order_map(cw, ref_build(points=grown, tau_max=1.6))
    assert em.dtype == ew.dtype and np.array_equal(em, ew)
    other = build_filtration(points=cloud(14, 15), tau_max=1.6)
    with pytest.raises(ValueError):
        resume.edge_order_map(cm, other)
    with pytest.raises(ValueError, match="extend"):
        resume.warm_tau_growth(other, cm, mode="implicit", device="cpu")


def test_canonical_diagram_matches_reference():
    d = np.random.default_rng(3).integers(0, 4, size=(12, 2)).astype(float)
    assert np.array_equal(resume.canonical_diagram(d),
                          ref.canonical_diagram(d))
    assert resume.canonical_diagram(np.zeros((0, 2))).shape == (0, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(engine="single", mode="explicit"), "tracked"),
    (dict(engine="gpu9000"), "unknown engine"),
    (dict(engine="single", n_shards=2), "n_shards"),
])
def test_make_reducer_errors_match_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        ref.make_reducer(**kw)
    with pytest.raises(ValueError, match=match):
        resume.make_reducer(**kw, device="cpu")


def test_make_reducer_runs_on_the_card_by_default(monkeypatch):
    """``device=None`` is the card: without one it raises, as every entry
    point of the port does, instead of running on the host unasked."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resume.make_reducer(engine="packed")
    resume.make_reducer(engine="packed", device="cpu")


@pytest.fixture()
def saved(tmp_path):
    """One checkpoint saved by each package (the same state)."""
    pts = cloud(7, 32)
    _, cm = resume.cold_reduce(build_filtration(points=pts, tau_max=1.1),
                               device="cpu")
    _, cw = ref.cold_reduce(ref_build(points=pts, tau_max=1.1))
    pm, pw = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    return cm, cw, pm, cm.save(pm), pw, cw.save(pw)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_loads_across_packages(saved, direction):
    cm, cw, pm, hm, pw, hw = saved
    assert hm == hw == cm.content_hash() == cw.content_hash()
    if direction == "port_to_reference":
        loaded = ref.ReductionCheckpoint.load(pm)
        assert_state_equal(({}, loaded), ({}, cw))
    else:
        loaded = resume.ReductionCheckpoint.load(pw)
        assert isinstance(loaded, resume.ReductionCheckpoint)
        assert_state_equal(({}, loaded), ({}, cm))
        # and the loaded state warm-starts like the port's own
        pts = cloud(7, 32)
        d, _ = resume.warm_tau_growth(
            build_filtration(points=pts, tau_max=1.5), loaded, device="cpu")
        dw, _ = ref.warm_tau_growth(ref_build(points=pts, tau_max=1.5), cw)
        for k in DIMS:
            assert np.array_equal(d[k], dw[k]), k


@pytest.mark.parametrize("kind,match", [("bitflip", "hash|malformed|"
                                                    "unreadable"),
                                        ("truncate", "unreadable")])
def test_load_fault_detected_like_reference(saved, monkeypatch, kind,
                                            match):
    """The same fault plan on the same bytes: both packages raise
    ``CheckpointCorruption``, fire at the same load ordinal and log the
    same history; a cold reduction then gives the checkpoint's diagrams."""
    cm, cw, pm, _, pw, _ = saved
    monkeypatch.setattr(resume, "_LOAD_ORDINAL", 0)
    monkeypatch.setattr(ref, "_LOAD_ORDINAL", 0)
    spec = dict(site="resume.load", kind=kind, at=2,
                params=(("bit", 31337),))
    histories = []
    for mod, fmod, path in ((resume, faults, pm), (ref, ref_faults, pw)):
        plan = fmod.FaultPlan.of(fmod.FaultSpec(**spec))
        with fmod.inject(plan) as inj:
            mod.ReductionCheckpoint.load(path)          # ordinal 1: clean
            with pytest.raises(fmod.CheckpointCorruption, match=match):
                mod.ReductionCheckpoint.load(path)      # ordinal 2: fires
            mod.ReductionCheckpoint.load(path)          # budget spent
        histories.append([{k: v for k, v in f.items() if k != "path"}
                          for f in inj.fired])
    assert histories[0] == histories[1] == [
        {"site": "resume.load", "kind": kind, "index": 2, "shard": None}]
    pts = cloud(7, 32)
    _, ck = resume.cold_reduce(build_filtration(points=pts, tau_max=1.1),
                               device="cpu")
    assert ck.content_hash() == cm.content_hash()


def test_wrong_version_detected(saved):
    _, _, pm, _, _, _ = saved
    with np.load(pm, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = arrays["__meta__"].copy()
    meta[0] = resume.CHECKPOINT_VERSION + 1
    arrays["__meta__"] = meta
    np.savez_compressed(pm, **arrays)
    with pytest.raises(faults.CheckpointCorruption, match="version"):
        resume.ReductionCheckpoint.load(pm)
    with pytest.raises(ref_faults.CheckpointCorruption, match="version"):
        ref.ReductionCheckpoint.load(pm)
    assert resume.CHECKPOINT_VERSION == ref.CHECKPOINT_VERSION
