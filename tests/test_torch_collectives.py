"""``repro_torch.analyze.collectives`` against ``repro.analyze.collectives``:
the port's registered mesh programs give the reference's pinned schedules,
each planted fault gives the reference's violation kind, the pivot-exchange
wire checks run on the port's codec, and the mesh collectives
(``launch/mesh.py``'s ``all_gather`` and ``ppermute``) that the exchange
and the tournament round go through."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analyze import collectives as ref_coll
from repro.scale.shard import _dists_round_fn as ref_dists_round_fn
from repro_torch.analyze import collectives as coll
from repro_torch.core import device_engine as de
from repro_torch.core.packed_reduce import _make_exchange
from repro_torch.kernels import gf2
from repro_torch.kernels.pairwise_dist import pairwise_sq_dists
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import (all_gather, make_data_mesh, make_mesh,
                                     ppermute)
from repro_torch.scale.shard import _candidate_round_fn, _dists_round_fn
from repro_torch.scale.tiles import _candidates_on_device


def _mesh(p=4):
    return make_data_mesh(p, devices=["cpu"] * p)


def _kinds(violations):
    return sorted(v.kind for v in violations)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_check_repo_is_clean_and_matches_reference():
    schedules, violations = coll.check_repo(device="cpu")
    assert not violations, "\n".join(map(str, violations))
    got = {s.where: s.signature() for s in schedules}
    ref_schedules, ref_violations = ref_coll.check_repo()
    assert not ref_violations
    want = {s.where: s.signature() for s in ref_schedules}
    assert set(want) - set(got) == {"dist.compression.compressed_psum_grads"}
    for name, sig in got.items():
        assert sig == want[name], name
    assert [p.name for p in coll.repo_programs(device="cpu")] == \
        [p.name for p in ref_coll.repo_programs()
         if p.name != "dist.compression.compressed_psum_grads"]
    assert {p.name: p.expect for p in coll.repo_programs(device="cpu")} == \
        {p.name: p.expect for p in ref_coll.repo_programs() if p.name in got}


def test_registry_runs_on_the_card_unless_asked(monkeypatch):
    """``device=None`` is the card, as at every entry point of the port:
    without one it raises instead of carrying on on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coll.repo_programs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coll.check_repo()


def test_registry_meshes_on_the_cpu_when_asked():
    for program in coll.repo_programs(device="cpu"):
        fn, args, alt_args, mesh = program.build()
        assert [d.type for d in mesh.devices.flat] == ["cpu"] * 4
        assert mesh.axis_names == ("data",)
        assert len(args) == len(alt_args)


def test_registered_exchange_round_gathers_every_row():
    program = coll.repo_programs(device="cpu")[2]
    fn, args, alt_args, mesh = program.build()
    for buf in (args[0], alt_args[0]):
        got = fn(buf)
        assert got.shape == buf.shape and got.dtype == torch.int32
        assert np.array_equal(got.numpy().view(np.uint32), buf)


def test_registered_candidate_round_equals_tile_by_tile():
    program = coll.repo_programs(device="cpu")[0]
    fn, args, alt_args, mesh = program.build()
    for xs, live, thr32 in (args, alt_args):
        got = fn(xs, live, thr32)
        assert sorted(got) == [k for k, *_ in live] == [0, 1, 2, 3]
        for k, si, ei, sj, ej in live:
            d2 = pairwise_sq_dists(xs[k][si:ei], xs[k][sj:ej])
            ri, rj = _candidates_on_device(d2, si, ei, sj, ej, thr32, None)
            assert np.array_equal(got[k][0], ri)
            assert np.array_equal(got[k][1], rj)
    # the collapsed cloud is all candidates: the data are uneven
    n_spread = sum(len(r[0]) for r in fn(*args).values())
    n_alt = sum(len(r[0]) for r in fn(*alt_args).values())
    assert n_alt > n_spread


def test_dists_round_masks_equal_reference():
    program = coll.repo_programs(device="cpu")[1]
    fn, args, alt_args, mesh = program.build()
    for dists, live, thr32 in (args, alt_args):
        masks, moved = fn(dists, live, thr32)
        want_moved = 0
        for k, si, ei, sj, ej in live:
            tile = dists[si:ei, sj:ej].astype(np.float32)
            ref = np.asarray(ref_dists_round_fn(jnp.asarray(tile)[None],
                                                np.float32(thr32)))[0]
            assert np.array_equal(masks[k], ref)
            want_moved += tile.size * 4 + tile.size
        assert moved == want_moved


# ---------------------------------------------------------------------------
# Planted faults give the reference's kinds
# ---------------------------------------------------------------------------

def _gather_fn(mesh, rows_of):
    def fn(x):
        return all_gather(mesh, "data", rows_of(x))
    return fn


def test_clean_gather_has_its_schedule():
    mesh = _mesh()
    fn = _gather_fn(mesh, lambda x: [x + k for k in range(4)])
    sched = coll.collective_schedule(fn, (torch.zeros(3),), mesh, "clean",
                                     alt_args=(torch.ones(3),))
    assert not sched.violations
    assert sched.signature() == (("all_gather", ("data",)),)
    assert sched.ops[0].group_size == 4
    assert sched.ops[0].shapes == ((3,),) * 4
    assert str(sched.ops[0]) == "all_gather[data]"


def test_gather_missing_an_entry_is_divergent():
    mesh = _mesh()
    fn = _gather_fn(mesh, lambda x: [x + k for k in range(3)])
    sched = coll.collective_schedule(fn, (torch.zeros(3),), mesh, "missing")
    assert _kinds(sched.violations) == ["divergent-cond"]
    assert "3 of the 4 entries" in sched.violations[0].detail
    # the op still lands in the schedule, as the reference's longest branch
    assert sched.signature() == (("all_gather", ("data",)),)


def test_gather_with_a_none_row_is_divergent():
    mesh = _mesh()
    fn = _gather_fn(mesh, lambda x: [x, None, x, x])
    sched = coll.collective_schedule(fn, (torch.zeros(3),), mesh, "none")
    assert _kinds(sched.violations) == ["divergent-cond"]


@pytest.mark.parametrize("odd", [torch.zeros(5), torch.zeros(3, 1),
                                 torch.zeros(3, dtype=torch.int64)])
def test_rows_of_unequal_shape_or_dtype_are_divergent(odd):
    mesh = _mesh()
    fn = _gather_fn(mesh, lambda x: [x, x, odd, x])
    sched = coll.collective_schedule(fn, (torch.zeros(3),), mesh, "ragged")
    assert _kinds(sched.violations) == ["divergent-cond"]


def test_ppermute_rows_of_unequal_width_are_divergent():
    mesh = _mesh()

    def fn(x):
        xs = [x[: 4 + (k == 2)] for k in range(4)]
        return ppermute(mesh, "data", xs, [(i, i ^ 1) for i in range(4)])

    sched = coll.collective_schedule(fn, (torch.zeros(8),), mesh, "pp")
    assert _kinds(sched.violations) == ["divergent-cond"]
    assert sched.signature() == (("ppermute", ("data",)),)


def test_data_dependent_schedule_is_a_while_collective():
    mesh = _mesh()

    def fn(x):
        out = x
        for _ in range(int(x.sum())):      # trip count read from the data
            out = all_gather(mesh, "data", [out[0]] * 4)
        return out

    args, alt = (torch.ones(2),), (torch.tensor([1.0, 2.0]),)
    sched = coll.collective_schedule(fn, args, mesh, "loop", alt_args=alt)
    assert _kinds(sched.violations) == ["while-collective"]
    assert sched.signature() == (("all_gather", ("data",)),) * 2
    # the same data twice gives one schedule
    same = coll.collective_schedule(fn, args, mesh, "loop", alt_args=args)
    assert not same.violations


def test_unknown_axis_is_named_by_verify_axes():
    mesh = _mesh()
    fn = _gather_fn(mesh, lambda x: [x] * 4)
    sched = coll.collective_schedule(fn, (torch.zeros(3),), mesh, "axes")
    assert not coll.verify_axes(sched, mesh_axes=("data",))
    bad = coll.verify_axes(sched, mesh_axes=("batch",))
    assert _kinds(bad) == ["unknown-axis"]
    # and a collective over an axis the mesh lacks stops the run there
    def other(x):
        return all_gather(mesh, "model", [x] * 4)
    sched = coll.collective_schedule(other, (torch.zeros(3),), mesh, "m")
    assert sched.signature() == (("all_gather", ("model",)),)
    assert _kinds(coll.verify_axes(sched, mesh.axis_names)) == \
        ["unknown-axis"]


def test_check_repo_reports_planted_programs(monkeypatch):
    real = coll.repo_programs

    def planted(device=None):
        mesh = _mesh()

        def boom():
            raise RuntimeError("cannot build")

        def misordered():
            fn = functools.partial(de.make_distributed_round(mesh),
                                   pivot_keys=torch.zeros(1,
                                                          dtype=torch.int64),
                                   pivot_cols=torch.full(
                                       (1, 2), de.EMPTY, dtype=torch.int64))
            cols = torch.full((8, 2), de.EMPTY, dtype=torch.int64)
            return fn, (cols,), (cols,), mesh

        def wrong_axes():
            fn = _gather_fn(mesh, lambda x: [x] * 4)
            return fn, (torch.zeros(2),), (torch.zeros(2),), mesh

        return real(device) + [
            coll.Program("planted.boom", boom, ("data",), expect=()),
            coll.Program("planted.misordered", misordered, ("data",),
                         expect=(("all_gather", ("data",)),)),
            coll.Program("planted.axes", wrong_axes, ("batch",),
                         expect=(("all_gather", ("batch",)),)),
        ]

    monkeypatch.setattr(coll, "repo_programs", planted)
    schedules, violations = coll.check_repo(device="cpu")
    assert len(schedules) == 5
    by_where = {}
    for v in violations:
        by_where.setdefault(v.where, []).append(v.kind)
    assert by_where == {"planted.boom": ["trace-error"],
                        "planted.misordered": ["schedule-mismatch"],
                        "planted.axes": ["unknown-axis",
                                         "schedule-mismatch"]}


def test_hook_is_disarmed_after_a_failing_run():
    """A program that raises leaves the hook armed before it in place."""
    mesh = _mesh()
    outer = []

    def fn(x):
        all_gather(mesh, "data", [x] * 4)
        raise KeyError("inside the program")

    with mesh_mod.recording(lambda *a: outer.append(a[0])):
        with pytest.raises(KeyError):
            coll.collective_schedule(fn, (torch.zeros(1),), mesh)
        assert outer == []
        ppermute(mesh, "data", [torch.zeros(1)] * 4,
                 [(i, i) for i in range(4)])
    all_gather(mesh, "data", [torch.zeros(1)] * 4)
    assert outer == ["ppermute"]


def test_a_programs_except_exception_does_not_hide_a_halt():
    """The recorder's halt passes a program's own ``except Exception``:
    recording stops at the divergent collective."""
    mesh = _mesh()

    def fn(x):
        try:
            all_gather(mesh, "data", [x] * 3)
        except Exception:  # noqa: BLE001 - the retry under test
            pass
        all_gather(mesh, "data", [x] * 4)

    sched = coll.collective_schedule(fn, (torch.zeros(1),), mesh, "retry")
    assert _kinds(sched.violations) == ["divergent-cond"]
    assert len(sched.ops) == 1


def test_collective_schedule_takes_only_a_port_mesh():
    with pytest.raises(TypeError, match="repro_torch.launch.mesh.Mesh"):
        coll.collective_schedule(lambda: None, (), object())


def test_hlo_schedule_waits_for_item_11():
    with pytest.raises(NotImplementedError, match="item 11"):
        coll.collective_schedule_from_hlo("HloModule m\n")


# ---------------------------------------------------------------------------
# The pivot-exchange wire
# ---------------------------------------------------------------------------

def test_exchange_consistency_clean():
    assert coll.check_exchange_consistency() == []
    assert ref_coll.check_exchange_consistency() == []


def test_unpadded_stack_is_a_wire_shape(monkeypatch):
    def unpadded(payloads):
        width = max(1, max(len(p) for p in payloads))
        out = np.zeros((len(payloads), width), dtype=np.uint32)
        for k, p in enumerate(payloads):
            out[k, :len(p)] = p
        return out, np.array([len(p) for p in payloads], dtype=np.int64)

    monkeypatch.setattr(gf2, "stack_wire_payloads", unpadded)
    kinds = _kinds(coll.check_exchange_consistency())
    assert kinds and set(kinds) == {"wire-shape"}


def test_stack_dropping_a_shard_is_a_wire_shape(monkeypatch):
    real = gf2.stack_wire_payloads
    monkeypatch.setattr(gf2, "stack_wire_payloads",
                        lambda payloads: real(list(payloads)[:-1]))
    assert set(_kinds(coll.check_exchange_consistency())) == {"wire-shape"}


def test_lossy_unstack_is_a_wire_roundtrip(monkeypatch):
    real = gf2.unstack_wire_payloads

    def lossy(gathered, lens):
        return [p[:-1] if len(p) else p for p in real(gathered, lens)]

    monkeypatch.setattr(gf2, "unstack_wire_payloads", lossy)
    assert set(_kinds(coll.check_exchange_consistency())) == \
        {"wire-roundtrip"}


def test_lossy_codec_is_a_wire_roundtrip(monkeypatch):
    from repro_torch.core import pivot_cache

    real = pivot_cache.decode_commit_delta

    def lossy(payload):
        out = real(payload)
        if out:
            out[-1]["low"] += 1
        return out

    monkeypatch.setattr(pivot_cache, "decode_commit_delta", lossy)
    violations = coll.check_exchange_consistency()
    # the 1- and 4-record round trips break, the empty one cannot
    assert _kinds(violations) == ["wire-roundtrip"] * 2
    assert "Elias–Fano" in violations[0].detail


# ---------------------------------------------------------------------------
# The mesh collectives and the paths routed through them
# ---------------------------------------------------------------------------

def test_all_gather_stacks_rows_onto_the_first_entry():
    mesh = _mesh()
    rows = [torch.arange(3) + 10 * k for k in range(4)]
    got = all_gather(mesh, "data", rows)
    assert torch.equal(got, torch.stack(rows))
    with pytest.raises(ValueError, match="one row an entry"):
        all_gather(mesh, "data", rows[:3])


def test_ppermute_follows_its_pairs():
    mesh = _mesh()
    xs = [torch.full((2,), float(k)) for k in range(4)]
    got = ppermute(mesh, "data", xs, [(i, i ^ 2) for i in range(4)])
    assert [float(t[0]) for t in got] == [2.0, 3.0, 0.0, 1.0]
    got = ppermute(mesh, "data", xs, [(0, 1), (1, 2), (2, 3), (3, 0)])
    assert [float(t[0]) for t in got] == [3.0, 0.0, 1.0, 2.0]
    for perm in ([(0, 1), (2, 1), (1, 0), (3, 3)], [(0, 1)],
                 [(0, 4), (1, 0), (2, 2), (3, 3)]):
        with pytest.raises(ValueError, match="not a permutation"):
            ppermute(mesh, "data", xs, perm)


def test_exchange_records_one_gather_a_round():
    mesh = _mesh()
    exchange = _make_exchange(mesh)
    payloads = [np.arange(s, dtype=np.uint32) for s in (3, 0, 9, 1)]
    back = []
    sched = coll.collective_schedule(
        lambda: back.append(exchange(payloads)), (), mesh, "exchange")
    assert sched.signature() == (("all_gather", ("data",)),)
    width = gf2.stack_wire_payloads(payloads)[0].shape[1]
    assert sched.ops[0].shapes == ((width,),) * 4
    assert all(np.array_equal(a, b) for a, b in zip(back[0], payloads))


@pytest.mark.parametrize("shape,axes,rounds,want", [
    ((4,), ("data",), None,
     (("ppermute", ("data",)),) * 2 + (("all_gather", ("data",)),)),
    ((2,), ("data",), None,
     (("ppermute", ("data",)), ("all_gather", ("data",)))),
    ((2, 2), ("pod", "data"), 1,
     (("ppermute", ("data",)), ("all_gather", ("data",))) * 2
     + (("all_gather", ("pod",)),)),
])
def test_distributed_round_schedule(shape, axes, rounds, want):
    """The reference's ``make_distributed_round``: log2(data) ppermutes,
    then all_gather of the lows over ``data`` (and ``pod``).  On a
    ``(pod, data)`` mesh the port runs the pods one after the other, so the
    recorded schedule is per pod, the ``data`` collectives once a pod: not
    the reference's per-entry ``shard_map`` schedule, which has them
    once."""
    n = int(np.prod(shape))
    mesh = make_mesh(shape, axes, devices=["cpu"] * n)
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(1000, size=64, replace=False)).astype(np.int64)
    table = np.full((64, 4), de.EMPTY, dtype=np.int64)
    table[:, 0] = keys
    cols = np.full((8 * n, 4), de.EMPTY, dtype=np.int64)
    cols[:, 0] = rng.choice(keys, size=8 * n)
    fn = de.make_distributed_round(mesh, n_serial_rounds=rounds)
    args = tuple(torch.as_tensor(a) for a in (cols, keys, table))
    sched = coll.collective_schedule(fn, args, mesh, "round")
    assert not sched.violations
    assert sched.signature() == want
    out_cols, lows = fn(*args)
    assert lows.shape == (8 * n,)
    assert torch.equal(lows, out_cols[:, 0])


def test_candidate_round_launches_nothing_on_the_cpu():
    """On a CPU mesh the round runs the plain version: no launch counted."""
    program = coll.repo_programs(device="cpu")[0]
    fn, args, _, _ = program.build()
    before = pairwise_sq_dists.launches
    fn(*args)
    assert pairwise_sq_dists.launches == before


def test_dists_round_fn_is_the_one_the_path_runs(monkeypatch):
    """The harvest's dists rounds go through the registered callable."""
    from repro_torch.scale import shard

    calls = []

    def spy(*a, **k):
        calls.append(a[3])
        return _dists_round_fn(*a, **k)

    monkeypatch.setattr(shard, "_dists_round_fn", spy)
    rng = np.random.default_rng(3)
    pts = rng.random((40, 2))
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    iu, ju, lens = shard.harvest_edges_sharded(
        dists=d, tau_max=0.4, tile_m=16, tile_n=16, mesh=_mesh(),
        backend="kernel")
    assert calls and all(1 <= len(live) <= 4 for live in calls)
    want = np.argwhere(np.triu(d <= 0.4, 1))
    assert len(iu) == len(want)


def test_candidate_round_fn_is_the_one_the_path_runs(monkeypatch):
    from repro_torch.scale import shard

    calls = []

    def spy(*a, **k):
        calls.append(len(a[3]))
        return _candidate_round_fn(*a, **k)

    monkeypatch.setattr(shard, "_candidate_round_fn", spy)
    pts = np.random.default_rng(4).random((40, 2))
    shard.harvest_edges_sharded(points=pts, tau_max=0.4, tile_m=16,
                                tile_n=16, mesh=_mesh(), backend="kernel")
    assert calls and sum(calls) == 6   # the 3 x 3 grid's 6 upper tiles


def test_cli_collectives_on_the_cpu_when_asked(capsys):
    from repro_torch.analyze.__main__ import main

    assert main(["collectives", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "collectives: 3 program(s) traced, 0 violation(s)"


def test_cli_collectives_without_a_card_fails(monkeypatch, capsys):
    """The CLI's default is the card: without one it says so and exits 1
    rather than running the mesh on the host."""
    from repro_torch.analyze.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["collectives"]) == 1
    out = capsys.readouterr().out
    assert "no CUDA device" in out and "traced" not in out
