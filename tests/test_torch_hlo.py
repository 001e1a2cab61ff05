"""The port's HLO text parser (``repro_torch.launch.hlo``) and
``collective_schedule_from_hlo`` against the reference's, exactly, on HLO
that jax compiles here on its one CPU device and on hand-written HLO with
every collective kind, both ``replica_groups`` forms, a group across pods
and ``while`` loops with and without a known trip count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from repro.analyze import collectives as ref_coll
from repro.launch import hlo as ref_hlo
from repro_torch.analyze import collectives as coll
from repro_torch.launch import hlo


def _compiled(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


def _sds(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _matmul_relu():
    return _compiled(lambda a, b: jax.nn.relu(a @ b), _sds((64, 128)),
                     _sds((128, 32)))


def _scan():
    def fn(w, xs, h):
        def body(h, x):
            h = jnp.tanh(h @ w + x)
            return h, h
        return lax.scan(body, h, xs)
    return _compiled(fn, _sds((32, 32)), _sds((16, 32)), _sds((32,)))


def _conv():
    def fn(x, k):
        return lax.conv_general_dilated(x, k, (1, 1), "SAME")
    return _compiled(fn, _sds((1, 3, 16, 16)), _sds((8, 3, 3, 3)))


def _bf16_dot():
    def fn(a, b):
        return jnp.dot(a, b, preferred_element_type=jnp.float32)
    return _compiled(fn, _sds((64, 128), jnp.bfloat16),
                     _sds((128, 32), jnp.bfloat16))


def _decode_loop():
    def fn(cache, w, x):
        def body(i, c):
            row = jnp.tanh(w @ (x * i))[None]
            return lax.dynamic_update_slice(c, row, (i, 0))
        return lax.fori_loop(0, 8, body, cache)
    return _compiled(fn, _sds((64, 128)), _sds((128, 128)), _sds((128,)))


COMPILED = {"matmul_relu": _matmul_relu, "scan": _scan, "conv": _conv,
            "bf16_dot": _bf16_dot, "decode_loop": _decode_loop}

_COMMON = """\
%add (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %x, f32[] %y)
}

%body (p: (s32[], f32[1024])) -> (s32[], f32[1024]) {
  %p = (s32[], f32[1024]) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[1024]) %p), index=0
  %v = f32[1024] get-tuple-element((s32[], f32[1024]) %p), index=1
  %ar = f32[1024] all-reduce(f32[1024] %v), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %one = s32[] constant(1)
  %n = s32[] add(s32[] %i, s32[] %one)
  ROOT %t = (s32[], f32[1024]) tuple(s32[] %n, f32[1024] %ar)
}

%cond (p: (s32[], f32[1024])) -> pred[] {
  %p = (s32[], f32[1024]) parameter(0)
  %i = s32[] get-tuple-element((s32[], f32[1024]) %p), index=0
  %lim = s32[] constant(LIMIT)
  ROOT %lt = pred[] compare(s32[] %i, s32[] %lim), direction=LT
}

ENTRY %main (a: f32[1024], b: bf16[256,64]) -> (f32[1024], bf16[1024,64]) {
  %a = f32[1024] parameter(0)
  %b = bf16[256,64] parameter(1)
  %ag = bf16[1024,64] all-gather(bf16[256,64] %b), replica_groups=[2,4]<=[8], dimensions={0}
  %rs = f32[256] reduce-scatter(f32[1024] %a), replica_groups=[2,4]<=[4,2]T(1,0), dimensions={0}, to_apply=%add
  %a2a = f32[1024] all-to-all(f32[1024] %a), replica_groups={{0,256},{1,257}}, dimensions={0}
  %cp = f32[1024] collective-permute(f32[1024] %a), source_target_pairs={{0,1},{1,0}}
  %cb = f32[1024] collective-broadcast(f32[1024] %a), replica_groups={{0,1,2,3}}
  %ars = f32[1024] all-reduce-start(f32[1024] %a), replica_groups={{0,1}}, to_apply=%add
  %ard = f32[1024] all-reduce-done(f32[1024] %ars)
  %d = f32[1024,1024] dot(f32[1024] %a, f32[1024] %ard), lhs_contracting_dims={}, rhs_contracting_dims={}
  %zero = s32[] constant(0)
  %init = (s32[], f32[1024]) tuple(s32[] %zero, f32[1024] %cp)
  %w = (s32[], f32[1024]) while((s32[], f32[1024]) %init), condition=%cond, body=%bodyTRIP
  %out = f32[1024] get-tuple-element((s32[], f32[1024]) %w), index=1
  ROOT %r = (f32[1024], bf16[1024,64]) tuple(f32[1024] %out, bf16[1024,64] %ag)
}
"""

HANDWRITTEN = {
    # the trip count from the backend config
    "known_trip": _COMMON.replace("LIMIT", "12").replace(
        "TRIP", ', backend_config={"known_trip_count":{"n":"12"}}'),
    # from the condition's constant
    "cond_constant": _COMMON.replace("LIMIT", "12").replace("TRIP", ""),
    # no proof of the count: one trip, and a while-collective
    "unproven": _COMMON.replace("%lim = s32[] constant(LIMIT)",
                                "%lim = s32[] get-tuple-element((s32[], "
                                "f32[1024]) %p), index=0").replace(
        "TRIP", ""),
}


def _schedule(sched):
    return (sched.where,
            [(op.name, op.axes, op.shapes, op.group_size)
             for op in sched.ops],
            [(v.kind, v.where, v.detail) for v in sched.violations])


@pytest.mark.parametrize("case", sorted(COMPILED))
def test_compiled_module_is_the_references(case):
    text = COMPILED[case]()
    want = ref_hlo.analyze_module(text)
    assert hlo.analyze_module(text) == want
    assert want["flops"] > 0 and want["traffic_bytes"] > 0
    assert hlo.analyze_collectives(text) == ref_hlo.analyze_collectives(text)
    assert _schedule(coll.collective_schedule_from_hlo(text, case)) == \
        _schedule(ref_coll.collective_schedule_from_hlo(text, case))


@pytest.mark.parametrize("pod_size", [256, 4])
@pytest.mark.parametrize("case", sorted(HANDWRITTEN))
def test_handwritten_module_is_the_references(case, pod_size):
    text = HANDWRITTEN[case]
    want = ref_hlo.analyze_module(text, pod_size=pod_size)
    got = hlo.analyze_module(text, pod_size=pod_size)
    assert got == want
    for kind in ref_hlo.COLLECTIVES:
        assert got[f"count_{kind}"] > 0, kind
    assert got["dcn"] > 0
    assert hlo.analyze_collectives(text, pod_size=pod_size) == \
        ref_hlo.analyze_collectives(text, pod_size=pod_size)


@pytest.mark.parametrize("case", sorted(HANDWRITTEN))
def test_hlo_schedule_is_the_references(case):
    text = HANDWRITTEN[case]
    got = coll.collective_schedule_from_hlo(text, case, pod_size=4)
    assert _schedule(got) == _schedule(
        ref_coll.collective_schedule_from_hlo(text, case, pod_size=4))
    assert len(got.ops) == 7
    # only a known_trip_count proves the count to the schedule's walk
    assert [v.kind for v in got.violations] == \
        ([] if case == "known_trip" else ["while-collective"])


def test_trip_weighting_follows_the_count():
    """The loop's all-reduce: 12 trips where the count is proven (either
    way), one where it is not."""
    counts = {case: hlo.analyze_module(text)["count_all-reduce"]
              for case, text in HANDWRITTEN.items()}
    assert counts == {"known_trip": 13.0, "cond_constant": 13.0,
                      "unproven": 2.0}


@pytest.mark.parametrize("kind", hlo.COLLECTIVES + ("other",))
def test_ring_bytes_table_is_the_references(kind):
    for result_bytes in (0, 1, 4096, 3 * 2**20):
        for n in (0, 1, 2, 3, 8, 256):
            assert hlo._ring_bytes(kind, result_bytes, n) == \
                ref_hlo._ring_bytes(kind, result_bytes, n)


def test_shape_bytes_is_the_references():
    texts = ["f32[1024]", "(s32[], bf16[4,8]{1,0})", "pred[3] token[]",
             "f8e4m3fn[16,16] c128[2] u4[7] weird[9]"]
    for t in texts:
        assert hlo.shape_bytes(t) == ref_hlo.shape_bytes(t)
    assert hlo.shape_bytes(texts[1]) == 4 + 64
    lines = [ln for ln in HANDWRITTEN["known_trip"].splitlines()
             if "replica_groups" in ln]
    for ln in lines:
        for pod in (1, 2, 4, 256):
            assert hlo._group_info(ln, pod) == ref_hlo._group_info(ln, pod)


def test_split_and_parse_are_the_references():
    text = HANDWRITTEN["known_trip"]
    raw = hlo._split_computations(text)
    assert raw == ref_hlo._split_computations(text)
    assert sorted(raw) == ["add", "body", "cond", "main"]
    for name, lines in raw.items():
        got = hlo._parse_computation(name, lines, 256)
        want = ref_hlo._parse_computation(name, lines, 256)
        assert [(o.name, o.opcode, o.result_bytes, o.result_dims)
                for o in got.ops] == \
            [(o.name, o.opcode, o.result_bytes, o.result_dims)
             for o in want.ops]
        assert (got.whiles, got.calls, got.fusion_calls, got.max_const) == \
            (want.whiles, want.calls, want.fusion_calls, want.max_const)
    assert np.isclose(hlo.analyze_module(text)["flops"], 2.0 * 1024 * 1024)
