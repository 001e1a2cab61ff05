"""``repro_torch.analyze.lint`` against ``repro.analyze.lint``: the
reference's findings, field for field, on its negative fixtures and its
tree; the port's own forms (torch's host syncs in a hot loop, torch's
global RNG, the port's tracer package) on inline sources; and the port's
tree clean under the port's rules, through the API and the CLI."""
import dataclasses
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analyze import lint as ref_lint
from repro_torch.analyze import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analyze")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _fields(findings):
    return [dataclasses.astuple(f) for f in findings]


def test_nine_fixtures_and_nine_rules():
    assert len(FIXTURE_FILES) == 9
    assert [r.name for r in lint.default_rules()] == \
        [r.name for r in ref_lint.default_rules()]


@pytest.mark.parametrize("force", [True, False])
@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_reference(name, force):
    path = os.path.join(FIXTURES, name)
    want = ref_lint.lint_file(path, root=REPO, force=force)
    got = lint.lint_file(path, root=REPO, force=force)
    assert _fields(got) == _fields(want)
    if force:
        assert want, f"{name} must trip a rule"


@pytest.mark.parametrize("sub", ["src/repro", "benchmarks", "examples",
                                 "tools"])
def test_reference_tree_findings_equal_reference(sub):
    files = ref_lint._iter_python_files(REPO, (sub,))
    assert files
    want = ref_lint.lint_paths(REPO, files=files)
    got = lint.lint_paths(REPO, files=files)
    assert _fields(got) == _fields(want)


# Statements a differential fuzz composes; none is one of the port's own
# forms, so the two packages must agree on every composition and path.
_STATEMENTS = [
    "total += y.sum().item()",
    "host = np.asarray(step(x))",
    "host = np.array(gf2_find_low(x))",
    "jax.device_get(y)",
    "y.block_until_ready()",
    "order = np.argsort(edge_lens)",
    "order = np.lexsort((jj, ii, lens))",
    "order = np.lexsort((ii, lens))",
    "pts = np.random.rand(3)",
    "rng = np.random.default_rng()",
    "r = random.random()",
    "t0 = time.perf_counter()",
    "sp = span('x')",
    "with stopwatch('y'):\n    pass",
    "time.sleep(0.1)",
    "ok = d32 <= tau_max",
    "step2 = jax.jit(f)",
    "x = x  # analyze: allow[host-sync]",
]
_PATHS = ["src/repro/core/packed_reduce.py", "src/repro/scale/tiles.py",
          "src/repro/obs/trace.py", "src/repro/core/homology.py",
          "benchmarks/reduce_bench.py", "examples/quickstart.py", "x.py"]
_HEADER = ("import random\nimport time\nimport jax\nimport numpy as np\n"
           "from repro.kernels.gf2 import gf2_find_low\n"
           "from repro.obs.trace import span, stopwatch\n\n")


def _indent(text, depth):
    return "\n".join("    " * depth + ln for ln in text.splitlines())


@settings(max_examples=60, deadline=None, database=None)
@given(body=st.lists(st.tuples(st.sampled_from(_STATEMENTS),
                               st.integers(0, 2)), min_size=1, max_size=8),
       path=st.sampled_from(_PATHS), hot=st.booleans(),
       in_try=st.booleans())
def test_composed_sources_equal_reference(body, path, hot, in_try):
    lines = ["def f(xs, edge_lens, ii, jj, lens, d32, tau_max, y, step):"]
    lines.append("    # analyze: hot" if hot else "    pass")
    lines.append("    for x in xs:")
    if in_try:
        lines.append("        try:\n            pass\n        except "
                     "ValueError:\n            pass")
    for stmt, depth in body:
        lines.extend(_indent("while True:", 2 + k) for k in range(depth))
        lines.append(_indent(stmt, 2 + depth))
    source = _HEADER + "\n".join(lines) + "\n"
    want = ref_lint.lint_source(source, path)
    got = lint.lint_source(source, path)
    assert _fields(got) == _fields(want)


# ---------------------------------------------------------------------------
# The port's own forms
# ---------------------------------------------------------------------------

_TORCH_HEADER = ("import numpy as np\nimport torch\n"
                 "from repro_torch.kernels.gf2 import gf2_find_low\n\n"
                 "def f(xs, ev, stream):\n    for x in xs:\n")
_HOST_SYNC_FORMS = {
    "cpu": "h = x.cpu()",
    "numpy": "h = x.numpy()",
    "tolist": "h = x.tolist()",
    "cpu_numpy": "h = x.cpu().numpy()",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "cuda_synchronize_device": "torch.cuda.synchronize(x.device)",
    "event_synchronize": "ev.synchronize()",
    "stream_synchronize": "stream.synchronize()",
    "asarray_kernel": "h = np.asarray(gf2_find_low(x))",
    "array_kernel": "h = np.array(gf2_find_low(x))",
}


@pytest.mark.parametrize("form", sorted(_HOST_SYNC_FORMS))
def test_host_sync_catches_torch_form(form):
    source = _TORCH_HEADER + "        " + _HOST_SYNC_FORMS[form] + "\n"
    found = lint.lint_source(source, "x.py", rules=[lint.HostSyncRule()],
                             force=True)
    assert len(found) == 1, [f.format() for f in found]
    assert found[0].line == 7 and found[0].rule == "host-sync"
    assert not found[0].allowed
    # the same call once, outside the loop, is fine
    once = source.replace("    for x in xs:\n        ", "    x = xs\n    ")
    assert not lint.lint_source(once, "x.py", rules=[lint.HostSyncRule()],
                                force=True)
    # and a justified pragma on the line above allows it
    allowed = source.replace(
        "    for x in xs:\n",
        "    for x in xs:\n        # analyze: allow[host-sync] the schedule\n")
    found = lint.lint_source(allowed, "x.py", rules=[lint.HostSyncRule()],
                             force=True)
    assert len(found) == 1 and found[0].allowed
    assert found[0].justification == "the schedule"


def test_host_sync_hot_port_modules_and_marker():
    source = _TORCH_HEADER + "        h = x.cpu()\n"
    rule = lint.HostSyncRule()
    for rel in ("src/repro_torch/core/packed_reduce.py",
                "src/repro_torch/core/serial_parallel.py",
                "src/repro_torch/scale/shard.py",
                "src/repro_torch/scale/tiles.py"):
        assert len(lint.lint_source(source, rel, rules=[rule])) == 1, rel
    assert not lint.lint_source(source, "src/repro_torch/core/homology.py",
                                rules=[rule])
    # the marker alone opts a file in, without force
    marked = "# analyze: hot\n" + source
    found = lint.lint_source(marked, "src/repro_torch/core/homology.py",
                             rules=[rule])
    assert len(found) == 1 and found[0].line == 8
    # the reference's rule sees neither the port's modules nor its syncs
    assert not ref_lint.lint_source(
        source, "src/repro_torch/core/packed_reduce.py",
        rules=[ref_lint.HostSyncRule()])


_RNG_FORMS = {
    "rand": "torch.rand(3)",
    "randn": "torch.randn(3, 4)",
    "randint": "torch.randint(0, 5, (3,))",
    "randperm": "torch.randperm(8)",
    "normal": "torch.normal(0.0, 1.0, (3,))",
    "bernoulli": "torch.bernoulli(p)",
    "multinomial": "torch.multinomial(p, 2)",
    "manual_seed": "torch.manual_seed(0)",
    "seed": "torch.seed()",
}


@pytest.mark.parametrize("form", sorted(_RNG_FORMS))
def test_unseeded_rng_catches_torch_form(form):
    source = ("import torch\n\ndef f(p):\n    x = " + _RNG_FORMS[form]
              + "\n    return x\n")
    rule = lint.UnseededRngRule()
    found = lint.lint_source(source, "x.py", rules=[rule], force=True)
    assert len(found) == 1 and found[0].line == 4
    assert found[0].rule == "unseeded-rng" and not found[0].allowed
    # applies under benchmarks/ and examples/ without force
    assert len(lint.lint_source(source, "benchmarks/b.py",
                                rules=[rule])) == 1
    assert not lint.lint_source(source, "src/repro_torch/x.py",
                                rules=[rule])
    pragma = source.replace(
        "    x = ", "    # analyze: allow[unseeded-rng] seeded by caller\n"
        "    x = ")
    found = lint.lint_source(pragma, "x.py", rules=[rule], force=True)
    assert len(found) == 1 and found[0].allowed


@pytest.mark.parametrize("form", ["rand", "randn", "randint", "randperm",
                                  "normal", "bernoulli", "multinomial"])
def test_unseeded_rng_passes_torch_draw_with_generator(form):
    call = _RNG_FORMS[form][:-1] + ", generator=g)"
    source = ("import torch\n\ndef f(p):\n"
              "    g = torch.Generator().manual_seed(0)\n"
              f"    return {call}\n")
    assert not lint.lint_source(source, "x.py",
                                rules=[lint.UnseededRngRule()], force=True)


@pytest.mark.parametrize("rule_cls,source", [
    (lint.RawTimingRule, "import time\nt0 = time.perf_counter()\n"),
    (lint.SpanLeakRule,
     "from repro_torch.obs.trace import span\ns = span('x')\n"),
])
def test_port_obs_is_exempt(rule_cls, source):
    rule = rule_cls()
    assert not lint.lint_source(source, "src/repro_torch/obs/trace.py",
                                rules=[rule])
    assert not lint.lint_source(source, "src/repro/obs/trace.py",
                                rules=[rule])
    assert len(lint.lint_source(source, "src/repro_torch/core/homology.py",
                                rules=[rule])) == 1


def test_port_tree_lints_clean():
    bad = [f for f in lint.lint_paths(REPO) if not f.allowed]
    assert not bad, "\n".join(f.format() for f in bad)


def test_port_host_sync_pragmas_are_justified():
    """Each host sync of the port's hot modules carries its reason."""
    found = [f for f in lint.lint_paths(REPO)
             if f.rule == "host-sync" and f.path.startswith("src/repro_torch")]
    assert found and all(f.allowed and f.justification for f in found)


def _cli(root):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", "lint", "--root", root],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)


def test_cli_lint_exits_zero():
    proc = _cli(REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: 0 finding(s)" in proc.stdout


def test_cli_lint_exits_one_on_a_bad_file(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "scale" / "tiles.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(xs):\n    for x in xs:\n        x.cpu()\n")
    proc = _cli(str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "src/repro_torch/scale/tiles.py:3:8: [host-sync]" in proc.stdout
    assert "lint: 1 finding(s), 0 allowed" in proc.stdout
