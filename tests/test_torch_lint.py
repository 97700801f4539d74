"""The port's ``lint`` tier: the real gate, each rule's twins, the
framework, and parity with the JAX package's rules.

- **the real gate**: the 12 rules over the port package, clean against
  the port's committed baseline (``analysis/baselines/lint.json``): no
  unbaselined finding, no stale entry, every entry with a reason;
- **parity**: for the nine rules whose meaning the port keeps, the JAX
  package's own fixtures (``tests/fixtures/lint/``, read, not changed)
  give the same ``(rule, line)`` findings through JAX's ``lint_text`` and
  the port's;
- **the torch rules** (``host-sync``, ``trace-safety``,
  ``retrace-hazard``): a violating twin that fails and a clean twin that
  passes, inline;
- **the framework**: mandatory reasons, baseline add/expire/reopen, the
  CLI.
"""

from __future__ import annotations

import functools
import json
import threading
from pathlib import Path

import pytest

from dss_ml_at_scale_tpu.analysis import lint_text as jax_lint_text
from dss_ml_at_scale_tpu.analysis.checkers import (
    bare_except as jax_bare_except,
    bench_registry as jax_bench_registry,
    durable_write as jax_durable_write,
    fault_sites as jax_fault_sites,
    lock_discipline as jax_lock_discipline,
    no_print as jax_no_print,
    slo_registry as jax_slo_registry,
    span_discipline as jax_span_discipline,
    telemetry_registry as jax_telemetry_registry,
)
from dss_ml_at_scale_tpu_torch.analysis import (
    DEFAULT_BASELINE,
    LintUsageError,
    checker_names,
    lint_text,
    load_baseline,
    run_lint,
    write_baseline,
)
from dss_ml_at_scale_tpu_torch.analysis.checkers import (
    bare_except,
    bench_registry,
    durable_write,
    fault_sites,
    lock_discipline,
    no_print,
    slo_registry,
    span_discipline,
    telemetry_registry,
)
from dss_ml_at_scale_tpu_torch.analysis.checkers.fault_sites import FaultSitesChecker
from dss_ml_at_scale_tpu_torch.analysis.checkers.host_sync import HostSyncChecker
from dss_ml_at_scale_tpu_torch.analysis.checkers.no_print import NoPrintChecker
from dss_ml_at_scale_tpu_torch.analysis.checkers.retrace_hazard import RetraceHazardChecker
from dss_ml_at_scale_tpu_torch.analysis.checkers.trace_safety import TraceSafetyChecker
from dss_ml_at_scale_tpu_torch.config.cli import main

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "lint"
RULES = ("bare-except", "bench-registry", "durable-write", "fault-sites", "host-sync",
         "lock-discipline", "no-print", "retrace-hazard", "slo-registry",
         "span-discipline", "telemetry-registry", "trace-safety")


# -- the real gate ------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _full_result():
    return run_lint()


def test_the_port_is_clean_against_its_baseline():
    res = _full_result()
    assert res.findings == [], "\n".join(f.text() for f in res.findings)
    assert res.stale_baseline == [], [e["key"] for e in res.stale_baseline]
    assert res.rules == sorted(RULES) == checker_names()


def test_every_baseline_entry_has_a_reason():
    assert DEFAULT_BASELINE == ROOT / "dss_ml_at_scale_tpu_torch/analysis/baselines/lint.json"
    for key, entry in load_baseline(DEFAULT_BASELINE).items():
        assert str(entry.get("reason", "")).strip(), f"baseline entry {key} has no reason"


@pytest.mark.parametrize("rule", RULES)
def test_each_rule_is_clean_on_the_port(rule):
    bad = [f for f in _full_result().findings if f.rule == rule]
    assert bad == [], "\n".join(f.text() for f in bad)


def test_every_suppression_in_the_port_has_a_reason():
    """The gate's suppressed findings all carry a reason, and the seven
    hotpath marks of the JAX package have their counterparts."""
    from dss_ml_at_scale_tpu_torch.analysis.core import PACKAGE_DIR, FileContext

    marks = 0
    for path in sorted(PACKAGE_DIR.rglob("*.py")):
        ctx = FileContext(path, path.name, "package", path.read_text(encoding="utf-8"))
        assert ctx.reasonless == [], f"{path}: reasonless ignore at {ctx.reasonless}"
        marks += len(ctx.hotpath_marks)
    assert marks == 7
    assert _full_result().suppressed, "the gate saw no suppression at all"


# -- parity with the JAX package on its own fixtures --------------------------

# fixture -> (the port's module, JAX's module, checker class, keyword args)
_PARITY = {
    "bare_except": (bare_except, jax_bare_except, "BareExceptChecker", {}),
    "no_print": (no_print, jax_no_print, "NoPrintChecker", {}),
    "durable_write": (durable_write, jax_durable_write, "DurableWriteChecker", {}),
    "lock_discipline": (lock_discipline, jax_lock_discipline, "LockDisciplineChecker", {}),
    "fault_sites": (fault_sites, jax_fault_sites, "FaultSitesChecker",
                    {"known": {"reader.next": "doc", "rpc.send": "transport"}}),
    "telemetry_registry": (telemetry_registry, jax_telemetry_registry,
                           "TelemetryRegistryChecker",
                           {"known": {"requests_total": "counter", "dead_gauge": "gauge",
                                      "depth": "gauge"}}),
    "span_discipline": (span_discipline, jax_span_discipline, "SpanDisciplineChecker",
                        {"known": {"train_step": "", "dead.span": "", "train_epoch": ""}}),
    "slo_registry": (slo_registry, jax_slo_registry, "SloRegistryChecker",
                     {"known": {"serving_latency_p99": "latency", "ttft_p99": "first token",
                                "dead_slo": "unmeasured", "inter_token_p99": "token gap"}}),
    "bench_registry": (bench_registry, jax_bench_registry, "BenchRegistryChecker",
                       {"known": {"decode": ("decode_images_per_sec",),
                                  "gated": ("a_metric", "b_metric"),
                                  "dead_scenario": ("x",), "kwform": ("a_metric",)}}),
}


@pytest.mark.parametrize("fixture", [f"{n}_{side}" for n in _PARITY
                                     for side in ("positive", "negative")])
def test_shared_rules_give_jax_findings_on_jax_fixtures(fixture):
    name = fixture.rsplit("_", 1)[0]
    port_mod, jax_mod, cls, kw = _PARITY[name]
    src = (FIXTURES / f"{fixture}.py").read_text(encoding="utf-8")
    ours = lint_text(getattr(port_mod, cls)(**kw), src)
    theirs = jax_lint_text(getattr(jax_mod, cls)(**kw), src)
    assert [(f.rule, f.line) for f in ours] == [(f.rule, f.line) for f in theirs]
    if fixture.endswith("_positive"):
        assert ours, f"{fixture}: no finding at all"


# -- the torch rules: violating and clean twins -------------------------------

_HOST_SYNC = {
    "item": ("x.item()", 1),
    "cpu": ("x.cpu()", 1),
    "tolist": ("x.tolist()", 1),
    "numpy": ("x.numpy()", 1),
    "float": ("float(x)", 1),
    "int": ("int(x.sum())", 1),
    "bool": ("bool(x)", 1),
    "np.asarray": ("np.asarray(x)", 1),
    "cuda.synchronize": ("torch.cuda.synchronize()", 1),
    "event.synchronize": ("ev.synchronize()", 1),
    "stream.synchronize": ("torch.cuda.current_stream().synchronize()", 1),
    "clean": ("torch.where(x > 0, x, 0) + float(1.5)", 0),
}


@pytest.mark.parametrize("case", _HOST_SYNC)
def test_host_sync_twins(case):
    expr, expected = _HOST_SYNC[case]
    marked = ("import numpy as np\nimport torch\n\n\n# dsst: hotpath\n"
              f"def step(x, ev):\n    y = {expr}\n    return y\n")
    findings = lint_text(HostSyncChecker(), marked)
    assert len(findings) == expected, [f.text() for f in findings]
    # The same call outside a marked function is fine.
    unmarked = marked.replace("# dsst: hotpath\n", "")
    assert lint_text(HostSyncChecker(), unmarked) == []


def test_host_sync_loop_header_and_nested_marks():
    src = (
        "def f(done, q):\n"
        "    # dsst: hotpath\n"
        "    while not done.item():\n"
        "        q.put(1)\n"
        "# dsst: hotpath\n"
        "def hot(q):\n"
        "    # dsst: hotpath\n"
        "    while True:\n"
        "        q.cpu()\n"
    )
    findings = lint_text(HostSyncChecker(), src)
    assert sorted(f.line for f in findings) == [3, 9], [f.text() for f in findings]


_TRACE_SAFETY_BAD = '''
import numpy as np
import torch


class Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        if x.sum() > 0:                 # branch on a tensor
            x = x * 2
        s = float(w.mean())             # host cast
        n = x.max().item()              # scalar read
        h = np.asarray(x)               # host copy
        while w.norm() > 1:             # loop on a tensor
            w = w / 2
        return x * w + eps + s + n

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        scale = 2 if bool(g.abs().max()) else 1   # host cast
        return g * w * scale, g * x, None


def op(x, w, eps: float = 1e-5):
    return Op.apply(x, w, float(eps))
'''

_TRACE_SAFETY_CLEAN = '''
import torch


class Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps, relu: bool, group):
        ctx.save_for_backward(x, w)
        ctx.relu, ctx.group = relu, group
        if relu:                                   # a host flag
            x = torch.clamp_min(x, 0)
        if x.is_cuda and x.shape[0] > 1 and x.numel():   # host metadata
            x = x.contiguous()
        if group is not None:
            x = x + 0
        for row in x:                              # walks the first axis by shape
            row.mul_(1)
        return torch.where(x > 0, x * w, x) + eps

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.relu:                               # saved on the host by forward
            g = torch.where(x > 0, g, torch.zeros_like(g))
        return g * w, g * x, None, None, None


def op(x, w, *, eps: float = 1e-5, relu: bool = False, group=None):
    return Op.apply(x, w, float(eps), relu, group)
'''


def test_trace_safety_violating_twin():
    findings = lint_text(TraceSafetyChecker(), _TRACE_SAFETY_BAD)
    lines = [f.line for f in findings]
    src = _TRACE_SAFETY_BAD.splitlines()
    flagged = sorted({src[n - 1].strip().split("#")[0].strip() for n in lines})
    assert len(findings) == 7, [f.text() for f in findings]  # two on the IfExp line
    assert flagged == sorted({
        "if x.sum() > 0:", "s = float(w.mean())", "n = x.max().item()",
        "h = np.asarray(x)", "while w.norm() > 1:",
        "scale = 2 if bool(g.abs().max()) else 1"})
    # eps reaches forward as float(eps): a host value, never flagged.
    assert not any("eps" in f.message for f in findings)


def test_trace_safety_clean_twin():
    assert lint_text(TraceSafetyChecker(), _TRACE_SAFETY_CLEAN) == []


def test_trace_safety_ignores_plain_functions():
    src = "def f(x):\n    if x.sum() > 0:\n        return float(x)\n    return x.item()\n"
    assert lint_text(TraceSafetyChecker(), src) == []


_RETRACE_BAD = '''
import ctypes
import functools
import torch


@functools.cache
def load_kernel(name):
    return ctypes.CDLL(name)


@functools.lru_cache(maxsize=None)
def graph_for(batch, seq_len):
    return torch.cuda.CUDAGraph()


@functools.lru_cache(None)
def buffers(shape):
    return torch.empty(shape)


def train(model, batches):
    for b in batches:
        step = torch.compile(model)
        step(b)


def per_call(model, x):
    return torch.compile(lambda t: model(t) * 2)(x)
'''

_RETRACE_CLEAN = '''
import functools
import re
import torch


@functools.lru_cache(maxsize=4)
def load_kernel(name):
    import ctypes
    return ctypes.CDLL(name)


@functools.cache
def table(config_name):
    return {"a": 1}[config_name]


def _scale(t):
    return t * 2


COMPILED = torch.compile(_scale)


def train(model, batches):
    step = torch.compile(model)
    for b in batches:
        step(b)
        re.compile("x")
        compile("1 + 1", "<expr>", "eval")
'''


def test_retrace_hazard_violating_twin():
    findings = lint_text(RetraceHazardChecker(), _RETRACE_BAD)
    assert [f.line for f in findings] == [8, 13, 18, 24, 29], [f.text() for f in findings]


def test_retrace_hazard_clean_twin():
    assert lint_text(RetraceHazardChecker(), _RETRACE_CLEAN) == []


def test_the_torch_rules_describe_their_torch_meaning(capsys):
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out
    for rule in ("host-sync", "trace-safety", "retrace-hazard"):
        line = next(ln for ln in out.splitlines() if ln.startswith(rule))
        assert "torch" in line


# -- suppression semantics ----------------------------------------------------


def test_suppression_silences_with_reason():
    src = "def f(x):\n    print(x)  # dsst: ignore[no-print] CLI-adjacent debug shim\n"
    assert lint_text(NoPrintChecker(), src) == []


def test_suppression_on_line_above():
    src = ("def f(x):\n    # dsst: ignore[no-print] annotates the next line\n"
           "    print(x)\n")
    assert lint_text(NoPrintChecker(), src) == []


def test_suppression_wrong_rule_does_not_silence():
    src = "def f(x):\n    print(x)  # dsst: ignore[bare-except] wrong rule named\n"
    findings = lint_text(NoPrintChecker(), src)
    assert len(findings) == 1 and findings[0].rule == "no-print"


def test_suppression_without_reason_is_a_finding(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("def f(x):\n    print(x)  # dsst: ignore[no-print]\n")
    res = run_lint(["no-print"], roots=[("package", pkg)],
                   baseline_path=tmp_path / "baseline.json")
    assert sorted(f.rule for f in res.findings) == ["no-print", "suppression"]


def test_stacked_suppression_comments_merge():
    src = ("def f(x):\n"
           "    # dsst: ignore[no-print] tolerated here\n"
           "    # dsst: ignore[bare-except] also tolerated\n"
           "    print(x)\n")
    assert lint_text(NoPrintChecker(), src) == []


def test_docstring_mention_of_directive_is_inert():
    from dss_ml_at_scale_tpu_torch.analysis.core import FileContext

    src = ('"""Docs.\n\n# dsst: ignore[no-print]\n# dsst: hotpath\n"""\n\n'
           "def f(x):\n    print(x)\n")
    assert [f.rule for f in lint_text(NoPrintChecker(), src)] == ["no-print"]
    ctx = FileContext(Path("fixture.py"), "fixture.py", "package", src)
    assert ctx.reasonless == [] and ctx.hotpath_marks == set()


# -- baseline add / expire / reopen -------------------------------------------


def _violating_pkg(tmp_path: Path) -> Path:
    pkg = tmp_path / "pkg"
    pkg.mkdir(exist_ok=True)
    (pkg / "mod.py").write_text("def f(x):\n    print(x)\n")
    return pkg


def test_baseline_add_then_clean(tmp_path):
    pkg, bl = _violating_pkg(tmp_path), tmp_path / "baseline.json"
    roots = [("package", pkg)]
    res = run_lint(["no-print"], roots=roots, baseline_path=bl)
    assert len(res.findings) == 1 and res.exit_code == 1
    write_baseline(bl, res.findings, {}, "known debug print, fix pending")
    res2 = run_lint(["no-print"], roots=roots, baseline_path=bl)
    assert res2.findings == [] and res2.exit_code == 0 and len(res2.baselined) == 1


def test_baseline_requires_reason_for_new_entries(tmp_path):
    pkg, bl = _violating_pkg(tmp_path), tmp_path / "baseline.json"
    res = run_lint(["no-print"], roots=[("package", pkg)], baseline_path=bl)
    with pytest.raises(LintUsageError):
        write_baseline(bl, res.findings, {}, None)


def test_baseline_expires_when_finding_fixed(tmp_path):
    pkg, bl = _violating_pkg(tmp_path), tmp_path / "baseline.json"
    roots = [("package", pkg)]
    write_baseline(bl, run_lint(["no-print"], roots=roots, baseline_path=bl).findings, {},
                   "pending")
    (pkg / "mod.py").write_text("def f(x):\n    return x\n")
    res = run_lint(["no-print"], roots=roots, baseline_path=bl)
    assert res.findings == [] and len(res.stale_baseline) == 1 and res.exit_code == 1
    write_baseline(bl, [], load_baseline(bl), None)
    assert run_lint(["no-print"], roots=roots, baseline_path=bl).exit_code == 0


def test_baseline_reopens_when_flagged_line_edited(tmp_path):
    pkg, bl = _violating_pkg(tmp_path), tmp_path / "baseline.json"
    roots = [("package", pkg)]
    write_baseline(bl, run_lint(["no-print"], roots=roots, baseline_path=bl).findings, {},
                   "pending")
    (pkg / "mod.py").write_text("def f(x):\n    print(x, x)\n")
    res = run_lint(["no-print"], roots=roots, baseline_path=bl)
    assert len(res.findings) == 1 and len(res.stale_baseline) == 1


def test_unrelated_edits_keep_baseline_match(tmp_path):
    pkg, bl = _violating_pkg(tmp_path), tmp_path / "baseline.json"
    roots = [("package", pkg)]
    write_baseline(bl, run_lint(["no-print"], roots=roots, baseline_path=bl).findings, {},
                   "pending")
    (pkg / "mod.py").write_text("import logging\n\n\ndef f(x):\n    print(x)\n")
    res = run_lint(["no-print"], roots=roots, baseline_path=bl)
    assert res.findings == [] and res.stale_baseline == []


def test_registry_level_baseline_entry_expires(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text('maybe_fail("a.b")\n')
    bl, roots = tmp_path / "baseline.json", [("package", pkg)]
    known = {"a.b": "doc", "dead.site": "doc"}
    res = run_lint(roots=roots, baseline_path=bl, checkers=[FaultSitesChecker(known=known)])
    assert len(res.findings) == 1
    write_baseline(bl, res.findings, {}, "site lands next change")
    assert run_lint(roots=roots, baseline_path=bl,
                    checkers=[FaultSitesChecker(known=known)]).exit_code == 0
    res3 = run_lint(roots=roots, baseline_path=bl,
                    checkers=[FaultSitesChecker(known={"a.b": "doc"})])
    assert res3.findings == [] and len(res3.stale_baseline) == 1


def test_baseline_entry_of_deleted_file_goes_stale(tmp_path):
    import shutil
    import uuid

    # Inside the repository, so the entry's repo-relative path lies under
    # the scanned root.
    repo_tmp = ROOT / f"_torch_lint_tmp_{uuid.uuid4().hex[:8]}"
    pkg = repo_tmp / "pkg"
    pkg.mkdir(parents=True)
    try:
        (pkg / "mod.py").write_text("def f(x):\n    print(x)\n")
        bl, roots = tmp_path / "baseline.json", [("package", pkg)]
        write_baseline(bl, run_lint(["no-print"], roots=roots, baseline_path=bl).findings,
                       {}, "pending")
        (pkg / "mod.py").unlink()
        res = run_lint(["no-print"], roots=roots, baseline_path=bl)
        assert res.findings == [] and len(res.stale_baseline) == 1
    finally:
        shutil.rmtree(repo_tmp)


def test_corrupt_baseline_is_a_usage_error(tmp_path):
    bl = tmp_path / "baseline.json"
    bl.write_text("<<<<<<< not json")
    with pytest.raises(LintUsageError):
        run_lint(["no-print"], baseline_path=bl)
    assert main(["lint", "--baseline", str(bl)]) == 2


def test_subset_update_preserves_other_rules_entries(tmp_path):
    pkg, bl = _violating_pkg(tmp_path), tmp_path / "baseline.json"
    (pkg / "other.py").write_text("try:\n    pass\nexcept:\n    pass\n")
    roots = [("package", pkg)]
    res = run_lint(["no-print", "bare-except"], roots=roots, baseline_path=bl)
    write_baseline(bl, res.findings, {}, "both accepted")
    before = load_baseline(bl)
    res = run_lint(["no-print"], roots=roots, baseline_path=bl)
    old = load_baseline(bl)
    preserved = {k: e for k, e in old.items() if e["rule"] not in {"no-print", "suppression"}}
    write_baseline(bl, res.findings + res.baselined, old, None, preserved=preserved)
    assert load_baseline(bl) == before


def test_cli_update_baseline_of_a_rule_subset_keeps_the_other_rules(tmp_path, capsys):
    """``--rules`` with ``--update-baseline`` through the CLI: the entries of
    the rules it did not run survive the rewrite."""
    bl = tmp_path / "lint.json"
    other = {"bare-except:0123456789abcdef": {
        "reason": "accepted elsewhere", "rule": "bare-except", "path": "x.py", "line": 1,
        "message": "m"}}
    bl.write_text(json.dumps({"version": 1, "entries": other}))
    assert main(["lint", "--rules", "no-print", "--update-baseline", "--baseline",
                 str(bl)]) == 0
    assert load_baseline(bl) == other
    assert "1 preserved (other rules)" in capsys.readouterr().out


# -- CLI ----------------------------------------------------------------------


def test_cli_lint_clean_and_json(capsys):
    assert main(["lint", "--rules", "no-print,bare-except"]) == 0
    capsys.readouterr()
    assert main(["lint", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["version"] == 1 and payload["ok"] is True
    assert payload["rules"] == sorted(RULES)
    assert main(["lint", "--rules", "not-a-rule"]) == 2


def test_workerpool_declares_its_contract_and_survives_drop_close():
    """WorkerPool now declares its guarded state (as JAX's does): the lint
    holds every access under ``_cond``, and close() racing drop() neither
    raises nor leaks a heartbeat thread."""
    from dss_ml_at_scale_tpu_torch.resilience.workers import WorkerPool

    assert WorkerPool._guarded_by_lock == ("_idle", "_live", "_probing", "_closed",
                                           "_threads")
    for _ in range(10):
        pool = WorkerPool(["a", "b", "c"], probe=lambda w: None,
                          heartbeat_interval=0.01, dead_grace=0.1)
        ts = [threading.Thread(target=pool.drop, args=(w,)) for w in ("a", "b", "c")]
        for t in ts:
            t.start()
        pool.close()
        for t in ts:
            t.join()
        pool.close()
