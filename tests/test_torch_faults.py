"""The port's fault injection, retry and durable publishes vs the JAX
package's (``resilience/faults.py``, ``retry.py``, ``durability.py``).

The same plan spec and seed fire on the same hits as the JAX package's
``FaultPlan``, hit for hit, over 1,000 hits of each grammar form (``N``,
``N@K``, ``pP``, ``kN@K``, dotted-prefix matching); a malformed spec is
refused by both. ``RetryPolicy.delay`` draws the JAX package's delays
under the same ``random.Random``. Every site the port calls is declared in
the port's ``KNOWN_SITES`` and every declared site is called (the port's
version of ``scripts/check_fault_sites.py``). The ``fs.*`` sites tear a
publish as the JAX tests expect (``tests/test_crashonly.py``), and the
stray finder agrees with the JAX package's on the files both stage.
"""

import ast
import json
import os
import random
from pathlib import Path

import pytest

from dss_ml_at_scale_tpu.resilience import durability as jax_durability
from dss_ml_at_scale_tpu.resilience import faults as jax_faults
from dss_ml_at_scale_tpu.resilience import retry as jax_retry
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.resilience import durability, faults, retry

PORT = Path(__file__).resolve().parents[1] / "dss_ml_at_scale_tpu_torch"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    jax_faults.clear()


def _counter(name, **labels):
    for m in telemetry.snapshot()["metrics"]:
        if m["name"] == name and (m.get("labels") or {}) == labels:
            return m["value"]
    return 0.0


SITES = ["grads.nonfinite", "fs.torn_write.manifest", "fs.torn_write.journal", "reader.next",
         "fs.fsync"]


@pytest.mark.parametrize("spec", [
    "grads.nonfinite=7",
    "reader.next=3@150",
    "reader.next=p0.3;seed=11",
    "grads.nonfinite=p0.05;fs.torn_write=p0.5;seed=7",
    "fs.torn_write=k3@5",
    "fs.torn_write=2;fs.torn_write.journal=p0.2;fs=1@900;seed=3",
], ids=["N", "N@K", "pP", "two-sites-pP", "kN@K", "dotted-prefix"])
def test_plan_fires_on_the_jax_plans_hits(spec):
    port, ref = faults.FaultPlan.parse(spec), jax_faults.FaultPlan.parse(spec)
    for i in range(1000):
        site = SITES[i % len(SITES)]
        # _consume: (fire, kill) without acting on a kill.
        assert port._consume(site) == ref._consume(site), (i, site)
    assert port.stats() == ref.stats()
    assert any(s["fired"] for s in port.stats().values())


@pytest.mark.parametrize("bad", ["a=1@-2", "a=1@x", "a=@3", "a", "=1", "a=p1.5", "a=-1"])
def test_malformed_specs_are_refused_as_by_jax(bad):
    with pytest.raises(ValueError):
        jax_faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)


def test_armed_sites_raise_or_fire_and_count():
    assert faults.fault_fires("grads.nonfinite") is False
    faults.maybe_fail("checkpoint.save")  # disarmed: a no-op
    plan = faults.install_from_spec("checkpoint.save=1;loss.spike=1@1")
    assert faults.active_plan() is plan
    before = _counter("faults_injected_total", site="checkpoint.save")
    with pytest.raises(faults.InjectedFault) as e:
        faults.maybe_fail("checkpoint.save")
    assert isinstance(e.value, ConnectionError) and retry.is_transient(e.value)
    faults.maybe_fail("checkpoint.save")  # the one armed hit is spent
    assert _counter("faults_injected_total", site="checkpoint.save") - before == 1
    assert [faults.fault_fires("loss.spike") for _ in range(3)] == [False, True, False]
    faults.clear()
    assert faults.active_plan() is None


@pytest.mark.parametrize("policy", [retry.RetryPolicy(),
                                    retry.RetryPolicy(max_retries=5, base_delay=0.01,
                                                      max_delay=0.1)])
def test_retry_delays_are_jax_draws(policy):
    ref = jax_retry.RetryPolicy(**{f: getattr(policy, f) for f in
                                   ("max_retries", "base_delay", "max_delay", "deadline")})
    a, b = random.Random(5), random.Random(5)
    assert [policy.delay(k, a) for k in range(20)] == [ref.delay(k, b) for k in range(20)]


@pytest.mark.parametrize("exc", [ConnectionError("x"), TimeoutError("x"), EOFError("x"),
                                 OSError("x"), ValueError("x"), KeyError("x")],
                         ids=lambda e: type(e).__name__)
def test_transient_classifier_agrees_with_jax(exc):
    assert retry.is_transient(exc) == jax_retry.is_transient(exc)


def test_call_with_retry_retries_transient_and_raises_the_rest():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("blip")
        return "ok"

    before = _counter("retry_total", site="t")
    assert retry.call_with_retry(flaky, policy=retry.RetryPolicy(max_retries=3), site="t",
                                 sleep=sleeps.append) == "ok"
    assert len(calls) == 3 and len(sleeps) == 2
    assert _counter("retry_total", site="t") - before == 2

    def semantic():
        raise ValueError("bad bytes")

    with pytest.raises(ValueError):
        retry.call_with_retry(semantic, policy=retry.RetryPolicy(), sleep=sleeps.append)
    assert len(sleeps) == 2


def _call_sites() -> list[tuple[str, bool, str]]:
    """``(site, is_prefix, where)`` of every maybe_fail / fault_fires call in
    the port (an f-string contributes its literal prefix)."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name not in ("maybe_fail", "fault_fires"):
                continue
            arg, where = node.args[0], f"{path.relative_to(PORT)}:{node.lineno}"
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((arg.value, False, where))
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                out.append((arg.values[0].value.rstrip("."), True, where))
            elif not (isinstance(arg, ast.Name) and path.name == "faults.py"):
                out.append((None, False, where))
    return out


def test_every_called_site_is_declared_and_every_declared_site_called():
    sites = _call_sites()
    assert sites
    for site, is_prefix, where in sites:
        assert site is not None, f"{where}: a site that is not a (prefixed) literal"
        assert any(site == k or site.startswith(k + ".") or (is_prefix and k.startswith(site))
                   for k in faults.KNOWN_SITES), f"{where}: {site!r} is not in KNOWN_SITES"
    for key, doc in faults.KNOWN_SITES.items():
        assert doc.strip(), key
        assert any(s == key or s.startswith(key + ".") or (p and key.startswith(s))
                   for s, p, _ in sites), f"declared site {key!r} is never called"
    assert set(faults.KNOWN_SITES) <= set(jax_faults.KNOWN_SITES)


@pytest.mark.parametrize("spec", ["trial.evaluate=1@2", "trial.evaluate=2"])
def test_an_injected_trial_fault_fails_one_trial_and_not_the_sweep(spec):
    """``trial.evaluate`` fails the trial it hits, permanently (no retry),
    as in JAX (``hpo/fmin.py:118-124``); the sweep runs every eval, and
    the JAX package's fmin under the same plan fails the same trials."""
    from dss_ml_at_scale_tpu import hpo as jax_hpo
    from dss_ml_at_scale_tpu_torch import hpo

    calls = []

    def obj(p):
        calls.append(p["x"])
        return p["x"] ** 2

    faults.install_from_spec(spec)
    got = hpo.fmin(obj, {"x": hpo.hp.uniform("x", -1, 1)}, max_evals=6, rstate=0,
                   return_argmin=False)
    jax_faults.install_from_spec(spec)
    want = jax_hpo.fmin(lambda p: p["x"] ** 2, {"x": jax_hpo.hp.uniform("x", -1, 1)},
                        max_evals=6, rstate=0, return_argmin=False)
    status = [t["result"]["status"] for t in got.trials]
    assert len(status) == 6 and status == [t["result"]["status"] for t in want.trials]
    failed = [i for i, s in enumerate(status) if s == hpo.STATUS_FAIL]
    assert failed == ([2] if "@" in spec else [0, 1])
    assert len(calls) == 6 - len(failed)  # a failed trial never reached the objective
    assert all("InjectedFault" in got.trials[i]["result"]["error"] for i in failed)


@pytest.mark.parametrize("kind", ["manifest", "journal"])
def test_torn_write_leaves_a_truncated_tmp_and_publishes_nothing(tmp_path, kind):
    target = tmp_path / "x.json"
    durability.durable_write_json(target, {"v": 1})
    faults.install_from_spec(f"fs.torn_write.{kind}=1")
    with pytest.raises(faults.InjectedFault):
        durability.durable_write_json(target, {"v": 2, "pad": "y" * 100}, kind=kind)
    assert json.loads(target.read_text()) == {"v": 1}  # the old target survives
    tmp = target.with_name("x.json.tmp")
    assert 0 < tmp.stat().st_size < len(json.dumps({"v": 2, "pad": "y" * 100}))
    durability.durable_write_json(target, {"v": 3}, kind="other")  # only .<kind> is armed
    assert json.loads(target.read_text()) == {"v": 3}


def test_crash_after_tmp_and_fsync_sites(tmp_path):
    target = tmp_path / "m.json"
    faults.install_from_spec("fs.crash_after_tmp.manifest=1;fs.fsync.bundle=1")
    with pytest.raises(faults.InjectedFault):
        durability.durable_write_json(target, {"a": 1}, kind="manifest")
    assert not target.exists()
    assert json.loads(target.with_name("m.json.tmp").read_text()) == {"a": 1}
    with pytest.raises(faults.InjectedFault):
        durability.durable_write_json(target, {"a": 2}, kind="bundle")
    before = _counter("fsync_seconds_total")
    durability.durable_write_json(target, {"a": 3}, kind="bundle")
    assert json.loads(target.read_text()) == {"a": 3}
    assert _counter("fsync_seconds_total") > before


def test_append_jsonl_heals_a_torn_tail(tmp_path):
    path = tmp_path / "j.jsonl"
    durability.append_jsonl(path, [{"event": "a"}])
    with open(path, "a") as f:
        f.write('{"event": "tor')  # a kill mid-append
    n = durability.append_jsonl(path, [{"event": "b"}, {"event": "c"}])
    lines = path.read_text().splitlines()
    assert n > 0 and json.loads(lines[-1]) == {"event": "c"}
    assert json.loads(lines[-2]) == {"event": "b"} and lines[1] == '{"event": "tor'


def test_stray_finder_agrees_with_jax_and_sweeps_the_ports_staging_dirs(tmp_path):
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "meta.json.tmp").write_text("{")
    (tmp_path / "ck" / "3.corrupt").mkdir(parents=True)
    (tmp_path / "ck" / "3.corrupt" / "state.pt.tmp").write_text("forensics")
    (tmp_path / "ck" / "2").mkdir()
    (tmp_path / "ck" / "2" / "state.pt").write_text("kept")
    shared = durability.find_stranded_tmp(tmp_path)
    assert shared == jax_durability.find_stranded_tmp(tmp_path) == [
        tmp_path / "run" / "meta.json.tmp"]
    staged = tmp_path / "ck" / f"4.tmp-{os.getpid()}"
    staged.mkdir()
    (staged / "dsst_manifest.json.tmp").write_text("{")
    (staged / "state.pt").write_text("x")
    assert durability.find_stranded_tmp(tmp_path) == [tmp_path / "run" / "meta.json.tmp",
                                                      staged]
    removed = durability.sweep_stranded_tmp(tmp_path)
    assert removed == [tmp_path / "run" / "meta.json.tmp", staged]
    assert not staged.exists() and (tmp_path / "ck" / "3.corrupt" / "state.pt.tmp").exists()
    assert (tmp_path / "ck" / "2" / "state.pt").exists()
    assert durability.find_stranded_tmp(tmp_path / "missing") == []
