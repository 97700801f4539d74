"""SIGKILL chaos soak: prove the port's runtime is crash-only, end to end.

Port of ``dss_ml_at_scale_tpu/resilience/chaos.py``. A supervisor launches
the port's own commands (``python -m dss_ml_at_scale_tpu_torch.config.cli``)
as subprocesses, hard-kills them on a seeded schedule (including *inside
the checkpoint-save window*, through a ``kN`` SIGKILL-on-fire ``fs.*``
fault entry armed in the child's environment), restarts them with
``--resume-auto``, and after N cycles asserts the invariants the
durability layer promises:

- the final run completes (exit 0) and its final parameters are
  **bitwise identical** to an uninterrupted run with the same seed;
- every scheduled kill was delivered, and one landed inside the save
  window (the fs cycle's child died by its own SIGKILL);
- the checkpoint manifest walk is clean (no live step verifies corrupt,
  the newest is intact);
- zero stranded ``*.tmp`` files or ``<step>.tmp-<pid>`` staging
  directories outside quarantined ``*.corrupt`` forensics;
- the journals' commit log is sane: committed steps strictly increase
  within a run, and a step number recommits only after a lower resume;
- after a ``runs doctor`` sweep every run directory is terminal
  (FINISHED / FAILED / INTERRUPTED);
- every killed run's flight-recorder tail parses, and at least one shows
  an open span of the fit family (the work in flight at the kill).

Kill modes per cycle (seeded by ``ChaosConfig.seed``): ``delay`` (SIGKILL
after a random delay), ``save`` (SIGKILL the instant a new step directory
appears) and ``fs`` (the child SIGKILLs itself at
``fs.crash_after_tmp.manifest``: between the manifest's staged tmp file
and its rename).

Every child runs on ``ChaosConfig.device`` (``--device``, default
``cuda`` as every entry of the port): a soak asked for the card where
there is none fails in its first child, it never falls back to the CPU.

The supervisor is single-threaded: isolation comes from process
boundaries, and its only channel to the children is the filesystem it
polls (step directories, journals), which the durability layer makes
safe to read beside a writer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path

log = logging.getLogger(__name__)

_CLI = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli"]

# The fit-family spans: what a kill after the run's start leaves open.
FIT_FAMILY = frozenset({"fit", "train_epoch", "train_step", "checkpoint",
                        "checkpoint.finalize"})


@dataclasses.dataclass
class ChaosConfig:
    """One soak's shape. The defaults are the JAX package's (tiny model)."""

    workdir: str
    workload: str = "train"       # train | hpo | serve
    cycles: int = 5               # SIGKILLs delivered before the final run
    seed: int = 0
    kill_min_s: float = 1.0       # delay-mode kill window
    kill_max_s: float = 6.0
    # train workload shape
    epochs: int = 3
    rows: int = 48
    batch_size: int = 16
    image_size: int = 32
    # hpo workload shape
    max_evals: int = 8
    # serve workload: checkpoint to serve (e.g. a finished soak's dir)
    checkpoint_dir: str | None = None
    timeout_s: float = 300.0      # per-child wall bound
    device: str = "cuda"          # --device of every child


def run_chaos(cfg: ChaosConfig) -> dict:
    """Run one soak; returns the report dict (``report["ok"]`` is the
    verdict, ``report["invariants"]`` the per-check results)."""
    workdir = Path(cfg.workdir).absolute()
    cfg = dataclasses.replace(cfg, workdir=str(workdir))
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "logs").mkdir(exist_ok=True)
    if cfg.workload == "train":
        return _soak_train(cfg, workdir)
    if cfg.workload == "hpo":
        return _soak_hpo(cfg, workdir)
    if cfg.workload == "serve":
        return _soak_serve(cfg, workdir)
    raise ValueError(f"unknown chaos workload {cfg.workload!r}")


# -- child process plumbing ---------------------------------------------------


def _child_env(fault_plan: str | None = None) -> dict:
    env = dict(os.environ)
    env.pop("DSST_FAULT_PLAN", None)
    if fault_plan:
        env["DSST_FAULT_PLAN"] = fault_plan
    # Children run with cwd=workdir; a from-checkout invocation (not
    # pip-installed) needs the repo root importable there too.
    repo_root = str(Path(__file__).resolve().parents[2])
    parts = [repo_root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    return env


def _launch(cfg: ChaosConfig, argv: list[str], log_path: Path,
            fault_plan: str | None = None) -> subprocess.Popen:
    with open(log_path, "ab") as logf:
        # The child inherits a dup of the fd; the parent's handle closes at
        # once (no fd leak across dozens of cycles).
        return subprocess.Popen(
            [*_CLI, *argv, "--device", cfg.device], stdout=logf, stderr=subprocess.STDOUT,
            env=_child_env(fault_plan), cwd=cfg.workdir,
        )


def _wait(proc: subprocess.Popen, timeout: float) -> int:
    try:
        return proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return proc.returncode


def _numeric_steps(ckpt: Path) -> set[int]:
    # One definition of "what is a step dir", shared with the verify walk.
    from . import checkpoint as integrity

    return set(integrity.list_steps(ckpt))


def _kill_cycle(cfg: ChaosConfig, proc: subprocess.Popen, mode: str,
                delay: float, ckpt: Path, seen_steps: set[int]) -> dict:
    """Drive one chaos cycle to child death; returns the cycle record."""
    t0 = time.monotonic()
    killed = False
    if mode == "delay":
        try:
            proc.wait(delay)
        except subprocess.TimeoutExpired:
            proc.kill()
            killed = True
    elif mode == "save":
        # SIGKILL the instant a new committed step dir appears.
        deadline = time.monotonic() + cfg.timeout_s
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            if _numeric_steps(ckpt) - seen_steps:
                proc.kill()
                killed = True
                break
            time.sleep(0.02)
        else:
            proc.kill()
            killed = True
    else:  # "fs": the child SIGKILLs itself at the armed fs.* site
        _wait(proc, cfg.timeout_s)
    proc.wait()
    return {
        "mode": mode,
        "delay_s": round(delay, 2) if mode == "delay" else None,
        "killed_by_supervisor": killed,
        "returncode": proc.returncode,
        "wall_s": round(time.monotonic() - t0, 2),
    }


# -- the train soak -----------------------------------------------------------


def _train_argv(cfg: ChaosConfig, data: Path, ckpt: Path, root: Path,
                experiment: str) -> list[str]:
    # Deterministic replay end to end: one decode worker, no shuffle, no
    # augmentation, so every table pass feeds identical batches and a run
    # resumed at any epoch boundary recomputes exactly the steps the
    # uninterrupted run would have.
    return [
        "train", "--data", str(data), "--model", "tiny",
        "--num-classes", "4", "--crop", str(cfg.image_size),
        "--batch-size", str(cfg.batch_size), "--epochs", str(cfg.epochs),
        "--learning-rate", "0.01", "--workers", "1", "--no-shuffle",
        "--checkpoint-dir", str(ckpt), "--resume-auto",
        "--experiment", experiment, "--tracking-root", str(root),
    ]


def _soak_train(cfg: ChaosConfig, workdir: Path) -> dict:
    from ..datagen.images import write_image_delta

    data = workdir / "data"
    root = workdir / "runs"
    ckpt = workdir / "ckpt"
    ref_ckpt = workdir / "ref_ckpt"
    rng = random.Random(cfg.seed)

    if not data.exists():
        write_image_delta(data, cfg.rows, classes=4, size=cfg.image_size,
                          seed=cfg.seed, mode="overwrite")

    # Kill schedule: a seeded mix, with one forced fs-site cut (the
    # manifest window) and, at another index, one forced save-window kill.
    modes = [rng.choice(["delay", "delay", "save"]) for _ in range(cfg.cycles)]
    fs_i = cfg.cycles // 2
    if cfg.cycles >= 1:
        modes[fs_i] = "fs"
    if cfg.cycles >= 2 and not any(m == "save" for i, m in enumerate(modes) if i != fs_i):
        modes[0 if fs_i != 0 else 1] = "save"
    cycles: list[dict] = []
    for i, mode in enumerate(modes):
        seen = _numeric_steps(ckpt)
        plan = "fs.crash_after_tmp.manifest=k1" if mode == "fs" else None
        proc = _launch(cfg, _train_argv(cfg, data, ckpt, root, "chaos"),
                       workdir / "logs" / f"cycle{i}.log", fault_plan=plan)
        rec = _kill_cycle(cfg, proc, mode, rng.uniform(cfg.kill_min_s, cfg.kill_max_s),
                          ckpt, seen)
        rec["cycle"] = i
        cycles.append(rec)
        log.info("chaos cycle %d: %s", i, rec)
        if rec["returncode"] == 0:
            # Training finished before its kill: the rest of the schedule
            # (the forced fs cut included) can never run, which the
            # kill_schedule_completed invariant reports with a hint.
            log.warning("chaos cycle %d: child completed (rc 0) before its kill; "
                        "abandoning %d remaining cycle(s): lower --kill-max or raise "
                        "--epochs", i, cfg.cycles - i - 1)
            break

    # Final run: no faults, no kills; must converge and complete.
    proc = _launch(cfg, _train_argv(cfg, data, ckpt, root, "chaos"),
                   workdir / "logs" / "final.log")
    final_rc = _wait(proc, cfg.timeout_s)

    # Uninterrupted reference with the same seed and flags.
    proc = _launch(cfg, _train_argv(cfg, data, ref_ckpt, root, "chaos-ref"),
                   workdir / "logs" / "ref.log")
    ref_rc = _wait(proc, cfg.timeout_s)

    report = {
        "workload": "train",
        "seed": cfg.seed,
        "device": cfg.device,
        "cycles": cycles,
        "kills_delivered": sum(1 for c in cycles
                               if c["killed_by_supervisor"] or c["returncode"] == -9),
        "final_returncode": final_rc,
        "ref_returncode": ref_rc,
    }
    report["invariants"] = _train_invariants(cfg, workdir, ckpt, ref_ckpt, root, final_rc,
                                             ref_rc, cycles)
    report["ok"] = all(v.get("ok") for v in report["invariants"].values())
    return report


def _train_invariants(cfg: ChaosConfig, workdir: Path, ckpt: Path, ref_ckpt: Path,
                      root: Path, final_rc: int, ref_rc: int, cycles: list[dict]) -> dict:
    from ..tracking import list_runs, read_journal, sweep_interrupted

    inv: dict[str, dict] = {}
    inv["final_run_completed"] = {"ok": final_rc == 0 and ref_rc == 0,
                                  "final_rc": final_rc, "ref_rc": ref_rc}
    inv["kill_schedule_completed"] = {
        "ok": len(cycles) == cfg.cycles,
        "cycles_run": len(cycles),
        "cycles_requested": cfg.cycles,
        "hint": None if len(cycles) == cfg.cycles else (
            "child completed before its kill; lower --kill-max or raise --epochs so "
            "every scheduled kill can land"),
    }
    inv["save_window_kill"] = _save_window_kill_check(cycles)

    # Doctor sweep first: convergence includes the store (dead RUNNING
    # runs flip INTERRUPTED, their stranded tmps are collected).
    doctor = sweep_interrupted(root)
    statuses = [m.get("status") for m in list_runs(root)]
    inv["runs_terminal"] = {
        "ok": bool(statuses) and all(s in ("FINISHED", "FAILED", "INTERRUPTED")
                                     for s in statuses),
        "statuses": statuses,
        "doctor_marked": sum(1 for c in doctor if c.get("marked")),
    }
    inv["manifest_walk_clean"] = _manifest_walk_check(ckpt)
    inv["no_stranded_tmp"] = _stranded_tmp_check(workdir)
    inv["commit_log_sane"] = _commit_log_check(root, read_journal)
    inv["params_bitwise_equal"] = _parity_check(ckpt, ref_ckpt)
    inv["flight_recorder_tail"] = _flight_recorder_check(root)
    return inv


def _save_window_kill_check(cycles: list[dict]) -> dict:
    # The fs cycle's child must have died by SIGKILL (rc -9) from its own
    # armed site: proof that a kill landed inside the save window.
    fs = [c for c in cycles if c["mode"] == "fs"]
    return {"ok": bool(fs) and all(c["returncode"] == -9 for c in fs),
            "fs_cycles": [c["cycle"] for c in fs]}


def _manifest_walk_check(ckpt: Path) -> dict:
    from . import checkpoint as integrity

    walk = integrity.verify_checkpoint_dir(ckpt)  # newest first
    return {
        # No live step may verify corrupt, and the newest step (what the
        # next resume restores) must be intact.
        "ok": bool(walk) and walk[0]["status"] == "intact"
        and not any(e["status"] == "corrupt" for e in walk),
        "steps": [(e["step"], e["status"]) for e in walk],
    }


def _stranded_tmp_check(workdir: Path) -> dict:
    from .durability import find_stranded_tmp

    # The sweeper's own discovery; the soak's logs/ are its bookkeeping.
    stranded = find_stranded_tmp(workdir, exclude_substr=(".corrupt", "logs"))
    return {"ok": not stranded, "stranded": [str(p) for p in stranded]}


def _commit_log_check(root: Path, read_journal) -> dict:
    """Within a run committed steps strictly increase and stay above the
    run's resume point; across runs a step recommits only when the later
    run journaled a resume below it (it re-ran the span after a fallback
    moved the first copy aside). A recommit by a run that restored at or
    above that step would mean two processes owned the same step."""
    exp = root / "chaos"
    runs = sorted((p for p in exp.iterdir() if p.is_dir()),
                  key=lambda p: p.stat().st_mtime) if exp.is_dir() else []
    problems: list[str] = []
    recommitted: list[int] = []
    committed_ever: dict[int, str] = {}  # step -> run_id of last commit
    for run_dir in runs:
        resume_step = -1
        last = -1
        for e in read_journal(run_dir):
            if e["event"] == "resume":
                resume_step = int(e["step"])
                last = max(last, resume_step)
            elif e["event"] == "checkpoint":
                s = int(e["step"])
                if s <= last:
                    problems.append(f"{run_dir.name}: commit {s} not increasing (last {last})")
                if s in committed_ever:
                    recommitted.append(s)
                    if resume_step >= s:
                        problems.append(
                            f"{run_dir.name}: step {s} recommitted after resuming at "
                            f"{resume_step} >= {s} (first by {committed_ever[s]})")
                committed_ever[s] = run_dir.name
                last = s
    return {"ok": not problems, "problems": problems,
            "committed_steps": sorted(committed_ever),
            "recommitted_after_rollback": sorted(set(recommitted))}


def _flight_recorder_check(root: Path) -> dict:
    """Every SIGKILLed run's trace tail parses (a torn last line is
    tolerated by construction), and at least one killed run left an open
    span of the fit family: the ``fit`` root is open for the whole run, so
    any kill after the run's start leaves one; a kill mid-step leaves an
    open ``train_step`` too."""
    from ..telemetry import flightrec
    from ..tracking import classify_run

    runs_checked = 0
    unparseable: list[str] = []
    open_names: list[list[str]] = []
    exp = root / "chaos"
    run_dirs = sorted(p for p in exp.iterdir() if p.is_dir()) if exp.is_dir() else []
    for run_dir in run_dirs:
        cls = classify_run(run_dir)
        if cls["effective_status"] != "INTERRUPTED":
            continue  # finished runs close every span; nothing to prove
        trace_file = cls.get("trace_file")
        if not trace_file or not Path(trace_file).exists():
            continue  # killed before the recorder was enabled: no tail owed
        runs_checked += 1
        events = flightrec.read_events(trace_file)
        if not events:
            unparseable.append(str(trace_file))
            continue
        _complete, opens = flightrec.reconstruct(events)
        open_names.append(sorted({o.get("name", "?") for o in opens}))
    any_inflight = any(set(names) & FIT_FAMILY for names in open_names)
    return {
        # A soak whose kills all landed before the recorder proved nothing.
        "ok": runs_checked > 0 and not unparseable and any_inflight,
        "interrupted_runs_with_tail": runs_checked,
        "unparseable": unparseable,
        "open_spans_per_run": open_names,
    }


def _parity_check(ckpt: Path, ref_ckpt: Path) -> dict:
    chaos_step, chaos_digest = _tree_digest(ckpt)
    ref_step, ref_digest = _tree_digest(ref_ckpt)
    return {
        "ok": chaos_digest is not None and chaos_step == ref_step
        and chaos_digest == ref_digest,
        "chaos": {"step": chaos_step, "digest": chaos_digest},
        "ref": {"step": ref_step, "digest": ref_digest},
    }


def _flatten(prefix: str, obj, out: dict) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(f"{prefix}/{i}", v, out)
    else:
        out[prefix] = obj


def step_digest(step_dir) -> str:
    """blake2b over one checkpoint step's model state dict and optimizer
    state, flattened to paths and hashed in sorted path order (a tensor's
    path, dtype, element count and raw bytes; a plain value's repr): two steps
    digest alike exactly when their parameters and Adam state are equal
    bit for bit."""
    import torch

    state = torch.load(Path(step_dir) / "state.pt", map_location="cpu", weights_only=True)
    leaves: dict = {}
    _flatten("", {"model": state["model"], "optimizer": state["optimizer"]}, leaves)
    h = hashlib.blake2b(digest_size=16)
    for path in sorted(leaves):
        leaf = leaves[path]
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()


def _tree_digest(ckpt_dir: Path) -> tuple[int | None, str | None]:
    """``(final step, its step_digest)`` of the newest intact checkpoint:
    the bitwise-equality probe."""
    from . import checkpoint as integrity

    ckpt_dir = Path(ckpt_dir)
    for step in sorted(integrity.list_steps(ckpt_dir), reverse=True):
        status, _ = integrity.verify_step(ckpt_dir / str(step))
        if status == "corrupt":
            continue
        try:
            return step, step_digest(ckpt_dir / str(step))
        except (OSError, RuntimeError, KeyError, ValueError):
            continue
    return None, None


# -- the hpo soak -------------------------------------------------------------


def _soak_hpo(cfg: ChaosConfig, workdir: Path) -> dict:
    from ..tracking import list_runs, read_journal, sweep_interrupted

    root = workdir / "runs"
    rng = random.Random(cfg.seed)
    argv = ["hpo", "--bytes", "2e4", "--parallelism", "2", "--max-evals", str(cfg.max_evals),
            "--experiment", "chaos-hpo", "--tracking-root", str(root), "--resume-auto"]
    cycles: list[dict] = []
    for i in range(cfg.cycles):
        proc = _launch(cfg, argv, workdir / "logs" / f"hpo{i}.log")
        rec = _kill_cycle(cfg, proc, "delay", rng.uniform(cfg.kill_min_s, cfg.kill_max_s),
                          workdir, set())
        rec["cycle"] = i
        cycles.append(rec)
        if rec["returncode"] == 0:
            break
    proc = _launch(cfg, argv, workdir / "logs" / "hpo_final.log")
    final_rc = _wait(proc, cfg.timeout_s)

    sweep_interrupted(root)
    statuses = [m.get("status") for m in list_runs(root)]
    tids: set[int] = set()
    duplicate_tids: set[int] = set()
    exp = root / "chaos-hpo"
    for run_dir in (p for p in exp.iterdir() if p.is_dir()) if exp.is_dir() else []:
        for e in read_journal(run_dir):
            if e["event"] == "trial":
                tid = int(e["tid"])
                (duplicate_tids if tid in tids else tids).add(tid)
    invariants = {
        "final_run_completed": {"ok": final_rc == 0, "final_rc": final_rc},
        # Every trial completed at least once. Duplicates are reported but
        # legal: resume keeps only the contiguous journaled-tid prefix, so
        # re-running the truncated tail is correct recovery work.
        "all_trials_completed": {"ok": tids == set(range(cfg.max_evals)),
                                 "tids": sorted(tids),
                                 "rerun_after_truncation": sorted(duplicate_tids)},
        "runs_terminal": {
            "ok": bool(statuses) and all(s in ("FINISHED", "FAILED", "INTERRUPTED")
                                         for s in statuses),
            "statuses": statuses,
        },
        "no_stranded_tmp": _stranded_tmp_check(workdir),
    }
    return {"workload": "hpo", "seed": cfg.seed, "device": cfg.device, "cycles": cycles,
            "kills_delivered": sum(1 for c in cycles if c["killed_by_supervisor"]),
            "final_returncode": final_rc, "invariants": invariants,
            "ok": all(v.get("ok") for v in invariants.values())}


# -- the serve soak -----------------------------------------------------------


def _soak_serve(cfg: ChaosConfig, workdir: Path) -> dict:
    """Kill/restart cycles for the serving lifecycle: after every SIGKILL
    the restarted server must come back READY on the same checkpoint
    (crash-only restart needs no drain bookkeeping)."""
    import http.client
    import socket

    if not cfg.checkpoint_dir:
        raise ValueError("chaos --workload serve needs --checkpoint-dir")

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def ready(proc: subprocess.Popen, port: int, deadline_s: float) -> bool:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=1.0)
                conn.request("GET", "/readyz")
                if conn.getresponse().status == 200:
                    return True
            except OSError:
                pass
            time.sleep(0.1)
        return False

    cycles = []
    ok = True
    for i in range(max(cfg.cycles, 1)):
        port = free_port()
        proc = _launch(cfg, ["serve", "--checkpoint-dir", str(cfg.checkpoint_dir),
                             "--port", str(port)], workdir / "logs" / f"serve{i}.log")
        came_up = ready(proc, port, cfg.timeout_s)
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
        cycles.append({"cycle": i, "port": port, "ready": came_up,
                       "returncode": proc.returncode})
        ok = ok and came_up
    return {"workload": "serve", "device": cfg.device, "cycles": cycles,
            "kills_delivered": sum(1 for c in cycles if c["returncode"] == -9),
            "invariants": {"ready_after_each_restart": {"ok": ok}}, "ok": ok}
