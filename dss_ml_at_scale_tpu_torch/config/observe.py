"""The operability commands of the port's CLI: ``chaos``, ``telemetry``,
``trace tail|export|attribution``, ``slo status|check|watch`` (with the
``--fleet`` merge) and ``top``.

Ports of the JAX package's commands (``config/commands.py``), with their
flags, defaults, output and exit codes; ``chaos`` adds ``--device`` (every
child's, default ``cuda``: a soak asked for the card where there is none
is refused). ``trace attribution`` buckets a step's spans by the port
catalog's ``SPAN_ATTRIBUTION``. They read run directories, span files and
the ``/slo``, ``/metrics`` and ``/telemetry`` endpoints of a running
``serve`` or ``serve-lm``; only ``chaos`` starts work on a device, in its
children.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def register_all(sub: argparse._SubParsersAction) -> None:
    register_chaos(sub)
    register_telemetry(sub)
    register_trace(sub)
    register_slo(sub)
    register_top(sub)


def register_chaos(sub: argparse._SubParsersAction) -> None:
    ch = sub.add_parser(
        "chaos",
        help="SIGKILL chaos soak: run train/hpo/serve as "
        "subprocesses, hard-kill them on a seeded schedule (including "
        "inside the checkpoint-save window via kN fs.* fault entries), "
        "restart with --resume-auto, and assert the crash-only "
        "invariants (bitwise final-params parity with an uninterrupted "
        "run, clean manifest walk, zero stranded .tmp files, every run "
        "terminal)",
    )
    ch.add_argument("--workdir", required=True,
                    help="scratch directory for data/checkpoints/runs/logs")
    ch.add_argument("--workload", choices=["train", "hpo", "serve"],
                    default="train")
    ch.add_argument("--cycles", type=int, default=5,
                    help="SIGKILL cycles before the final uninterrupted run")
    ch.add_argument("--seed", type=int, default=0)
    ch.add_argument("--kill-min", type=float, default=1.0,
                    help="delay-mode kill window lower bound (seconds)")
    ch.add_argument("--kill-max", type=float, default=6.0)
    ch.add_argument("--epochs", type=int, default=3)
    ch.add_argument("--rows", type=int, default=48)
    ch.add_argument("--batch-size", type=int, default=16)
    ch.add_argument("--image-size", type=int, default=32)
    ch.add_argument("--max-evals", type=int, default=8,
                    help="(hpo workload) sweep size")
    ch.add_argument("--checkpoint-dir", default=None,
                    help="(serve workload) trained checkpoint to serve")
    ch.add_argument("--timeout", type=float, default=300.0,
                    help="per-child wall bound (seconds)")
    ch.add_argument("--json", action="store_true",
                    help="emit the full soak report as one JSON document")
    ch.add_argument("--device", default="cuda",
                    help="torch device of every child (cuda, cuda:N, or cpu)")
    ch.set_defaults(fn=_cmd_chaos)


def _cmd_chaos(args: argparse.Namespace) -> int:
    from ..resilience.chaos import ChaosConfig, run_chaos
    from .cli import _no_card

    if _no_card(args.device):
        return 1
    report = run_chaos(ChaosConfig(
        workdir=args.workdir,
        workload=args.workload,
        cycles=args.cycles,
        seed=args.seed,
        kill_min_s=args.kill_min,
        kill_max_s=args.kill_max,
        epochs=args.epochs,
        rows=args.rows,
        batch_size=args.batch_size,
        image_size=args.image_size,
        max_evals=args.max_evals,
        checkpoint_dir=args.checkpoint_dir,
        timeout_s=args.timeout,
        device=args.device,
    ))
    if args.json:
        print(json.dumps(report))
    else:
        for c in report.get("cycles", []):
            print(f"cycle {c.get('cycle')}: mode={c.get('mode')} "
                  f"rc={c.get('returncode')} wall={c.get('wall_s')}s")
        for name, res in report["invariants"].items():
            print(f"invariant {name}: {'OK' if res.get('ok') else 'FAIL'}"
                  + ("" if res.get("ok") else f" {json.dumps(res)}"))
        print(f"chaos soak: {'OK' if report['ok'] else 'FAILED'}")
    return 0 if report["ok"] else 1


def register_telemetry(sub: argparse._SubParsersAction) -> None:
    tl = sub.add_parser(
        "telemetry",
        help="inspect a run's archived telemetry snapshot and export "
        "span logs as Chrome/Perfetto traces",
    )
    tl.add_argument(
        "--run", default=None, metavar="DIR",
        help="run directory (<root>/<experiment>/<run_id>, as `runs "
        "list` points at) whose telemetry.json to print",
    )
    tl.add_argument(
        "--json", action="store_true",
        help="print the raw snapshot JSON instead of a table",
    )
    tl.add_argument(
        "--export-perfetto", default=None, metavar="OUT",
        help="write a Chrome trace_event JSON (loads in ui.perfetto.dev) "
        "converted from a span JSONL (--spans, or the --run's archived "
        "artifacts/spans.jsonl)",
    )
    tl.add_argument(
        "--spans", default=None, metavar="JSONL",
        help="span JSONL to convert (default: <--run>/artifacts/spans.jsonl)",
    )
    tl.set_defaults(fn=_cmd_telemetry)


def _cmd_telemetry(args: argparse.Namespace) -> int:
    did_something = False
    rc = 0
    # Snapshot first: a missing/empty span archive must not swallow a
    # perfectly readable telemetry.json.
    if args.run:
        snap_file = Path(args.run) / "telemetry.json"
        if not snap_file.exists():
            print(f"no telemetry.json under {args.run} (was the run "
                  "finished by a telemetry-aware CLI?)")
            rc = 1
        else:
            snapshot = json.loads(snap_file.read_text())
            if args.json:
                print(json.dumps(snapshot, indent=1))
            else:
                _print_snapshot_table(snapshot)
            did_something = True
    if args.export_perfetto:
        from ..telemetry import export_perfetto

        spans = args.spans or (
            str(Path(args.run) / "artifacts" / "spans.jsonl")
            if args.run else None
        )
        if spans is None:
            print("--export-perfetto needs --spans (or --run with an "
                  "archived spans.jsonl)")
            return 2
        if not Path(spans).exists():
            print(f"no span log at {spans}")
            return 1
        n = export_perfetto(spans, args.export_perfetto)
        print(f"perfetto trace: {n} events -> {args.export_perfetto}")
        did_something = True
    if not did_something and rc == 0:
        print("nothing to do: pass --run and/or --export-perfetto")
        return 2
    return rc


def _print_snapshot_table(snapshot: dict) -> None:
    rows = []
    for m in snapshot.get("metrics", []):
        labels = m.get("labels") or {}
        name = m["name"] + (
            "{" + ",".join(f'{k}={v}' for k, v in labels.items()) + "}"
            if labels else ""
        )
        if m.get("type") == "histogram":
            count = m.get("count", 0)
            mean = (m.get("sum", 0.0) / count) if count else 0.0
            value = (f"count={count} sum={m.get('sum', 0.0):.6g} "
                     f"mean={mean:.6g}")
        elif m.get("type") == "window":
            qs = " ".join(
                f"p{float(q) * 100:g}="
                + (f"{v:.6g}" if v is not None else "-")
                for q, v in sorted(m.get("quantiles", {}).items())
            )
            value = (f"count={m.get('count', 0)} {qs} "
                     f"[{m.get('window_s', 0):g}s window]")
        else:
            value = f"{m.get('value', 0.0):.6g}"
        rows.append((name, m.get("type", "?"), value))
    if not rows:
        print("(empty snapshot)")
        return
    width = max(len(r[0]) for r in rows)
    print(f"{'METRIC':<{width}}  {'TYPE':<9}  VALUE")
    for name, kind, value in rows:
        print(f"{name:<{width}}  {kind:<9}  {value}")


def register_trace(sub: argparse._SubParsersAction) -> None:
    tr = sub.add_parser(
        "trace",
        help="causal tracing tools over a run's flight-recorder tail "
        "(or any span JSONL): tail reconstructs a dead run's last "
        "events including spans still open at the kill, export writes "
        "a Perfetto trace with cross-thread flow arrows per trace id, "
        "attribution breaks each training step into "
        "data-wait/transfer/compute/host and flags step-time anomalies "
        "with their causal children",
    )
    tsub = tr.add_subparsers(dest="trace_cmd", required=True)

    def _add_source(p):
        p.add_argument(
            "--run", default=None, metavar="DIR",
            help="run directory (<root>/<experiment>/<run_id>): reads "
            "the flight-recorder tail its journal registered "
            "(flightrec.jsonl)",
        )
        p.add_argument(
            "--file", default=None, metavar="JSONL",
            help="explicit flight-recorder tail or span JSONL "
            "(overrides --run)",
        )

    tl = tsub.add_parser(
        "tail",
        help="the last events of a (possibly SIGKILLed) run; "
        "begin-only spans are flagged OPEN — the in-flight work at "
        "the kill",
    )
    _add_source(tl)
    tl.add_argument("-n", "--events", type=int, default=32,
                    help="how many trailing events to show")
    tl.add_argument("--json", action="store_true",
                    help="one JSON object per line instead of the table")
    tl.set_defaults(fn=_cmd_trace_tail)

    ex = tsub.add_parser(
        "export",
        help="Perfetto trace_event JSON: labeled process/thread lanes "
        "(ph M) and flow arrows (ph s/f) stitching each trace id "
        "across threads; loads in ui.perfetto.dev",
    )
    _add_source(ex)
    ex.add_argument(
        "--merge", nargs="+", default=None, metavar="JSONL",
        help="merge N replicas' recorder files into ONE timeline: each "
        "file gets its own pid band + process lane, and propagated "
        "trace ids draw flow arrows ACROSS files (overrides "
        "--run/--file)",
    )
    ex.add_argument("--out", required=True, metavar="OUT",
                    help="output trace file")
    ex.set_defaults(fn=_cmd_trace_export)

    at = tsub.add_parser(
        "attribution",
        help="per-step breakdown (data-wait / transfer / compute / "
        "host) from the step traces, plus z-score step-time anomalies "
        "with the anomalous step's causal children",
    )
    _add_source(at)
    at.add_argument("--zscore", type=float, default=3.0,
                    help="|z| threshold flagging a step-time anomaly")
    at.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON document")
    at.set_defaults(fn=_cmd_trace_attribution)


def _trace_source(args: argparse.Namespace) -> Path | None:
    """Resolve tail|export|attribution's input file; None + message on
    failure (callers exit 2)."""
    if args.file:
        p = Path(args.file)
        if not p.exists():
            print(f"no trace file at {p}")
            return None
        return p
    if args.run:
        from ..tracking import classify_run

        cls = classify_run(args.run)
        candidates = [
            Path(cls["trace_file"]) if cls.get("trace_file") else None,
            Path(args.run) / "flightrec.jsonl",
        ]
        for p in candidates:
            if p is not None and p.exists():
                return p
        print(f"no flight-recorder tail under {args.run} (was the run "
              "started by a trace-aware CLI?)")
        return None
    print("pass --run DIR or --file JSONL")
    return None


def _cmd_trace_tail(args: argparse.Namespace) -> int:
    from ..telemetry import flightrec

    path = _trace_source(args)
    if path is None:
        return 2
    events = flightrec.read_events(path)
    if not events:
        print(f"no parseable events in {path}")
        return 1
    complete, opens = flightrec.reconstruct(events)
    # Trailing window: the last N closed spans, then EVERY open span —
    # the open ones are the point (in-flight work at the kill). The
    # window can be zero (opens alone fill -n); list[-0:] would be the
    # WHOLE list, so slice from an explicit start index.
    n_closed = max(args.events - len(opens), 0)
    rows = complete[len(complete) - min(n_closed, len(complete)):] \
        if n_closed else []
    rows = rows + [{**o, "open": True} for o in opens]
    if args.json:
        for r in rows:
            print(json.dumps(r))
        return 0
    print(f"{path}: {len(complete)} closed span(s), {len(opens)} open")
    for r in rows:
        ts = time.strftime("%H:%M:%S", time.localtime(r.get("ts", 0.0)))
        dur = "OPEN" if r.get("open") else f"{r.get('dur', 0.0)*1e3:9.2f}ms"
        trace = r.get("trace", "-")
        kindtag = f"[{r['kind']}]" if r.get("kind") else ""
        argstr = ""
        if r.get("args"):
            argstr = " " + ",".join(
                f"{k}={v}" for k, v in r["args"].items() if k != "open"
            )
        print(f"{ts} {r.get('thread', '?'):<22} {r.get('name', '?'):<20} "
              f"{dur:>12} trace={trace} {kindtag}{argstr}")
    if opens:
        print(f"{len(opens)} span(s) were OPEN when recording stopped "
              "(in-flight at the kill)")
    return 0


def _cmd_trace_export(args: argparse.Namespace) -> int:
    from ..telemetry.spans import (
        load_span_jsonl,
        merge_replica_spans,
        to_perfetto,
    )

    process_names = None
    if getattr(args, "merge", None):
        missing = [p for p in args.merge if not Path(p).exists()]
        if missing:
            print(f"no trace file at {missing[0]}")
            return 2
        events, process_names = merge_replica_spans(args.merge)
        src = f"{len(args.merge)} file(s)"
    else:
        path = _trace_source(args)
        if path is None:
            return 2
        events = load_span_jsonl(path)
        src = str(path)
    if not events:
        print(f"no parseable events in {src}")
        return 1
    # Build in memory, count from the dict, write once — re-reading the
    # file just written (possibly tens of MB) to count flows is waste.
    trace = to_perfetto(events, process_names=process_names)
    flows = sum(
        1 for e in trace["traceEvents"] if e.get("ph") in ("s", "f")
    )
    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    print(f"perfetto trace: {len(events)} span(s), {flows} flow "
          f"event(s) -> {args.out}")
    return 0


def _cmd_trace_attribution(args: argparse.Namespace) -> int:
    from ..telemetry import flightrec

    # Attribution buckets: span name -> where a step's wall time went,
    # from the port catalog's SPAN_ATTRIBUTION (its names held to
    # KNOWN_SPANS by the catalog test).
    from ..telemetry.catalog import SPAN_ATTRIBUTION as _ATTRIBUTION

    path = _trace_source(args)
    if path is None:
        return 2
    complete, opens = flightrec.reconstruct(flightrec.read_events(path))
    by_trace: dict[str, list[dict]] = {}
    for e in complete:
        if e.get("kind") == "step" and e.get("trace"):
            by_trace.setdefault(e["trace"], []).append(e)
    steps = []
    for trace_id, spans in by_trace.items():
        compute = [s for s in spans if s["name"] == "train_step"]
        if not compute:
            continue  # eval/warmup batches: staged but never stepped
        buckets = {"data_wait": 0.0, "transfer": 0.0, "compute": 0.0,
                   "host": 0.0}
        for s in spans:
            buckets[_ATTRIBUTION.get(s["name"], "host")] += s.get(
                "dur", 0.0
            )
        steps.append({
            "step": (compute[0].get("args") or {}).get("step"),
            "trace": trace_id,
            "ts": compute[0].get("ts", 0.0),
            **{k: round(v * 1e3, 3) for k, v in buckets.items()},
            "total": round(sum(buckets.values()) * 1e3, 3),
            "spans": [
                {"name": s["name"], "thread": s.get("thread"),
                 "dur_ms": round(s.get("dur", 0.0) * 1e3, 3)}
                for s in sorted(spans, key=lambda s: s.get("ts", 0.0))
            ],
        })
    if not steps:
        print(f"no step traces in {path} (is this a training run's "
              "flight recorder?)")
        return 1
    steps.sort(key=lambda s: s["ts"])
    # Anomalies are flagged on TOTAL traced step time: a data-wait or
    # transfer spike IS a step-time anomaly (the feeder-stall case this
    # tool exists to surface) even when compute stays nominal.
    durs = [s["total"] for s in steps]
    mean = sum(durs) / len(durs)
    var = sum((d - mean) ** 2 for d in durs) / len(durs)
    std = var ** 0.5
    anomalies = []
    for s in steps:
        z = (s["total"] - mean) / std if std > 0 else 0.0
        s["z"] = round(z, 2)
        if abs(z) >= args.zscore:
            anomalies.append(s)
    report = {
        "file": str(path),
        "steps": len(steps),
        "total_ms_mean": round(mean, 3),
        "total_ms_std": round(std, 3),
        "compute_ms_mean": round(
            sum(s["compute"] for s in steps) / len(steps), 3
        ),
        "data_wait_ms_mean": round(
            sum(s["data_wait"] for s in steps) / len(steps), 3
        ),
        "transfer_ms_mean": round(
            sum(s["transfer"] for s in steps) / len(steps), 3
        ),
        "host_ms_mean": round(
            sum(s["host"] for s in steps) / len(steps), 3
        ),
        "zscore_threshold": args.zscore,
        "anomalies": anomalies,
        "open_spans": [o.get("name") for o in opens],
    }
    if args.json:
        report["per_step"] = [
            {k: v for k, v in s.items() if k != "spans"} for s in steps
        ]
        print(json.dumps(report))
        return 0
    print(f"{len(steps)} step(s): total {mean:.3f}ms ± {std:.3f}ms, "
          f"compute {report['compute_ms_mean']}ms, "
          f"data-wait {report['data_wait_ms_mean']}ms, "
          f"transfer {report['transfer_ms_mean']}ms, "
          f"host {report['host_ms_mean']}ms (means per step)")
    hdr = (f"{'STEP':>6} {'DATA':>9} {'XFER':>9} {'COMPUTE':>9} "
           f"{'HOST':>9} {'TOTAL':>9} {'Z':>6}")
    print(hdr)
    for s in steps:
        print(f"{str(s['step']):>6} {s['data_wait']:>9.3f} "
              f"{s['transfer']:>9.3f} {s['compute']:>9.3f} "
              f"{s['host']:>9.3f} {s['total']:>9.3f} {s['z']:>6.2f}")
    for a in anomalies:
        print(f"anomaly: step {a['step']} (z={a['z']}) — causal children:")
        for s in a["spans"]:
            print(f"    {s['name']:<20} {s['dur_ms']:>9.3f}ms "
                  f"on {s['thread']}")
    if not anomalies:
        print(f"no |z| >= {args.zscore:g} step-time anomalies")
    return 0


# --------------------------------------------------------------------------
# slo / top (the live monitoring plane's CLI face)
# --------------------------------------------------------------------------

def _add_slo_source_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--url", default="http://127.0.0.1:8008", metavar="URL",
        help="a running serve or serve-lm process (its /slo endpoint is "
        "scraped); default matches `serve`'s default port",
    )
    p.add_argument(
        "--report", default=None, metavar="JSON",
        help="judge a saved document instead of a live process: either "
        "a raw /slo status JSON or a bench --json artifact "
        "whose serving scenario embedded one (results.serving.extra."
        "slo)",
    )


def register_slo(sub: argparse._SubParsersAction) -> None:
    so = sub.add_parser(
        "slo",
        help="live SLOs: declared objectives, windowed values, "
        "burn rates, and alert states — baseline-free (the objectives "
        "are code, telemetry.slo.default_objectives)",
    )
    ssub = so.add_subparsers(dest="slo_cmd", required=True)
    st = ssub.add_parser(
        "status", help="one status frame: every objective's live "
        "value, budget remaining, burn rates, and alert state",
    )
    _add_slo_source_args(st)
    _add_fleet_args(st)
    st.add_argument("--json", action="store_true",
                    help="print the raw /slo document (schema v1)")
    st.set_defaults(fn=_cmd_slo_status)
    ck = ssub.add_parser(
        "check", help="gate on the SLO plane: exit 1 if any objective "
        "is firing",
    )
    _add_slo_source_args(ck)
    _add_fleet_args(ck)
    ck.add_argument("--json", action="store_true")
    ck.add_argument(
        "--strict", action="store_true",
        help="also fail on objectives in the pending state",
    )
    ck.set_defaults(fn=_cmd_slo_check)
    wa = ssub.add_parser(
        "watch", help="poll /slo and redraw the status frame",
    )
    _add_slo_source_args(wa)
    _add_fleet_args(wa)
    wa.add_argument("--interval", type=float, default=2.0,
                    metavar="SECONDS")
    wa.add_argument(
        "--iterations", type=int, default=0, metavar="N",
        help="stop after N frames (0 = until Ctrl-C)",
    )
    wa.set_defaults(fn=_cmd_slo_watch)


def _slo_parse_url(url: str) -> tuple[str, int]:
    if "://" in url and not url.startswith("http://"):
        # A clear refusal beats the int() parse error https:// would
        # otherwise surface as.
        raise ValueError(
            f"only http:// URLs are supported, got {url!r}"
        )
    hostport = url.removeprefix("http://").rstrip("/")
    host, _, port_s = hostport.partition(":")
    return host or "127.0.0.1", int(port_s or 8008)


def _slo_http_json(url: str, path: str) -> dict:
    import http.client

    host, port = _slo_parse_url(url)
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise OSError(f"GET {path} -> HTTP {resp.status}")
    return json.loads(body)


def _slo_fetch_status(args: argparse.Namespace) -> dict | None:
    """The /slo document from --report or --url; None (with a message
    on stderr) when the source is unusable — callers exit 2."""
    if args.report:
        try:
            doc = json.loads(Path(args.report).read_text())
        except (OSError, json.JSONDecodeError) as e:
            print(f"slo: cannot read --report {args.report}: {e}",
                  file=sys.stderr)
            return None
        if "objectives" not in doc:
            # A bench --json artifact: the serving scenario embeds
            # the stub server's /slo snapshot in its extra block.
            doc = (
                doc.get("results", {}).get("serving", {})
                .get("extra", {}).get("slo")
            )
        if not isinstance(doc, dict) or "objectives" not in doc:
            print(
                f"slo: {args.report} carries no SLO status "
                "document (expected a /slo JSON or a bench artifact "
                "with results.serving.extra.slo)",
                file=sys.stderr,
            )
            return None
        return doc
    try:
        return _slo_http_json(args.url, "/slo")
    except (OSError, ValueError) as e:
        print(f"slo: cannot scrape {args.url}/slo: {e}",
              file=sys.stderr)
        return None


def _slo_fmt_value(obj: dict) -> str:
    v = obj.get("value")
    if v is None:
        return "-"
    if obj.get("unit") == "s":
        return f"{v * 1000:.1f}ms"
    return f"{v:.4g}"


def _slo_fmt_budget(obj: dict) -> str:
    b = obj.get("budget")
    if b is None:
        return "unarmed"
    if obj.get("unit") == "s":
        return f"{b * 1000:g}ms"
    return f"{b:g}"


def _slo_render_text(doc: dict) -> list[str]:
    rows = [
        (
            o["name"], o["state"], _slo_fmt_value(o), _slo_fmt_budget(o),
            f"{o['burn_fast']:.2f}/{o['burn_slow']:.2f}",
            ("-" if o.get("budget_remaining") is None
             else f"{o['budget_remaining']:.2f}"),
            str(o.get("samples", 0)),
        )
        for o in doc.get("objectives", [])
    ]
    header = ("OBJECTIVE", "STATE", "VALUE", "BUDGET", "BURN f/s",
              "REMAINING", "SAMPLES")
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows
        else len(header[i])
        for i in range(len(header))
    ]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    firing = doc.get("firing", [])
    lines.append(
        "firing: " + (", ".join(firing) if firing else "(none)")
    )
    return lines


# -- fleet mode (slo --fleet / top --fleet) ---------------------------------


def _add_fleet_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--fleet", nargs="+", default=None, metavar="ENDPOINT",
        help="fleet mode: scrape N replicas' /telemetry endpoints "
        "(host:port ...), merge their registries and SLO windows, and "
        "judge the FLEET instead of one process",
    )
    p.add_argument(
        "--fleet-timeout", type=float, default=2.0, metavar="SECONDS",
        help="per-cycle scrape budget; a replica that doesn't answer "
        "inside it costs its column, never the cycle",
    )
    p.add_argument(
        "--fleet-journal", default=None, metavar="JSONL",
        help="journal each fleet scrape cycle crash-durably to this "
        "path (outcome per replica, merged firing set)",
    )


def _fleet_aggregator(args: argparse.Namespace):
    from ..telemetry import federation

    return federation.FleetAggregator(
        args.fleet,
        timeout_s=args.fleet_timeout,
        journal_path=args.fleet_journal,
    )


def _fleet_replica_rows(view) -> list[str]:
    """Per-replica columns: liveness, that replica's OWN live p99 +
    request count (off its raw window wire), staleness, scrape cost."""
    from ..telemetry import windows as _windows

    rows = []
    for r in view.replicas:
        p99 = reqs = None
        if r.doc is not None:
            for m in r.doc.get("metrics", ()):
                if m.get("name") == "serving_request_window_seconds":
                    wire = m.get("wire") or {}
                    try:
                        p99 = _windows.quantile_of_wire(wire, 0.99)
                        reqs = int(wire.get("count", 0))
                    except (ValueError, TypeError, KeyError):
                        pass
                    break
        rows.append((
            r.endpoint,
            r.outcome,
            "-" if p99 is None else f"{p99 * 1000:.1f}ms",
            "-" if reqs is None else str(reqs),
            ("-" if r.staleness_s is None
             else f"{r.staleness_s:.0f}s"),
            f"{r.elapsed_s * 1000:.0f}ms",
        ))
    header = ("REPLICA", "STATE", "p99", "REQS", "STALE", "SCRAPE")
    widths = [
        max(len(header[i]), *(len(r[i]) for r in rows)) if rows
        else len(header[i])
        for i in range(len(header))
    ]
    lines = ["  ".join(h.ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return lines


def _fleet_window_rows(view) -> list[str]:
    """The MERGED windowed quantile series — the fleet-wide sibling of
    `top`'s per-process windows section."""
    rows = []
    for fam in view.registry.families():
        if fam.kind != "window":
            continue
        for labels, sample in fam._series():
            label_txt = ",".join(
                f"{k}={v}" for k, v in sorted(labels.items())
            )
            name = fam.name + (f"{{{label_txt}}}" if label_txt else "")
            cells = " ".join(
                f"p{float(q) * 100:g}="
                + ("-" if v is None else f"{v * 1000:.2f}ms")
                for q, v in sorted(sample.get("quantiles", {}).items())
            )
            rows.append(
                f"  {name:<44} {cells}  n={sample.get('count', 0)}"
            )
    return rows


def _fleet_doc(view) -> dict:
    """The fleet status document (--json shape): per-replica outcomes
    plus the merged SLO judgment."""
    return {
        "version": 1,
        "ts": round(view.ts, 3),
        "up": view.up,
        "replicas": [
            {
                "endpoint": r.endpoint,
                "up": r.up,
                "outcome": r.outcome,
                "elapsed_ms": round(r.elapsed_s * 1000, 1),
                "staleness_s": (
                    round(r.staleness_s, 1)
                    if r.staleness_s is not None else None
                ),
                **({"error": r.error} if r.error else {}),
            }
            for r in view.replicas
        ],
        "merged_series": view.merged_series,
        "slo": view.slo,
    }


def _fleet_frame(agg, view, *, windows: bool = False) -> list[str]:
    lines = [
        f"dsst fleet — {len(agg.endpoints)} endpoint(s), "
        f"{view.up} up  {time.strftime('%H:%M:%S')}",
        "",
    ]
    lines.extend(_fleet_replica_rows(view))
    lines.append("")
    lines.extend(_slo_render_text(view.slo))
    if windows:
        rows = _fleet_window_rows(view)
        if rows:
            lines.append("")
            lines.append("fleet windows (merged):")
            lines.extend(rows)
    return lines


def _cmd_slo_status(args: argparse.Namespace) -> int:
    if args.fleet:
        agg = _fleet_aggregator(args)
        view = agg.scrape()
        if args.json:
            print(json.dumps(_fleet_doc(view), indent=1))
        else:
            for line in _fleet_frame(agg, view):
                print(line)
        return 0
    doc = _slo_fetch_status(args)
    if doc is None:
        return 2
    if args.json:
        print(json.dumps(doc, indent=1))
    else:
        for line in _slo_render_text(doc):
            print(line)
    return 0


def _cmd_slo_check(args: argparse.Namespace) -> int:
    if args.fleet:
        from ..telemetry import federation

        agg = _fleet_aggregator(args)
        view = agg.scrape()
        if view.up == 0:
            print("slo: no replica answered the fleet scrape",
                  file=sys.stderr)
            return 2
        # One-shot judgment: a fresh state machine has had no cycles
        # to debounce pending→firing, so "burning" is the raw
        # two-window condition (federation.burning) — plus anything
        # already firing in the merged judgment.
        bad = federation.burning(view.slo)
        if args.strict:
            bad = sorted(set(bad) | {
                o["name"] for o in view.slo.get("objectives", [])
                if o.get("state") == "pending"
            })
        if args.json:
            print(json.dumps({
                **_fleet_doc(view),
                "ok": not bad,
                "failing": bad,
            }, indent=1))
        else:
            for line in _fleet_frame(agg, view):
                print(line)
            print("fleet slo check: "
                  + ("OK" if not bad else "FAILING " + ", ".join(bad)))
        return 1 if bad else 0
    doc = _slo_fetch_status(args)
    if doc is None:
        return 2
    bad = list(doc.get("firing", []))
    if args.strict:
        bad += [
            o["name"] for o in doc.get("objectives", [])
            if o.get("state") == "pending"
        ]
    if args.json:
        print(json.dumps({
            "version": doc.get("version", 1),
            "ok": not bad,
            "failing": sorted(set(bad)),
            "objectives": doc.get("objectives", []),
        }, indent=1))
    else:
        for line in _slo_render_text(doc):
            print(line)
        print("slo check: "
              + ("OK" if not bad else "FAILING " + ", ".join(sorted(set(bad)))))
    return 1 if bad else 0


def _cmd_slo_watch(args: argparse.Namespace) -> int:
    frames = 0
    # ONE aggregator across frames: the fleet alert state machine and
    # staleness clocks must persist or pending can never reach firing.
    agg = _fleet_aggregator(args) if args.fleet else None
    try:
        while True:
            if agg is not None:
                view = agg.scrape()
                print("\x1b[2J\x1b[H", end="")
                for line in _fleet_frame(agg, view):
                    print(line)
            else:
                doc = _slo_fetch_status(args)
                if doc is None:
                    return 2
                print("\x1b[2J\x1b[H", end="")
                print(f"dsst slo watch — {args.report or args.url}  "
                      f"{time.strftime('%H:%M:%S')}")
                for line in _slo_render_text(doc):
                    print(line)
            frames += 1
            if args.iterations and frames >= args.iterations:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def register_top(sub: argparse._SubParsersAction) -> None:
    tp = sub.add_parser(
        "top",
        help="live terminal view of a serving process: windowed "
        "latency quantiles, SLO budget remaining, firing alerts, and "
        "the scheduler/feeder gauges, fused from /slo + /metrics",
    )
    tp.add_argument(
        "--url", default="http://127.0.0.1:8008", metavar="URL",
        help="the serve or serve-lm process to watch",
    )
    _add_fleet_args(tp)
    tp.add_argument("--interval", type=float, default=2.0,
                    metavar="SECONDS")
    tp.add_argument(
        "--once", action="store_true",
        help="print one frame and exit (scripting/tests)",
    )
    tp.set_defaults(fn=_cmd_top)


def _top_parse_metrics(text: str) -> tuple[dict, dict]:
    """Prometheus text → (plain series, labeled series).

    ``plain`` maps bare series names to floats; ``labeled`` maps name →
    list of ``(label_dict, value)``.
    """
    import re

    plain: dict[str, float] = {}
    labeled: dict[str, list] = {}
    label_re = re.compile(r'(\w+)="([^"]*)"')
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        name, _, value_s = line.rpartition(" ")
        name = name.strip()
        try:
            value = float(value_s)
        except ValueError:
            continue
        if "{" in name:
            base, _, rest = name.partition("{")
            labels = dict(label_re.findall(rest))
            labeled.setdefault(base, []).append((labels, value))
        else:
            plain[name] = value
    return plain, labeled


_TOP_GAUGES = (
    "serving_queue_depth",
    "admission_service_rate_ewma",
    "admission_est_queue_wait_ms",
    "slo_alerts_firing",
)


def _top_frame(url: str) -> list[str]:
    doc = _slo_http_json(url, "/slo")
    import http.client

    host, port = _slo_parse_url(url)
    conn = http.client.HTTPConnection(host, port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        text = resp.read().decode()
    finally:
        conn.close()
    plain, labeled = _top_parse_metrics(text)

    lines = [f"dsst top — {url}  {time.strftime('%H:%M:%S')}", ""]
    lines.extend(_slo_render_text(doc))
    lines.append("")
    # Windowed quantile series: every summary family on /metrics (the
    # window kind renders quantile-labeled samples). The _count join
    # must follow the same label split: a labeled family's _count line
    # carries the labels too, so it parses into `labeled`, keyed by
    # the identical non-quantile label tuple.
    labeled_counts: dict[tuple[str, tuple], float] = {}
    for lname, series in labeled.items():
        if not lname.endswith("_count"):
            continue
        for labels, value in series:
            labeled_counts[
                (lname[: -len("_count")],
                 tuple(sorted(labels.items())))
            ] = value
    window_rows = []
    for base, series in sorted(labeled.items()):
        by_labels: dict[tuple, dict] = {}
        for labels, value in series:
            q = labels.get("quantile")
            if q is None:
                continue
            rest = tuple(
                sorted((k, v) for k, v in labels.items()
                       if k != "quantile")
            )
            by_labels.setdefault(rest, {})[q] = value
        for rest, qs in sorted(by_labels.items()):
            label_txt = ",".join(f"{k}={v}" for k, v in rest)
            name = base + (f"{{{label_txt}}}" if label_txt else "")
            cells = " ".join(
                f"p{float(q) * 100:g}="
                + ("-" if v != v else f"{v * 1000:.2f}ms")
                for q, v in sorted(qs.items())
            )
            count = (
                labeled_counts.get((base, rest)) if rest
                else plain.get(f"{base}_count")
            )
            window_rows.append(
                f"  {name:<44} {cells}"
                + (f"  n={count:g}" if count is not None else "")
            )
    if window_rows:
        lines.append("windows:")
        lines.extend(window_rows)
        lines.append("")
    gauge_cells = [
        f"{g}={plain[g]:g}" for g in _TOP_GAUGES if g in plain
    ]
    if gauge_cells:
        lines.append("gauges: " + "  ".join(gauge_cells))
    return lines


def _cmd_top(args: argparse.Namespace) -> int:
    # Fleet mode holds ONE aggregator across frames (persistent alert
    # state machine + staleness clocks), and its frame adds the merged
    # fleet windows under the per-replica columns.
    agg = _fleet_aggregator(args) if args.fleet else None
    try:
        while True:
            if agg is not None:
                view = agg.scrape()
                frame = _fleet_frame(agg, view, windows=True)
            else:
                try:
                    frame = _top_frame(args.url)
                except (OSError, ValueError) as e:
                    print(f"top: cannot scrape {args.url}: {e}",
                          file=sys.stderr)
                    return 2
            if not args.once:
                print("\x1b[2J\x1b[H", end="")
            for line in frame:
                print(line)
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
