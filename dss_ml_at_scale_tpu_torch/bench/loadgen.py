"""Closed-loop load generator for the serving scheduler (library form).

Port of ``dss_ml_at_scale_tpu/bench/loadgen.py``, so the bench harness can
register serving load as a *scenario*: ``threads`` clients each run a
closed loop (send one single-image POST /predict, wait, repeat) for
``duration`` seconds; offered load scales with measured latency, so
numbers compare run to run. Reports p50/p99 latency, throughput, status
mix, and the server's own batch-fill / time-in-queue telemetry as a
before/after ``/metrics`` delta (a shared server doesn't pollute the
numbers). Percentiles go through ``telemetry.windows.quantile``, the
definition the live SLO plane's sketches share.

Two targets: any running ``serve`` (``--url`` + ``--image``), or
``--selftest``: a stub-scorer server in a SUBPROCESS loaded over real
sockets, running the port's scheduler (``serving/scheduler.py``,
``serving/batcher.py``). The stub path measures the SCHEDULER (admission,
decode pool, cross-request batching, HTTP keep-alive), which is exactly
what CI can pin; the subprocess split matters because an in-process
server would share the client threads' GIL and inflate tail latency with
scheduling artifacts. ``--stub-serve-lm`` is the LM engine's twin
(``serving/lm/engine.py``'s ``StubLMDecoder`` behind the real
continuous-batching engine). Either stub exits when its parent dies (EOF
on its stdin).

    python -m dss_ml_at_scale_tpu_torch.bench.loadgen --selftest --threads 8
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

from ..telemetry.tracecontext import Handoff
from ..telemetry.windows import quantile


def percentile(samples, p: float) -> float | None:
    """The shared quantile definition (``telemetry.windows.quantile``) over
    the load's samples, None for none: the offline p50/p99 here and the
    live windowed sketch on /metrics compute the same statistic, so they
    can only differ by the sketch's bounded bucket error."""
    return quantile(samples, p) if samples else None


def _wait_ready(host: str, port: int, timeout_s: float = 30.0) -> None:
    """Poll /healthz until the server answers, with bounded backoff.

    A freshly spawned server (the --selftest subprocess, or a real
    ``serve`` still loading its checkpoint) announces its port before
    the accept loop is warm; connection-refused during that window must
    not fail the whole run. Raises the last error once the budget is
    spent — a server that never comes up is still a loud failure.
    """
    deadline = time.monotonic() + timeout_s
    delay = 0.05
    while True:
        try:
            conn = http.client.HTTPConnection(host, port, timeout=5)
            try:
                conn.request("GET", "/healthz")
                conn.getresponse().read()
            finally:
                conn.close()
            return
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, 1.0)


def _scrape(host: str, port: int) -> dict:
    """Histogram/counter samples from /metrics (Prometheus text)."""
    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    out: dict[str, float] = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        if "{" in name:  # labeled series aren't needed here
            continue
        try:
            out[name.strip()] = float(value)
        except ValueError:
            continue
    return out


def _hist_delta(before: dict, after: dict, name: str) -> dict:
    count = after.get(f"{name}_count", 0.0) - before.get(f"{name}_count", 0.0)
    total = after.get(f"{name}_sum", 0.0) - before.get(f"{name}_sum", 0.0)
    return {
        "count": int(count),
        "mean": (total / count) if count else None,
    }


# dsst: ignore[lock-discipline] cross-thread channels are the Barrier/Event; latencies/statuses are written by the client thread alone and read only after join()
class _Client(threading.Thread):
    """One closed-loop client over ONE keep-alive connection."""

    def __init__(self, host: str, port: int, body: bytes,
                 barrier: threading.Barrier, stop: threading.Event):
        super().__init__(daemon=True)
        self.host, self.port, self.body = host, port, body
        self.barrier, self.stop = barrier, stop
        self.latencies: list[float] = []
        self.statuses: dict[int, int] = {}
        self.errors = 0
        self.propagated = 0

    def run(self) -> None:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        self.barrier.wait()
        while not self.stop.is_set():
            # The client mints the request's identity and injects it —
            # the cross-process half of the Handoff contract. A server
            # that adopts it echoes the SAME trace id back, so the
            # propagated count below verifies end-to-end adoption.
            handoff = Handoff.root("request")
            t0 = time.perf_counter()
            try:
                conn.request("POST", "/predict", body=self.body,
                             headers={"Content-Type": "image/jpeg",
                                      "X-DSST-Trace": handoff.to_header()})
                resp = conn.getresponse()
                resp.read()
                status = resp.status
                echoed = resp.getheader("X-DSST-Trace")
            except Exception:
                self.errors += 1
                conn.close()
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=30
                )
                continue
            self.latencies.append(time.perf_counter() - t0)
            self.statuses[status] = self.statuses.get(status, 0) + 1
            if echoed == handoff.ctx.trace_id:
                self.propagated += 1
        conn.close()


def run_load(host: str, port: int, body: bytes, *, threads: int,
             duration_s: float) -> dict:
    before = _scrape(host, port)
    barrier = threading.Barrier(threads + 1)
    stop = threading.Event()
    clients = [_Client(host, port, body, barrier, stop)
               for _ in range(threads)]
    for c in clients:
        c.start()
    barrier.wait()  # all connections up before the clock starts
    t0 = time.perf_counter()
    time.sleep(duration_s)
    stop.set()
    for c in clients:
        c.join(10)
    wall = time.perf_counter() - t0
    after = _scrape(host, port)

    latencies = sorted(x for c in clients for x in c.latencies)
    statuses: dict[str, int] = {}
    for c in clients:
        for code, n in c.statuses.items():
            statuses[str(code)] = statuses.get(str(code), 0) + n
    ok = statuses.get("200", 0)

    return {
        "threads": threads,
        "duration_s": round(wall, 3),
        "requests": len(latencies),
        "throughput_rps": round(len(latencies) / wall, 2),
        "ok_rps": round(ok / wall, 2),
        "statuses": statuses,
        "transport_errors": sum(c.errors for c in clients),
        # Requests whose injected trace id came back in X-DSST-Trace —
        # equal to `requests` against a propagation-aware server.
        "trace_propagated": sum(c.propagated for c in clients),
        "latency_s": {
            "p50": percentile(latencies, 0.50),
            "p90": percentile(latencies, 0.90),
            "p99": percentile(latencies, 0.99),
            "mean": statistics.fmean(latencies) if latencies else None,
        },
        "server": {
            "batch_fill": _hist_delta(before, after, "serving_batch_fill"),
            "time_in_queue_s": _hist_delta(
                before, after, "serving_time_in_queue_seconds"
            ),
            "rejected_429": after.get("serving_admission_rejected_total", 0.0)
            - before.get("serving_admission_rejected_total", 0.0),
            "deadline_503": after.get("serving_deadline_expired_total", 0.0)
            - before.get("serving_deadline_expired_total", 0.0),
        },
    }


# dsst: ignore[lock-discipline] cross-thread channels are the Barrier/Event; per-stream samples are written by the client thread alone and read only after join()
class _LMClient(threading.Thread):
    """One closed-loop token-stream client over ONE keep-alive
    connection: POST /generate, read the chunked ndjson token-by-token
    (TTFT = first line, inter-token = gap between lines), repeat."""

    def __init__(self, host: str, port: int, body: bytes,
                 barrier: threading.Barrier, stop: threading.Event):
        super().__init__(daemon=True)
        self.host, self.port, self.body = host, port, body
        self.barrier, self.stop = barrier, stop
        self.requests = 0
        self.tokens = 0
        self.ttfts: list[float] = []
        self.gaps: list[float] = []
        self.statuses: dict[int, int] = {}
        self.errors = 0
        self.propagated = 0

    def run(self) -> None:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=60)
        self.barrier.wait()
        while not self.stop.is_set():
            handoff = Handoff.root("request")
            t0 = time.perf_counter()
            try:
                conn.request(
                    "POST", "/generate", body=self.body,
                    headers={"Content-Type": "application/json",
                             "X-DSST-Trace": handoff.to_header()},
                )
                resp = conn.getresponse()
                status = resp.status
                echoed = resp.getheader("X-DSST-Trace")
                if status != 200:
                    resp.read()
                    self.statuses[status] = self.statuses.get(status, 0) + 1
                    continue
                # http.client decodes the chunked framing transparently;
                # readline() therefore yields exactly one ndjson record
                # per flushed server chunk — the timing boundary the
                # TTFT/inter-token samples need.
                last = None
                done = False
                for line in iter(resp.readline, b""):
                    now = time.perf_counter()
                    row = json.loads(line)
                    if "done" in row:
                        done = True
                        break
                    if last is None:
                        self.ttfts.append(now - t0)
                    else:
                        self.gaps.append(now - last)
                    last = now
                    self.tokens += 1
                resp.read()  # settle the connection for keep-alive
                if not done:
                    self.errors += 1
                    raise OSError("stream ended without a done record")
            except Exception:
                self.errors += 1
                conn.close()
                conn = http.client.HTTPConnection(
                    self.host, self.port, timeout=60
                )
                continue
            self.requests += 1
            self.statuses[status] = self.statuses.get(status, 0) + 1
            if echoed == handoff.ctx.trace_id:
                self.propagated += 1
        conn.close()


def run_lm_load(host: str, port: int, *, prompt, max_new_tokens: int,
                streams: int, duration_s: float) -> dict:
    """Closed-loop streamed-generation load: ``streams`` concurrent
    clients for ``duration_s``. The headline is tokens/sec; TTFT and
    inter-token percentiles go through THE shared quantile helper
    (``telemetry.windows.quantile``), so the offline numbers and the
    live ``ttft_p99``/``inter_token_p99`` SLO windows can only differ
    by sketch error, never by definition drift."""
    body = json.dumps({
        "tokens": list(prompt),
        "max_new_tokens": int(max_new_tokens),
    }).encode()
    barrier = threading.Barrier(streams + 1)
    stop = threading.Event()
    clients = [_LMClient(host, port, body, barrier, stop)
               for _ in range(streams)]
    for c in clients:
        c.start()
    barrier.wait()
    t0 = time.perf_counter()
    time.sleep(duration_s)
    stop.set()
    for c in clients:
        c.join(30)
    wall = time.perf_counter() - t0

    ttfts = sorted(x for c in clients for x in c.ttfts)
    gaps = sorted(x for c in clients for x in c.gaps)
    tokens = sum(c.tokens for c in clients)
    requests = sum(c.requests for c in clients)
    statuses: dict[str, int] = {}
    for c in clients:
        for code, n in c.statuses.items():
            statuses[str(code)] = statuses.get(str(code), 0) + n

    return {
        "streams": streams,
        "duration_s": round(wall, 3),
        "requests": requests,
        "tokens": tokens,
        "tokens_per_sec": round(tokens / wall, 2),
        "statuses": statuses,
        "transport_errors": sum(c.errors for c in clients),
        "trace_propagated": sum(c.propagated for c in clients),
        "ttft_s": {
            "p50": percentile(ttfts, 0.50),
            "p99": percentile(ttfts, 0.99),
            "mean": statistics.fmean(ttfts) if ttfts else None,
        },
        "inter_token_s": {
            "p50": percentile(gaps, 0.50),
            "p99": percentile(gaps, 0.99),
            "mean": statistics.fmean(gaps) if gaps else None,
        },
    }


class _StubScorer:
    """Predictor-shaped stub with a simulated per-batch score cost."""

    meta = {"model": "loadgen-stub"}
    step = 0
    crop = 8

    def __init__(self, micro_batch: int, score_ms: float):
        import numpy as np

        self._np = np
        self.micro_batch = micro_batch
        self.score_s = score_ms / 1000.0

    def decode(self, jpegs):
        return self._np.zeros((len(jpegs), 1), self._np.float32)

    def score(self, images):
        if self.score_s:
            time.sleep(self.score_s)
        return [{"pred_index": 0, "pred_prob": 1.0} for _ in images]


def spawn_stub_server(*, micro_batch: int = 8, score_ms: float = 5.0,
                      batch_window_ms: float = 5.0, queue_depth: int = 64,
                      deadline_ms: float = 0.0, access_log=None,
                      flightrec=None):
    """Spawn the stub-scorer server subprocess; returns ``(proc, port)``
    with ``/healthz`` already answering. Callers terminate ``proc``.

    ``access_log``/``flightrec`` (paths) arm the stub's structured
    request log and flight-recorder tail — what the fleet tests use to
    compare merged sketches against per-replica journaled ground truth
    and to merge per-replica recorder files into one timeline."""
    import subprocess

    argv = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.bench.loadgen",
            "--stub-serve",
            "--micro-batch", str(micro_batch),
            "--score-ms", str(score_ms),
            "--batch-window-ms", str(batch_window_ms),
            "--queue-depth", str(queue_depth),
            "--deadline-ms", str(deadline_ms)]
    if access_log is not None:
        argv += ["--access-log", str(access_log)]
    if flightrec is not None:
        argv += ["--flightrec", str(flightrec)]
    # stdin is the parent-death channel: if the spawning process is
    # SIGKILLed (a bench watchdog kill can't run teardown), the kernel
    # closes the pipe and the stub's watcher thread sees EOF — no
    # orphaned server accumulating on the host per killed child.
    proc = subprocess.Popen(
        argv,
        stdout=subprocess.PIPE, stdin=subprocess.PIPE, text=True,
    )
    try:
        boot = json.loads(proc.stdout.readline())
        port = boot["port"]
        _wait_ready("127.0.0.1", port)
    except BaseException:
        proc.terminate()
        raise
    return proc, port


def spawn_stub_lm_server(*, slots: int = 8, max_len: int = 96,
                         prefill_buckets: str = "8,16",
                         step_ms: float = 3.0, queue_depth: int = 32,
                         deadline_ms: float = 0.0,
                         inter_token_budget_ms: float = 0.0,
                         access_log=None):
    """Spawn the stub-decoder LM streaming server subprocess; returns
    ``(proc, port)`` with ``/healthz`` already answering. Same
    subprocess split and parent-death stdin channel as
    :func:`spawn_stub_server` — the stub decoder's per-STEP cost is
    independent of active slots, so this measures the ENGINE
    (admission, continuous batching, streaming, retirement)."""
    import subprocess

    argv = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.bench.loadgen",
            "--stub-serve-lm",
            "--slots", str(slots),
            "--max-len", str(max_len),
            "--prefill-buckets", str(prefill_buckets),
            "--step-ms", str(step_ms),
            "--queue-depth", str(queue_depth),
            "--deadline-ms", str(deadline_ms),
            "--inter-token-budget-ms", str(inter_token_budget_ms)]
    if access_log is not None:
        argv += ["--access-log", str(access_log)]
    proc = subprocess.Popen(
        argv,
        stdout=subprocess.PIPE, stdin=subprocess.PIPE, text=True,
    )
    try:
        boot = json.loads(proc.stdout.readline())
        port = boot["port"]
        _wait_ready("127.0.0.1", port)
    except BaseException:
        proc.terminate()
        raise
    return proc, port


def _parent_watcher(stop: threading.Event):
    """The stub's parent-death watch: EOF on stdin means the spawning parent
    is gone (it held the write end; even SIGKILL closes it). Reads the file
    descriptor itself, never ``sys.stdin``'s buffer, whose lock a daemon
    thread would still hold at interpreter shutdown."""
    def watch() -> None:
        try:
            while os.read(0, 4096):
                pass
        except OSError:
            pass
        stop.set()

    return watch


def _stub_serve_lm(args) -> int:
    """The --stub-serve-lm server half: stub decoder + real engine +
    real streaming front end; announce the port, serve until SIGTERM,
    drain on the way out."""
    import signal

    from ..serving.lm import LMConfig, LMEngine, StubLMDecoder
    from ..workloads.serving import serve_lm_in_thread

    buckets = tuple(
        int(b) for b in str(args.prefill_buckets).split(",") if b
    )
    cfg = LMConfig(
        slots=args.slots, max_len=args.max_len, prefill_buckets=buckets,
        queue_depth=args.queue_depth, deadline_ms=args.deadline_ms,
        inter_token_budget_ms=args.inter_token_budget_ms,
    )
    engine = LMEngine(
        StubLMDecoder(step_ms=args.step_ms, slots=args.slots,
                      max_len=args.max_len, buckets=buckets),
        cfg,
    ).start()
    handle = serve_lm_in_thread(engine, access_log=args.access_log or None)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())

    _watch_parent = _parent_watcher(stop)

    threading.Thread(target=_watch_parent, daemon=True,
                     name="loadgen-parent-watch").start()
    # dsst: ignore[no-print] subprocess port-announce protocol line on stdout
    print(json.dumps({"port": handle.port}), flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        handle.close()
    return 0


def _stub_serve(args) -> int:
    """The --stub-serve server half: announce the port, serve until
    SIGTERM, drain on the way out."""
    import signal

    from ..serving import SchedulerConfig
    from ..telemetry import flightrec
    from ..workloads.serving import serve_in_thread

    if args.flightrec:
        # Arm the flight-recorder tail BEFORE the server threads start,
        # so every serving span of this replica reaches the file.
        flightrec.enable(args.flightrec)
    handle = serve_in_thread(
        _StubScorer(args.micro_batch, args.score_ms),
        config=SchedulerConfig(
            queue_depth=args.queue_depth,
            batch_window_ms=args.batch_window_ms,
            deadline_ms=args.deadline_ms,
        ),
        access_log=args.access_log or None,
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())

    _watch_parent = _parent_watcher(stop)

    threading.Thread(target=_watch_parent, daemon=True,
                     name="loadgen-parent-watch").start()
    # dsst: ignore[no-print] subprocess port-announce protocol line on stdout
    print(json.dumps({"port": handle.port}), flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        handle.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    target = ap.add_mutually_exclusive_group(required=True)
    target.add_argument("--url", help="running server, e.g. http://127.0.0.1:8008")
    target.add_argument(
        "--selftest", action="store_true",
        help="subprocess stub server (scheduler smoke bench; no checkpoint)",
    )
    # Internal: the server half of --selftest (announces its port as a
    # JSON line, serves until SIGTERM).
    target.add_argument("--stub-serve", action="store_true",
                        help=argparse.SUPPRESS)
    # Internal: the LM-engine flavor (stub decoder + real continuous-
    # batching engine + chunked /generate streaming).
    target.add_argument("--stub-serve-lm", action="store_true",
                        help=argparse.SUPPRESS)
    ap.add_argument("--image", default=None,
                    help="JPEG file to POST (required with --url)")
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--micro-batch", type=int, default=8,
                    help="(selftest) compiled-batch size the stub simulates")
    ap.add_argument("--score-ms", type=float, default=5.0,
                    help="(selftest) simulated per-batch score cost")
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--access-log", default=None,
                    help="(stub-serve) structured request log path")
    ap.add_argument("--flightrec", default=None,
                    help="(stub-serve) flight-recorder tail path")
    ap.add_argument("--slots", type=int, default=8,
                    help="(stub-serve-lm) KV arena slots")
    ap.add_argument("--max-len", type=int, default=96,
                    help="(stub-serve-lm) per-slot KV capacity")
    ap.add_argument("--prefill-buckets", default="8,16",
                    help="(stub-serve-lm) comma-separated bucket lengths")
    ap.add_argument("--step-ms", type=float, default=3.0,
                    help="(stub-serve-lm) simulated per-STEP decode cost")
    ap.add_argument("--inter-token-budget-ms", type=float, default=0.0,
                    help="(stub-serve-lm) arms the inter_token_p99 SLO")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    args = ap.parse_args(argv)

    if args.stub_serve:
        return _stub_serve(args)
    if args.stub_serve_lm:
        return _stub_serve_lm(args)

    proc = None
    if args.selftest:
        proc, port = spawn_stub_server(
            micro_batch=args.micro_batch, score_ms=args.score_ms,
            batch_window_ms=args.batch_window_ms,
            queue_depth=args.queue_depth, deadline_ms=args.deadline_ms,
        )
        host, body = "127.0.0.1", b"0"
    else:
        if not args.image:
            ap.error("--url needs --image (a real JPEG the server can decode)")
        url = args.url.removeprefix("http://")
        host, _, port_s = url.partition(":")
        port = int(port_s.rstrip("/") or 8008)
        body = Path(args.image).read_bytes()

    try:
        _wait_ready(host, port)
        report = {
            "bench": "serve_loadgen",
            "mode": "selftest" if args.selftest else "url",
            # Tail latencies are host-sensitive: on a small shared box
            # the p99 reflects scheduler noise, not the serving stack.
            "host_cpus": os.cpu_count(),
            "config": {
                "micro_batch": args.micro_batch if args.selftest else None,
                "score_ms": args.score_ms if args.selftest else None,
                "batch_window_ms": args.batch_window_ms,
                "queue_depth": args.queue_depth,
                "deadline_ms": args.deadline_ms,
            },
            **run_load(host, port, body, threads=args.threads,
                       duration_s=args.duration),
        }
    finally:
        if proc is not None:
            proc.terminate()
            proc.wait(15)

    text = json.dumps(report, indent=1)
    # dsst: ignore[no-print] the loadgen CLI's report contract: one JSON document on stdout
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
