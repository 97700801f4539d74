"""Command line of the port: ``python -m dss_ml_at_scale_tpu_torch.config.cli``.

Ports of the JAX package's commands (``config/commands.py``):

- ``serve-lm``: the same flags, plus ``--device``.
- ``datagen images``: the synthetic JPEG-grating Delta table.
- ``train``: data-parallel image-classifier training from a Delta table,
  with the JAX command's flags that the port supports (names and
  defaults kept), plus ``--device``: ``--coordinator`` (one process per
  card, each reading its own shard), ``--shard-opt-state`` (ZeRO-1),
  ``--lr-schedule``/``--warmup-steps``, on-device ``--augment``,
  ``--pretrained`` torchvision-layout weights, the native decoder and
  ``--fast-decode``, ``--profile-dir``, checkpoints, ``--resume`` and
  ``--resume-auto``, the health supervisor (``--health-policy`` and its
  knobs); the model, its crop and padding and the learning-rate
  trajectory persist as ``dsst_model.json`` beside the checkpoints, for a
  flag-less ``--resume`` and for the inference commands. ``--model``
  takes the ResNets and the ViTs (``vit-t16``, ``vit-s16``, the CI-sized
  ``vit-tiny``; ``--pretrained`` reads a torchvision ``VisionTransformer``
  layout for them).
- ``predict``, ``export`` and ``serve``: the inference commands over a
  ``train`` checkpoint directory, with the JAX commands' flags plus
  ``--device``. ``predict`` writes one prediction row per table row to a
  Delta table, ``export`` a torchvision-layout ``.npz``, and ``serve``
  answers ``POST /predict`` through the serving scheduler (admission,
  decode pool, cross-request batcher); a boot JSON line first, and SIGINT
  drains. They score at the level ``dsst_model.json`` resolves to: a
  ``--pallas-fused`` checkpoint at the fused level, without the
  fused-matmul kernels, as the JAX package scores it.
- ``lm``: TransformerLM training on the seeded Markov token stream, with
  the JAX command's flags and defaults, plus ``--device``: flash or
  reference attention, a constant or cosine learning rate (the trajectory
  persisted as ``dsst_lm.json`` beside the checkpoints, for a flag-less
  ``--resume``), checkpoints, resume and ``--resume-auto``, the health
  supervisor, ``--sample`` scoring and ``--coordinator`` (each process
  draws its own trajectory of the chain). ``--ffn moe`` (with
  ``--num-experts``, ``--aux-loss-weight``) swaps every block's MLP for the
  top-1 MoE layer, its aux loss in the objective; across ranks it routes
  the global batch, and computes each rank's share of the experts when
  the number of processes divides ``--num-experts``.
- ``datagen demand`` and ``forecast``: the group-fit track. The weekly
  ARMA demand panel as a Delta table, then every SKU's SARIMAX tuned over
  the full (p, d, q) grid (or by the reference's per-SKU TPE, ``--search
  tpe --max-evals --rstate``), fitted and forecast on the card, with the
  JAX command's flags and defaults plus ``--device``. ``--no-mesh`` is
  accepted (one process drives one card); ``--max-evals`` and
  ``--rstate`` are accepted and ignored under grid, as in JAX.
- ``eda``: single-SKU model selection (four Holt-Winters variants, SARIMAX
  with and without exog, a TPE search of the order in ``--parallelism``
  concurrent trials), with the JAX command's flags and defaults plus
  ``--device``; ``--polish`` refines the ranked fits in float64 on the
  host, ``--plot`` writes the comparison figure (needs matplotlib).
- ``datagen bom``: the random bill-of-materials DAG of the demand table's
  SKUs, as the bom and sku_mapper Delta tables.
- ``pipeline``: a JSON task DAG of this CLI's commands, each task a
  process of its own (:mod:`.pipeline`), with ``--task-device`` for the
  JAX runner's ``--task-platform``.
- ``datagen photos`` and ``ingest``: the front of Track A. Real-photograph
  JPEG crops (the two sample photographs kept in the package) as an
  ImageNet-style tree, and a tree turned into a Delta table with stable
  ids, labels and ``labels.json``, with the JAX commands' flags. Host work.
- ``datagen regression``, ``hpo`` and ``trial-worker``: the distributed HPO
  track. A byte-sized regression as an ``.npz``; the Lasso TPE sweep in
  its three regimes (closure, ``--data`` shared filesystem, ``--workers``
  over the RPC control plane), with ``--resume-auto`` from the run
  journal; a worker process that serves trials, printing its address.
  ``hpo`` adds ``--device``: local trials are pinned to the card (every
  card of the host for a bare ``cuda``), as JAX pins them to its local
  devices; the objective itself is host numpy.
- ``checkpoints verify DIR``, ``quarantine list|clear`` and ``runs
  list|show|doctor [--resume]``: the operator's face of the checkpoint
  manifests, the poison-row blocklist and the run store. They touch no
  device.

``train``, ``lm``, ``forecast``, ``eda``, ``hpo`` and ``serve-lm`` journal every run in a run store
(:mod:`..tracking`), on by default under ``./dsst_runs`` (or
``DSST_TRACKING_ROOT``; ``--no-tracking`` opts out); a command that
raises closes its run as FAILED. The global ``--fault-plan`` (or
``DSST_FAULT_PLAN``) arms deterministic fault injection
(:mod:`..resilience.faults`).

``--device`` defaults to ``cuda``; a missing card is an error, never a
silent CPU run. With ``--coordinator`` (or ``COORDINATOR_ADDRESS``) the
command joins a process group of ``NUM_PROCESSES`` processes as
``PROCESS_ID``; a bare ``--device cuda`` then means the card
``PROCESS_ID % cards``, and ``--batch-size`` is per process, as in JAX,
where one process drives every chip of its host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

DEFAULT_TRACKING_ROOT = "dsst_runs"


def build_parser() -> argparse.ArgumentParser:
    from ..resilience.faults import KNOWN_SITES

    parser = argparse.ArgumentParser(
        prog="dss_ml_at_scale_tpu_torch",
        description="PyTorch/CUDA port of dss_ml_at_scale_tpu",
    )
    parser.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="arm deterministic fault injection for this invocation, e.g. "
        "'grads.nonfinite=1@5;reader.next=p0.1;seed=7' "
        f"(sites: {', '.join(sorted(KNOWN_SITES))}; N = fail the first N "
        "hits, N@K = skip K hits then fail N, pX = seeded per-hit "
        "probability, kN/kN@K = SIGKILL the process at the hit; suffix "
        ".<kind> scopes an fs.* site to one publish family, e.g. "
        "fs.crash_after_tmp.manifest=k1). Default: env DSST_FAULT_PLAN; "
        "fault testing only")
    sub = parser.add_subparsers(dest="command", required=True)
    sv = sub.add_parser(
        "serve-lm",
        help="HTTP token-streaming LM server: continuous-batching decode "
        "over preallocated KV slots; POST /generate streams one chunked "
        "NDJSON line per token (plus a terminal done-line carrying the "
        "trace id)",
    )
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8008)
    sv.add_argument(
        "--slots", type=int, default=8,
        help="preallocated KV slots — the max generations decoding "
        "concurrently in one slot_decode step",
    )
    sv.add_argument(
        "--max-len", type=int, default=256,
        help="per-slot KV capacity; prompt + max_new_tokens beyond it "
        "is rejected with 400 before admission",
    )
    sv.add_argument(
        "--prefill-buckets", default="16,32,64", metavar="CSV",
        help="padded prompt lengths; a prompt is padded up to the "
        "smallest bucket that fits",
    )
    sv.add_argument(
        "--queue-depth", type=int, default=32,
        help="max admitted-but-unsettled generations; beyond it "
        "requests get 429 with a measured Retry-After",
    )
    sv.add_argument(
        "--deadline-ms", type=float, default=0.0,
        help="per-generation deadline (0 disables); also arms the "
        "ttft_p99 SLO budget",
    )
    sv.add_argument(
        "--inter-token-budget-ms", type=float, default=0.0,
        help="arms the inter_token_p99 SLO budget (0 leaves it "
        "informational)",
    )
    sv.add_argument(
        "--drain-timeout", type=float, default=10.0,
        help="graceful-shutdown bound: seconds for in-flight streams "
        "to finish after Ctrl-C before the server closes anyway",
    )
    sv.add_argument(
        "--stub", action="store_true",
        help="serve the deterministic stub decoder instead of a "
        "TransformerLM (no device work)",
    )
    sv.add_argument(
        "--step-ms", type=float, default=2.0,
        help="stub-only: simulated wall time of one decode step",
    )
    sv.add_argument("--vocab", type=int, default=256,
                    help="model/stub vocabulary size")
    sv.add_argument("--dim", type=int, default=128)
    sv.add_argument("--heads", type=int, default=4)
    sv.add_argument("--layers", type=int, default=2)
    sv.add_argument("--attention", choices=["flash", "reference"],
                    default="reference")
    sv.add_argument("--seed", type=int, default=0,
                    help="init seed of the random-weight TransformerLM "
                    "(there is no LM checkpoint format yet)")
    sv.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cuda:N, or cpu)")
    sv.add_argument(
        "--access-log", default=None, metavar="JSONL",
        help="structured request log: one JSON line per /generate",
    )
    _add_tracking_args(sv, "serve-lm")
    sv.set_defaults(fn=_cmd_serve_lm)
    _register_datagen(sub)
    _register_forecast(sub)
    _register_eda(sub)
    _register_train(sub)
    _register_inference(sub)
    _register_lm(sub)
    _register_checkpoints(sub)
    _register_quarantine(sub)
    _register_runs(sub)
    _register_ingest(sub)
    _register_hpo(sub)
    from .pipeline import register_pipeline

    register_pipeline(sub)
    return parser


def _no_card(device: str) -> bool:
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": f"--device {device}: no CUDA device is "
                          "available (pass --device cpu to run on the CPU)"}),
              flush=True)
        return True
    return False


def _register_datagen(sub) -> None:
    gen = sub.add_parser("datagen", help="synthetic data generators")
    gsub = gen.add_subparsers(dest="generator", required=True)
    img = gsub.add_parser(
        "images",
        help="labeled JPEG gratings -> Delta (quick-start training data; "
        "each class a distinct orientation/frequency)",
    )
    img.add_argument("--out", required=True, help="Delta table path")
    img.add_argument("--n", type=int, default=1024)
    img.add_argument("--classes", type=int, default=10)
    img.add_argument("--size", type=int, default=64)
    img.add_argument("--seed", type=int, default=0)
    img.add_argument(
        "--label-noise", type=float, default=0.0,
        help="fraction of stored labels replaced by uniform draws; caps "
        "best achievable accuracy at exactly (1-p)+p/classes",
    )
    img.set_defaults(fn=_cmd_datagen_images)

    demand = gsub.add_parser("demand", help="ARMA weekly demand panel -> Delta")
    demand.add_argument("--out", required=True, help="Delta table path")
    demand.add_argument("--skus-per-product", type=int, default=10)
    demand.add_argument("--years", type=int, default=3)
    demand.add_argument("--seed", type=int, default=123)
    demand.add_argument("--device", default="cuda",
                        help="the card of the pipeline (cuda, cuda:N, or cpu); the "
                        "generator itself runs on the host")
    demand.set_defaults(fn=_cmd_datagen_demand)

    bom = gsub.add_parser("bom", help="random 3-level BoM DAG per SKU -> Delta")
    bom.add_argument("--demand", required=True, help="demand Delta table to take SKUs from")
    bom.add_argument("--out", required=True, help="bom Delta table path")
    bom.add_argument("--mapper-out", required=True, help="sku_mapper Delta path")
    bom.add_argument("--depth", type=int, default=3)
    bom.add_argument("--seed", type=int, default=123)
    bom.set_defaults(fn=_cmd_datagen_bom)

    reg = gsub.add_parser("regression", help="byte-targeted synthetic regression -> npz")
    reg.add_argument("--bytes", type=float, required=True, dest="n_bytes")
    reg.add_argument("--out", required=True, help="output .npz path")
    reg.set_defaults(fn=_cmd_datagen_regression)

    ph = gsub.add_parser(
        "photos",
        help="real-photograph JPEG crops (two CC-BY sample photos kept in the package) "
        "as an ImageNet-style file tree for ingest")
    ph.add_argument("--out", required=True, help="tree root (files go in Data/)")
    ph.add_argument("--n", type=int, default=192)
    ph.add_argument("--size", type=int, default=96)
    ph.add_argument("--seed", type=int, default=0)
    ph.set_defaults(fn=_cmd_datagen_photos)


def _cmd_datagen_regression(args: argparse.Namespace) -> int:
    from ..datagen.regression import gen_data
    from ..hpo.shipping import save_shared

    X_train, X_test, y_train, y_test = gen_data(int(args.n_bytes))
    path = save_shared(args.out, X_train=X_train, X_test=X_test, y_train=y_train,
                       y_test=y_test)
    print(f"regression: {len(X_train)}+{len(X_test)} samples -> {path}")
    return 0


def _cmd_datagen_photos(args: argparse.Namespace) -> int:
    from ..datagen.photos import CLASSES, write_photo_tree

    n = write_photo_tree(args.out, args.n, size=args.size, seed=args.seed)
    print(f"photos: {n} real-photo JPEG crops, {len(CLASSES)} classes, {args.size}px "
          f"-> {args.out}")
    return 0


def _register_ingest(sub) -> None:
    ing = sub.add_parser("ingest", help="image dataset directory -> Delta table with stable ids")
    ing.add_argument("--data-root", required=True)
    ing.add_argument("--out", required=True, help="Delta table path")
    ing.add_argument("--pattern", default="*.JPEG")
    ing.add_argument("--label-from", choices=["path", "annotation"], default="path")
    ing.add_argument("--rows-per-fragment", type=int, default=1024)
    ing.add_argument("--append", action="store_true")
    ing.add_argument(
        "--allow-unlabeled", action="store_true",
        help="ingest rows with no determinable label as label_index=-1 instead of failing "
        "(filter them before training)")
    ing.set_defaults(fn=_cmd_ingest)


def _cmd_ingest(args: argparse.Namespace) -> int:
    from ..ingest import ingest_image_dataset

    table = ingest_image_dataset(
        args.data_root, args.out, file_pattern=args.pattern, label_from=args.label_from,
        rows_per_fragment=args.rows_per_fragment,
        mode="append" if args.append else "overwrite",
        on_missing_label="keep" if args.allow_unlabeled else "error")
    print(f"ingested {table.num_records()} rows -> {args.out}")
    return 0


def _register_hpo(sub) -> None:
    hp_ = sub.add_parser("hpo", help="distributed TPE sweep over a Lasso objective "
                         "(the data-size playbook)")
    hp_.add_argument("--data", default=None,
                     help=".npz from `datagen regression` (shared-FS shipping); omit to "
                     "generate in-process (closure shipping)")
    hp_.add_argument("--bytes", type=float, default=1e6, dest="n_bytes")
    hp_.add_argument("--parallelism", type=int, default=2)
    hp_.add_argument("--max-evals", type=int, default=4)
    hp_.add_argument("--workers", default=None,
                     help="comma-separated trial-worker host:port addresses; runs the sweep "
                     "over the RPC control plane (requires --data on a path every worker "
                     "can read)")
    hp_.add_argument("--secret-file", default=None,
                     help="file holding the shared RPC secret (or env DSST_RPC_SECRET); "
                     "enables the HMAC handshake with the workers")
    hp_.add_argument("--max-retries", type=int, default=2,
                     help="(--workers mode) transport-failure requeues per trial before it "
                     "fails; objective exceptions are never retried")
    hp_.add_argument("--resume-auto", action="store_true",
                     help="continue a killed sweep: mark this experiment's dead RUNNING runs "
                     "INTERRUPTED, reload the completed trials from the interrupted runs' "
                     "journals, and run only the remaining evals (requires tracking)")
    hp_.add_argument("--device", default="cuda",
                     help="the card the local trials are pinned to (cuda: every card of the "
                     "host; cuda:N; or cpu)")
    _add_tracking_args(hp_, "hpo")
    hp_.set_defaults(fn=_cmd_hpo)

    tw = sub.add_parser("trial-worker",
                        help="serve HPO trial evaluations for a remote sweep (one per host)")
    tw.add_argument("--bind", default="127.0.0.1:0",
                    help="host:port to listen on (port 0 = OS-assigned, printed)")
    tw.add_argument("--secret-file", default=None,
                    help="file holding the shared RPC secret (or env DSST_RPC_SECRET); "
                    "required for non-loopback binds unless --insecure")
    tw.add_argument("--insecure", action="store_true",
                    help="allow a non-loopback bind without a secret (trusted isolated network "
                    "only; the RPC wire executes pickle on receipt)")
    tw.set_defaults(fn=_cmd_trial_worker)


def _rpc_secret(args: argparse.Namespace) -> bytes | None:
    """The shared RPC secret from --secret-file, or env DSST_RPC_SECRET."""
    path = getattr(args, "secret_file", None)
    if path:
        secret = Path(path).read_bytes().strip()
        if not secret:
            raise SystemExit(f"--secret-file {path} is empty")
        return secret
    env = os.environ.get("DSST_RPC_SECRET")
    return env.encode() if env else None


def _cmd_trial_worker(args: argparse.Namespace) -> int:
    from ..parallel.trials import serve_trial_worker

    # The address goes to stdout at once (flushed): serve_forever never
    # returns, and a pipe would hold a buffered line.
    serve_trial_worker(args.bind, block=True, secret=_rpc_secret(args),
                       allow_insecure=args.insecure, announce=lambda m: print(m, flush=True))
    return 0


def _journaled_trials(root: str, experiment: str) -> list[dict]:
    """The completed trials of ``experiment``'s interrupted runs, rebuilt
    from their journals into the fmin store's format: the resume state of
    ``hpo --resume-auto``.

    Merged across every interrupted run, newest first per tid (a sweep
    killed twice has its early trials in one run and later ones in
    another). Only the contiguous tid prefix is kept: the async pool may
    have journaled tid 3 while tid 2 died with the process, and the sweep
    proposes anew from ``len(trials)``.
    """
    from ..tracking import read_journal, sweep_interrupted

    if not Path(root).is_dir():
        return []
    candidates = sorted((c for c in sweep_interrupted(root, experiment)
                         if c["effective_status"] == "INTERRUPTED"),
                        key=lambda c: c.get("start_time") or 0.0, reverse=True)
    by_tid: dict[int, dict] = {}
    sources: list[str] = []
    for c in candidates:
        contributed = False
        for e in read_journal(c["run_dir"]):
            if e.get("event") != "trial" or int(e["tid"]) in by_tid:
                continue
            contributed = True
            by_tid[int(e["tid"])] = {
                "tid": int(e["tid"]), "point": dict(e.get("point") or {}),
                "result": {"loss": e.get("loss"), "status": e.get("status")},
                "book_time": e.get("time"), "duration": 0.0}
        if contributed:
            sources.append(f"{c['experiment']}/{c['run_id']}")
    trials = []
    for tid in range(len(by_tid)):
        if tid not in by_tid:
            break
        trials.append(by_tid[tid])
    if trials:
        print(f"hpo --resume-auto: continuing from {len(trials)} journaled trial(s) of "
              f"{', '.join(sources)}")
    return trials


def _trial_devices(device: str, parallelism: int):
    """The devices local trials are pinned to: every card of the host for a
    bare ``cuda`` (JAX's ``jax.local_devices()``), the one card named, or the
    CPU once per concurrent trial."""
    import torch

    from ..parallel.trials import local_devices

    d = torch.device(device)
    if d.type == "cpu":
        return [d] * max(1, parallelism)
    return local_devices() if d.index is None else [d]


def _cmd_hpo(args: argparse.Namespace) -> int:
    from ..datagen.regression import gen_data, train_and_eval, tune_alpha
    from ..hpo.shipping import load_shared

    resumed: list[dict] = []
    if args.resume_auto:
        if args.no_tracking or not args.tracking_root:
            print("--resume-auto needs tracking enabled (the run journal IS the resume state)")
            return 2
        resumed = _journaled_trials(args.tracking_root, args.experiment)

    if args.workers:
        # Remote: the objective ships by module reference, the data by a
        # shared filesystem. Checked before a tracker opens, so a usage
        # error leaves no RUNNING run behind.
        if not args.data:
            print("--workers requires --data (shared-FS npz every worker can read)")
            return 2
        tracker = _open_tracker(args, "hpo")
        import numpy as np

        from ..hpo import fmin, hp
        from ..parallel.trials import HostTrials

        space = {"alpha": hp.uniform("alpha", 0.0, 10.0),
                 "data_path": hp.choice("data_path", [str(args.data)])}
        trials = HostTrials(args.workers.split(","), parallelism=args.parallelism,
                            secret=_rpc_secret(args), max_retries=args.max_retries)
        trials.trials.extend(resumed)
        best = fmin("dss_ml_at_scale_tpu_torch.hpo.objectives:lasso_shared", space,
                    max_evals=args.max_evals, trials=trials, rstate=np.random.default_rng(0),
                    tracker=tracker)
        ok = sum(1 for t in trials.trials if t["result"]["status"] == "ok")
        if tracker is not None:
            tracker.log_params({"mode": "remote", "workers": args.workers})
        _finish_tracker(tracker)
        print(f"hpo (remote, {len(trials.workers)} workers): best alpha {best['alpha']:.4f} "
              f"({ok}/{len(trials.trials)} trials ok)")
        return 0

    if _no_card(args.device):
        return 1
    devices = _trial_devices(args.device, args.parallelism)
    tracker = _open_tracker(args, "hpo")
    if args.data:
        arrays = load_shared(args.data)
        data = (arrays["X_train"], arrays["X_test"], arrays["y_train"], arrays["y_test"])
        mode = "shared-fs"
    else:
        data = gen_data(int(args.n_bytes))
        mode = "closure"

    def objective(alpha):
        return train_and_eval(data, alpha)

    trials = None
    if resumed:
        from ..parallel.trials import DeviceTrials

        trials = DeviceTrials(parallelism=args.parallelism, devices=devices)
        trials.trials.extend(resumed)
    best = tune_alpha(objective, parallelism=args.parallelism, max_evals=args.max_evals,
                      tracker=tracker, trials=trials, devices=devices)
    if tracker is not None:
        tracker.log_params({"mode": mode, "best_alpha": best})
    _finish_tracker(tracker)
    print(f"hpo ({mode}): best alpha {best:.4f}")
    return 0


def _cmd_datagen_demand(args: argparse.Namespace) -> int:
    from ..datagen.demand import DemandConfig, generate_demand, write_demand_delta

    if _no_card(args.device):
        return 1
    cfg = DemandConfig(n_skus_per_product=args.skus_per_product,
                       ts_length_years=args.years, seed=args.seed)
    table = generate_demand(cfg)
    write_demand_delta(table, args.out)
    skus = len(table.column("SKU").unique())
    weeks = len(table.column("Date").unique())
    print(f"demand: {skus} SKUs × {weeks} weeks = {table.num_rows} rows -> {args.out}")
    return 0


def _read_table(path):
    """A Delta table's latest snapshot as one pyarrow Table."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ..data.delta import DeltaTable

    return pa.concat_tables(pq.read_table(u) for u in DeltaTable(path).file_uris())


def _cmd_datagen_bom(args: argparse.Namespace) -> int:
    from ..datagen.bom import generate_bom, write_bom_delta

    skus = sorted(set(_read_table(args.demand).column("SKU").to_pylist()))
    tables = generate_bom(skus, depth=args.depth, seed=args.seed)
    write_bom_delta(tables, args.out, args.mapper_out)
    print(f"bom: {tables.bom.num_rows} edges, {tables.sku_mapper.num_rows} sku mappings "
          f"-> {args.out}, {args.mapper_out}")
    return 0


def _register_forecast(sub) -> None:
    fc = sub.add_parser(
        "forecast", help="per-SKU SARIMAX tune + fit + score over a demand table")
    fc.add_argument("--data", required=True, help="demand Delta table")
    fc.add_argument("--out", required=True, help="forecast Delta table to write")
    fc.add_argument(
        "--search", choices=("grid", "tpe"), default="grid",
        help="grid: fit the full (p,d,q) order grid in chunks with the argmin "
        "on the card (exact optimum); tpe: the reference's per-SKU TPE, one "
        "batched fit of every SKU per round")
    fc.add_argument("--chunk-size", type=int, default=None,
                    help="groups per grid-fused chunk (default: min(G, 1024))")
    fc.add_argument("--max-evals", type=int, default=10,
                    help="TPE rounds (--search tpe only)")
    fc.add_argument("--horizon", type=int, default=40, help="holdout weeks")
    fc.add_argument("--rstate", type=int, default=123,
                    help="TPE seed of every SKU's search (--search tpe only)")
    fc.add_argument("--no-mesh", action="store_true",
                    help="accepted for the JAX command's sake: one process drives one card")
    _add_tracking_args(fc, "forecasting")
    fc.add_argument("--max-p", type=int, default=4, help="AR order bound")
    fc.add_argument("--max-d", type=int, default=2, help="differencing bound")
    fc.add_argument("--max-q", type=int, default=4, help="MA order bound")
    fc.add_argument("--max-iter", type=int, default=200, help="Nelder-Mead iters")
    fc.add_argument("--device", default="cuda",
                    help="torch device of the fits (cuda, cuda:N, or cpu)")
    fc.set_defaults(fn=_cmd_forecast)


def run_forecast(args: argparse.Namespace) -> dict:
    """What ``forecast`` does, returning its summary."""
    import time

    import numpy as np
    import torch

    from ..data.delta import write_delta
    from ..ops.sarimax import SarimaxConfig
    from ..workloads.forecasting import EXO_FIELDS, add_exo_variables, tune_and_forecast_panel

    t0 = time.perf_counter()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracker = _open_tracker(args, "forecast")
    try:
        table = _read_table(args.data)
        cfg = SarimaxConfig(max_p=args.max_p, max_d=args.max_d, max_q=args.max_q,
                            k_exog=len(EXO_FIELDS), max_iter=args.max_iter)
        stats: dict = {}
        out = tune_and_forecast_panel(add_exo_variables(table), max_evals=args.max_evals,
                                      forecast_horizon=args.horizon, rstate=args.rstate,
                                      cfg=cfg, search=args.search,
                                      chunk_size=args.chunk_size, device=device, stats=stats)
        write_delta(out, args.out, mode="overwrite")
    except BaseException:
        fail_active_tracker()
        raise
    wall = time.perf_counter() - t0
    err = (out.column("Demand").to_numpy().astype(np.float64)
           - out.column("Demand_Fitted").to_numpy().astype(np.float64))
    summary = {
        "groups": stats["groups_fitted"], "rows": out.num_rows,
        "mse": float((err ** 2).mean()), "wall_s": wall, "search": args.search,
        "device": str(device),
    }
    if args.search == "grid":
        summary.update(grid_chunks=stats["grid_chunks"], nm_iterations=stats["nm_iterations"])
    else:
        summary.update(tpe_rounds=stats["tpe_rounds"], round_seconds=stats["round_seconds"])
    if device.type == "cuda":
        summary["peak_mem_bytes"] = torch.cuda.max_memory_allocated(device)
    if tracker is not None:
        tracker.log_params({"search": args.search, "max_evals": args.max_evals,
                            "horizon": args.horizon, "groups": summary["groups"]})
        tracker.log_metrics({k: v for k, v in summary.items()
                             if isinstance(v, (int, float)) and not isinstance(v, bool)},
                            step=0)
        for i, sec in enumerate(summary.get("round_seconds", ())):
            tracker.log_metrics({"tpe_round_s": sec}, step=i)
    _finish_tracker(tracker)
    return summary


def _cmd_forecast(args: argparse.Namespace) -> int:
    if _no_card(args.device):
        return 1
    s = run_forecast(args)
    print(f"forecast: {s['groups']} groups, {s['rows']} rows, mse {s['mse']:.2f}, "
          f"{s['wall_s']:.1f}s -> {args.out}", flush=True)
    return 0


def _register_eda(sub) -> None:
    eda = sub.add_parser(
        "eda", help="single-SKU model comparison: Holt-Winters vs SARIMAX vs tuned")
    eda.add_argument("--data", required=True, help="demand Delta table")
    eda.add_argument("--product", default=None)
    eda.add_argument("--sku", default=None, help="defaults to the first SKU")
    eda.add_argument("--horizon", type=int, default=40)
    eda.add_argument("--seasonal-periods", type=int, default=52)
    eda.add_argument("--max-evals", type=int, default=10)
    eda.add_argument("--parallelism", type=int, default=10)
    eda.add_argument("--max-iter", type=int, default=200)
    eda.add_argument(
        "--polish", action="store_true",
        help="refine the single-SKU SARIMAX fits with the host-side float64 polish "
        "(closes the f32 unit-root corner)")
    eda.add_argument(
        "--plot", default=None, metavar="PATH",
        help="write the reference-style comparison figure (actual series + top "
        "models' holdout predictions) to this PNG (needs matplotlib)")
    _add_tracking_args(eda, "eda")
    eda.add_argument("--device", default="cuda",
                     help="torch device of the fits (cuda, cuda:N, or cpu)")
    eda.set_defaults(fn=_cmd_eda)


def _cmd_eda(args: argparse.Namespace) -> int:
    import time

    import torch

    from ..ops.sarimax import SarimaxConfig
    from ..workloads.eda import run_eda
    from ..workloads.forecasting import EXO_FIELDS

    if _no_card(args.device):
        return 1
    t0 = time.perf_counter()
    table = _read_table(args.data)
    tracker = _open_tracker(args, "eda")
    report = run_eda(
        table, product=args.product, sku=args.sku, horizon=args.horizon,
        seasonal_periods=args.seasonal_periods, max_evals=args.max_evals,
        parallelism=args.parallelism,
        cfg=SarimaxConfig(k_exog=len(EXO_FIELDS), max_iter=args.max_iter),
        polish=args.polish, return_curves=args.plot is not None, tracker=tracker,
        device=torch.device(args.device))
    print(f"EDA for Product={report.product} SKU={report.sku} "
          f"(holdout {args.horizon} weeks)")
    print(report.to_string())
    print(f"best SARIMAX order: {report.best_order} (mse {report.best_order_mse:.2f})")
    if tracker is not None:
        tracker.log_params({"product": report.product, "sku": report.sku,
                            "max_evals": args.max_evals, "horizon": args.horizon})
        tracker.log_metrics({"best_order_mse": report.best_order_mse}, step=args.max_evals)
    _finish_tracker(tracker)
    if args.plot:
        report.plot(args.plot)
        print(f"comparison figure -> {args.plot}")
    print(json.dumps({"eda_seconds": time.perf_counter() - t0, **report.seconds}), flush=True)
    return 0


def _cmd_datagen_images(args: argparse.Namespace) -> int:
    from ..datagen.images import write_image_delta

    labels = write_image_delta(
        args.out, args.n, classes=args.classes, size=args.size,
        seed=args.seed, label_noise=args.label_noise, mode="overwrite",
    )
    noise = f", label noise {args.label_noise}" if args.label_noise else ""
    print(f"images: {len(labels)} JPEGs, {args.classes} classes, "
          f"{args.size}px{noise} -> {args.out}")
    return 0


def _register_train(sub) -> None:
    from .checkpoints import CLASSIFIERS

    tr = sub.add_parser(
        "train", help="data-parallel image-classifier training from a Delta table")
    tr.add_argument("--data", required=True, help="train Delta table (content/label_index)")
    tr.add_argument("--val-data", default=None, help="validation Delta table")
    tr.add_argument("--epochs", type=int, default=2)
    tr.add_argument("--batch-size", type=int, default=212,
                    help="rows per step of each process (the global batch is this "
                    "times the number of processes)")
    tr.add_argument("--learning-rate", type=float, default=1e-5)
    _add_lr_schedule_args(tr)
    tr.add_argument("--num-classes", type=int, default=1000)
    tr.add_argument("--crop", type=int, default=224)
    tr.add_argument("--model", choices=list(CLASSIFIERS), default="resnet50")
    tr.add_argument(
        "--pretrained", default=None, metavar="PATH",
        help="torchvision-layout state dict (.pt/.pth/.npz) to fine-tune "
        "from instead of cold-starting (reference 2...py:150); builds the "
        "model with torch_padding=True for numerical parity; a head whose "
        "class count differs from --num-classes is freshly initialized",
    )
    tr.add_argument(
        "--torch-padding", action=argparse.BooleanOptionalAction, default=None,
        help="force torchvision-style symmetric stride-2 padding (or "
        "--no-torch-padding to force it off); default: True with "
        "--pretrained, else the value persisted in the checkpoint dir, else "
        "False (XLA SAME padding, as in the JAX package)",
    )
    tr.add_argument(
        "--fused-bn", action=argparse.BooleanOptionalAction, default=True,
        help="fused BN+relu(+residual) with a minimal-residual backward "
        "(ops/fused_norm.py); --no-fused-bn gives flax BatchNorm semantics",
    )
    tr.add_argument(
        "--pallas-fused", action="store_true",
        help="on top of --fused-bn (bottleneck models only): the middle BN's "
        "apply fused into the 1x1 conv by the hand-written kernels of "
        "ops/fused_matmul.py; the normalized activation never reaches "
        "device memory",
    )
    tr.add_argument("--eval-topk", type=int, nargs="*", default=[],
                    help="extra top-k val accuracies (e.g. --eval-topk 5)")
    tr.add_argument(
        "--augment", action="store_true",
        help="on-device train-time RandomResizedCrop + horizontal flip "
        "inside the train step (data/augment.py), keyed by the training "
        "step, so resume replays the identical crop schedule; eval never "
        "augments",
    )
    tr.add_argument("--workers", type=int, default=2)
    tr.add_argument("--queue-size", type=int, default=20)
    tr.add_argument("--feeder-depth", type=int, default=2,
                    help="bound of the feeder's on-device batch queue")
    tr.add_argument(
        "--shard-opt-state", action="store_true",
        help="ZeRO-1: shard Adam's state over the processes instead of "
        "replicating it (same math, ~world-size less optimizer memory)",
    )
    tr.add_argument(
        "--image-dtype", choices=["float32", "uint8"], default="float32",
        help="uint8 ships raw bytes to the device and normalizes inside the "
        "step; float32 normalizes on the host",
    )
    tr.add_argument(
        "--decode-backend", choices=["auto", "native", "pil"], default="auto",
        help="JPEG decode path: the C++ pool, pure-PIL, or auto (native "
        "when it compiles, per-image PIL fallback); the resolved backend "
        "is reported in the run summary",
    )
    tr.add_argument(
        "--fast-decode", action="store_true",
        help="DCT-domain scaled decode for large sources (PIL draft-mode "
        "equivalent; native backend only): pixel values slightly off "
        "full-decode parity",
    )
    tr.add_argument("--on-decode-error", choices=["raise", "substitute"], default="raise")
    tr.add_argument("--shuffle", action=argparse.BooleanOptionalAction, default=True,
                    help="shuffle row groups per epoch (seeded)")
    tr.add_argument("--limit-val-batches", type=int, default=5)
    _add_checkpoint_args(tr)
    _add_health_args(tr)
    _add_tracking_args(tr, "imagenet")
    tr.add_argument("--profile-dir", default=None,
                    help="torch.profiler Chrome trace of a window of steps, one file "
                    "per process")
    tr.add_argument("--profile-start-step", type=int, default=5,
                    help="first step of the --profile-dir window (the JAX trainer's 5)")
    tr.add_argument("--profile-num-steps", type=int, default=5,
                    help="steps in the --profile-dir window")
    _add_coordinator_arg(tr)
    tr.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cuda:N, or cpu)")
    tr.set_defaults(fn=_cmd_train)


def _add_coordinator_arg(parser) -> None:
    parser.add_argument(
        "--coordinator", default=None,
        help="host:port for multi-process rendezvous (process 0); with "
        "NUM_PROCESSES and PROCESS_ID from the environment, one process per card")


def _add_lr_schedule_args(parser) -> None:
    parser.add_argument(
        "--lr-schedule", choices=["constant", "cosine"], default=None,
        help="cosine: linear warmup then cosine decay to 0 over the run's "
        "total steps. Default: the value persisted in the checkpoint dir "
        "(flag-less --resume keeps the trained schedule), else constant")
    parser.add_argument("--warmup-steps", type=int, default=None,
                        help="warmup length for --lr-schedule cosine (default: 5%% "
                        "of total steps)")


def _add_checkpoint_args(parser) -> None:
    parser.add_argument(
        "--checkpoint-dir", default=None,
        help="save <dir>/<step>/ once per epoch (torch state, metrics, a "
        "SHA-256 manifest), keeping the 2 best by the validation metric "
        "(the newest without validation data)")
    parser.add_argument(
        "--resume", action="store_true",
        help="continue from the newest intact step under --checkpoint-dir, "
        "falling back past corrupt ones")
    parser.add_argument(
        "--resume-auto", action="store_true",
        help="crash-only restart: resume from the newest manifest-intact "
        "checkpoint if one exists (falling back past torn steps, moving "
        "wreckage aside, sweeping stranded .tmp files), else start fresh; "
        "never errors on an empty dir and never needs a step name. Also "
        "marks this experiment's dead RUNNING runs INTERRUPTED first. What "
        "`runs doctor --resume` relaunches with")


def _add_health_args(parser) -> None:
    """Training-health supervisor flags, shared by train and lm."""
    parser.add_argument(
        "--health-policy", choices=["off", "skip", "rollback", "abort"], default="off",
        help="supervise every train step with non-finite (loss/grad-norm "
        "isfinite) and EWMA loss-spike detection: a bad update is "
        "discarded before commit and its batch quarantined; past a "
        "--max-consecutive-skips streak, 'skip' aborts while 'rollback' "
        "restores the newest intact checkpoint (then aborts after "
        "--max-rollbacks); 'abort' stops on the first bad step with a "
        "diagnostic bundle. Default off (no per-step verdict, no sync)")
    parser.add_argument("--spike-zscore", type=float, default=6.0,
                        help="loss-spike threshold: |loss - ewma_mean| > Z * ewma_std")
    parser.add_argument("--health-warmup", type=int, default=20,
                        help="healthy steps observed before the spike detector arms "
                        "(non-finite detection is always armed)")
    parser.add_argument("--max-consecutive-skips", type=int, default=3,
                        help="consecutive bad steps tolerated as skips; one more "
                        "escalates skip -> rollback (or abort)")
    parser.add_argument("--max-rollbacks", type=int, default=2,
                        help="checkpoint rollbacks before the run aborts with a "
                        "diagnostic bundle")


def _health_config(args: argparse.Namespace):
    """``(HealthConfig | None, QuarantineList | None)`` from the flags; the
    blocklist lives beside the checkpoints
    (``<checkpoint_dir>/quarantine.jsonl``), where resume and
    ``quarantine list`` find it."""
    if args.health_policy == "off":
        return None, None
    from ..resilience.health import HealthConfig
    from ..resilience.rollback import QuarantineList

    quarantine = (QuarantineList(Path(args.checkpoint_dir) / "quarantine.jsonl")
                  if args.checkpoint_dir else None)
    return HealthConfig(
        policy=args.health_policy, spike_zscore=args.spike_zscore,
        warmup_steps=args.health_warmup, max_consecutive_skips=args.max_consecutive_skips,
        max_rollbacks=args.max_rollbacks, quarantine=quarantine,
    ), quarantine


def _add_tracking_args(parser, experiment: str) -> None:
    """Run tracking, on by default: a run store under ./dsst_runs, or the
    root in DSST_TRACKING_ROOT (read when the parser is built, so a
    wrapper redirects every run, subprocesses included)."""
    parser.add_argument("--experiment", default=experiment)
    parser.add_argument(
        "--tracking-root", default=os.environ.get("DSST_TRACKING_ROOT", DEFAULT_TRACKING_ROOT),
        help=f"run-store root (default ./{DEFAULT_TRACKING_ROOT}, or env DSST_TRACKING_ROOT)")
    parser.add_argument("--no-tracking", action="store_true",
                        help="disable the default run tracking")


# The one run a CLI invocation may have open: closed as FAILED when the
# command raises, so a crashed run never stays RUNNING in the store.
_active_tracker = None
# This invocation's argv (main stashes it): journaled into each run's
# start event, for `runs doctor --resume` to re-execute.
_invocation_argv: list[str] | None = None


def set_invocation_argv(argv: list[str] | None) -> None:
    global _invocation_argv
    _invocation_argv = list(argv) if argv is not None else None


def _open_tracker(args: argparse.Namespace, run_name: str):
    """The run store of a CLI run, or None when tracking is off."""
    global _active_tracker
    if args.no_tracking or not args.tracking_root:
        return None
    from ..tracking import RunStore, set_run_cmdline

    set_run_cmdline(_invocation_argv)
    _active_tracker = RunStore(args.tracking_root, args.experiment, run_name=run_name)
    _active_tracker.log_params(_args_params(args))
    return _active_tracker


def fail_active_tracker() -> None:
    """Close a command's still-open run as FAILED (the crash path)."""
    global _active_tracker
    if _active_tracker is not None:
        try:
            _active_tracker.finish("FAILED")
        finally:
            _active_tracker = None


def _finish_tracker(tracker) -> None:
    """Close a CLI run: the telemetry archive, the spans, FINISHED, and the
    ``run ->`` pointer (printed before the command's JSON summary)."""
    global _active_tracker
    if tracker is None:
        return
    from .. import telemetry

    tracker.log_telemetry()
    span_log = telemetry.get_span_log()
    if span_log.events():
        tracker.log_text(span_log.to_jsonl(), "spans.jsonl")
    tracker.finish()
    if tracker is _active_tracker:
        _active_tracker = None
    print(f"run -> {tracker.path}", flush=True)


def _args_params(args: argparse.Namespace) -> dict:
    """The invocation as loggable run params (internals and Nones dropped)."""
    skip = {"fn", "no_tracking", "tracking_root"}
    return {k: v for k, v in vars(args).items() if k not in skip and v is not None}


def _mark_interrupted_predecessors(args: argparse.Namespace) -> None:
    """--resume-auto's store hygiene: this experiment's dead-PID RUNNING
    runs become INTERRUPTED before a new run opens."""
    if not args.resume_auto or args.no_tracking or not args.tracking_root:
        return
    from ..tracking import sweep_interrupted

    if Path(args.tracking_root).is_dir():
        sweep_interrupted(args.tracking_root, args.experiment)


def run_train(args: argparse.Namespace) -> dict:
    """What ``train`` does, returning its summary (with the per-epoch
    history) instead of printing it. Raises ``ValueError`` for flags that do
    not fit together or that the port does not support. With a coordinator
    this process joins the process group for the run and leaves it after."""
    from ..runtime import initialize_distributed, shutdown_distributed

    fused_bn = args.fused_bn
    if args.pallas_fused:
        if not args.fused_bn:
            raise ValueError("--pallas-fused builds on the fused path; drop --no-fused-bn")
        if args.model not in ("resnet50", "tiny-bottleneck"):
            raise ValueError("--pallas-fused applies to bottleneck ResNets only "
                             "(resnet50, tiny-bottleneck); drop the flag for "
                             f"--model {args.model}")
        fused_bn = "pallas"
    for k in args.eval_topk:
        if not 1 <= k <= args.num_classes:
            raise ValueError(f"--eval-topk {k} must be in [1, num_classes={args.num_classes}]")
    joined = initialize_distributed(args.coordinator, device=args.device)
    try:
        return _train(args, fused_bn)
    except BaseException:
        fail_active_tracker()
        raise
    finally:
        if joined:
            shutdown_distributed()


def _train(args: argparse.Namespace, fused_bn) -> dict:
    from ..data import DeltaTable, batch_loader, make_batch_reader
    from ..data.augment import AugmentConfig
    from ..data.transform import imagenet_transform_spec
    from ..parallel import ClassifierTask, Trainer, TrainerConfig
    from ..resilience import checkpoint as integrity
    from ..resilience import durability
    from ..runtime import local_topology, process_device
    from .checkpoints import build_classifier_model

    topo = local_topology()
    device = process_device(args.device)
    table = DeltaTable(args.data)
    rows = table.num_records()
    spec = imagenet_transform_spec(crop=args.crop, backend=args.decode_backend,
                                   output_dtype=args.image_dtype,
                                   on_error=args.on_decode_error, fast_decode=args.fast_decode)
    meta_path = Path(args.checkpoint_dir) / "dsst_model.json" if args.checkpoint_dir else None
    meta = (json.loads(meta_path.read_text())
            if meta_path is not None and meta_path.exists() else {})
    # Pretrained torchvision weights embed symmetric stride-2 padding in
    # their BatchNorm statistics; the choice persists beside the
    # checkpoints, so a flag-less --resume rebuilds the same model.
    if args.torch_padding is not None:
        torch_padding = args.torch_padding
    elif args.pretrained:
        torch_padding = True
    else:
        torch_padding = bool(meta.get("torch_padding", False))
    steps_per_epoch = topo.steps_per_epoch(rows, args.batch_size)
    lr = resolve_lr_schedule(args, meta, total_steps=steps_per_epoch * args.epochs)
    meta.update(torch_padding=torch_padding, model=args.model, num_classes=args.num_classes,
                crop=args.crop, fused_bn=fused_bn)
    labels_file = Path(args.data) / "labels.json"
    if labels_file.exists():
        names = [None] * args.num_classes
        for name, idx in json.loads(labels_file.read_text()).items():
            if 0 <= int(idx) < args.num_classes:
                names[int(idx)] = name
        meta["label_names"] = names
    if meta_path is not None and topo.is_coordinator:
        meta_path.parent.mkdir(parents=True, exist_ok=True)
        durability.durable_write_json(meta_path, meta)
    model = build_classifier_model(
        args.model, num_classes=args.num_classes,
        torch_padding=torch_padding, fused_bn=fused_bn, device=device, crop=args.crop)
    restoring = (args.resume and args.checkpoint_dir is not None
                 and bool(integrity.list_steps(args.checkpoint_dir)))
    if args.pretrained and (args.resume_auto or not restoring):
        # A restore would overwrite these weights: skip the load then. Under
        # --resume-auto load them anyway: when every step on disk is torn
        # the run starts fresh, and from the requested weights.
        from ..models.pretrained import load_pretrained_resnet, load_pretrained_vit

        load = load_pretrained_vit if args.model.startswith("vit") else load_pretrained_resnet
        load(args.pretrained, model)
    task = ClassifierTask(model=model, learning_rate=lr, eval_topk=tuple(args.eval_topk),
                          augment=AugmentConfig() if args.augment else None)
    _mark_interrupted_predecessors(args)
    tracker = _open_tracker(args, "train")
    health_cfg, quarantine = _health_config(args)
    trainer = Trainer(TrainerConfig(max_epochs=args.epochs, total_train_rows=rows,
                                    limit_val_batches=args.limit_val_batches,
                                    checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                                    resume_auto=args.resume_auto,
                                    feeder_depth=args.feeder_depth,
                                    profile_dir=args.profile_dir,
                                    profile_start_step=args.profile_start_step,
                                    profile_num_steps=args.profile_num_steps,
                                    shard_opt_state=args.shard_opt_state, health=health_cfg),
                      device=device, tracker=tracker)
    shard = dict(cur_shard=topo.process_index, shard_count=topo.process_count)
    val_factory = None
    if args.val_data:
        val_table = DeltaTable(args.val_data)

        def val_factory():
            return make_batch_reader(val_table, batch_size=args.batch_size, num_epochs=1,
                                     transform_spec=spec, shuffle_row_groups=False, **shard)

    # Under supervision the reader tags each batch with its rows (a
    # discarded step quarantines exactly them), consults the blocklist, and
    # quarantines a corrupt sample instead of dying.
    with batch_loader(table, batch_size=args.batch_size, num_epochs=None,
                      workers_count=args.workers, results_queue_size=args.queue_size,
                      transform_spec=spec, shuffle_row_groups=args.shuffle,
                      quarantine=quarantine, emit_provenance=health_cfg is not None,
                      on_corrupt="quarantine" if health_cfg is not None else "raise",
                      **shard) as reader:
        result = _fit(trainer, task, reader, val_factory, quarantine)
    _finish_tracker(tracker)
    last = result.history[-1] if result.history else {}
    return {
        "steps": result.steps,
        "epochs": len(result.history),
        "images_per_sec": last.get("images_per_sec", 0.0),
        "train_loss": last.get("train_loss"),
        "val_acc": last.get("val_acc"),
        **{f"val_top{k}_acc": last.get(f"val_top{k}_acc") for k in args.eval_topk},
        "best_checkpoint": result.best_checkpoint_path,
        "decode_backend": spec.backend,
        "decode_substitutions": spec.substitutions.count,
        "lr_schedule": meta["lr_schedule"],
        "device": str(device),
        "process_index": topo.process_index,
        "process_count": topo.process_count,
        **_resilience_summary(result, health_cfg, quarantine),
        "history": result.history,
    }


def _fit(trainer, task, train_data, val_factory, quarantine):
    """``trainer.fit``; a health abort carries the blocklist's path."""
    from ..resilience.health import TrainingHealthError

    try:
        return trainer.fit(task, train_data, val_data_factory=val_factory)
    except TrainingHealthError as e:
        e.quarantine_file = str(quarantine.path) if quarantine is not None else None
        raise


def _resilience_summary(result, health_cfg, quarantine) -> dict:
    """The summary's crash-safety fields, as the JAX commands print them:
    ``preempted`` (SIGTERM cut the run short: rerun with --resume),
    ``auto_resumed`` (--resume-auto restored a checkpoint), and with a
    health policy the discarded steps, rollbacks and quarantined rows."""
    out = {"preempted": result.preempted, "auto_resumed": result.auto_resumed}
    if health_cfg is not None:
        out.update(skipped_steps=result.skipped_steps, health_rollbacks=result.health_rollbacks,
                   quarantined=len(quarantine) if quarantine is not None else 0)
    return out


def _run_command(run, args: argparse.Namespace) -> int:
    """Print a training command's summary; exit 1 on flags that do not
    fit together, 3 (with a JSON line naming the diagnostic bundle) when
    the health supervisor aborted the run."""
    from ..resilience.health import TrainingHealthError

    if _no_card(args.device):
        return 1
    try:
        summary = run(args)
    except ValueError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    except TrainingHealthError as e:
        print(json.dumps({"aborted": True, "reason": str(e),
                          "diagnostic_bundle": e.bundle_path,
                          "quarantine_file": getattr(e, "quarantine_file", None)}), flush=True)
        return 3
    summary.pop("history")
    print(json.dumps(summary), flush=True)
    return 0


def _cmd_train(args: argparse.Namespace) -> int:
    return _run_command(run_train, args)


def _register_inference(sub) -> None:
    """``predict``, ``export`` and ``serve``: the JAX commands' flags, plus
    ``--device``."""
    pr = sub.add_parser(
        "predict",
        help="classify a Delta table of images with a trained checkpoint and write "
        "predictions to a Delta table")
    pr.add_argument("--data", required=True, help="Delta table (content/label_index)")
    pr.add_argument("--checkpoint-dir", required=True,
                    help="a train checkpoint dir (the model is read from its "
                    "dsst_model.json)")
    pr.add_argument("--out", required=True, help="predictions Delta table")
    pr.add_argument("--step", type=int, default=None,
                    help="explicit checkpoint step (default: the best step by the tracked "
                    "metric, else the latest)")
    pr.add_argument("--batch-size", type=int, default=64)
    pr.add_argument("--crop", type=int, default=None,
                    help="default: the crop persisted in dsst_model.json, else 224")
    pr.add_argument("--decode-backend", choices=["auto", "native", "pil"], default="auto")
    pr.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cuda:N, or cpu)")
    pr.set_defaults(fn=_cmd_predict)

    ex = sub.add_parser(
        "export",
        help="trained checkpoint -> torchvision-layout .npz state dict (readable by "
        "torch-ecosystem consumers and by train --pretrained, here and in the JAX package)")
    ex.add_argument("--checkpoint-dir", required=True,
                    help="a train checkpoint dir (dsst_model.json)")
    ex.add_argument("--out", required=True, help=".npz output path")
    ex.add_argument("--step", type=int, default=None,
                    help="explicit checkpoint step (default: best, else latest)")
    ex.add_argument("--device", default="cuda",
                    help="torch device the weights are restored on (cuda, cuda:N, or cpu)")
    ex.set_defaults(fn=_cmd_export)

    sv = sub.add_parser(
        "serve",
        help="HTTP inference server over a trained checkpoint: GET /healthz + /readyz, "
        'POST /predict (raw JPEG body or JSON {"instances": ["<base64 jpeg>", ...]}); '
        "scheduler-mediated scoring (bounded admission queue, cross-request batching "
        "into one fixed-shape scorer, graceful drain), label names from the trained "
        "vocabulary")
    sv.add_argument("--checkpoint-dir", required=True,
                    help="a train checkpoint dir (dsst_model.json)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8008)
    sv.add_argument("--step", type=int, default=None,
                    help="explicit checkpoint step (default: best, else latest)")
    sv.add_argument("--micro-batch", type=int, default=8,
                    help="scoring batch; the batcher coalesces waiting images across "
                    "requests up to it")
    sv.add_argument("--queue-depth", type=int, default=64,
                    help="max admitted-but-unscored images; beyond it requests get 429 "
                    "with a measured Retry-After")
    sv.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="max wait for an under-filled batch to gain company: the "
                    "latency/throughput dial of the cross-request batcher")
    sv.add_argument("--deadline-ms", type=float, default=2000.0,
                    help="per-request deadline: work not scored in time is dropped with "
                    "503 instead of scored late (0 disables)")
    sv.add_argument("--drain-timeout", type=float, default=10.0,
                    help="graceful-shutdown bound: seconds to finish queued work after "
                    "Ctrl-C before the server closes anyway")
    sv.add_argument("--decode-workers", type=int, default=2,
                    help="JPEG decode threads feeding the batcher (host-side work, off "
                    "the scoring thread)")
    sv.add_argument("--access-log", default=None, metavar="JSONL",
                    help="structured request log: one JSON line per /predict (request_id "
                    "matching the X-DSST-Trace response header, status, queue_ms, "
                    "batch_fill)")
    sv.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cuda:N, or cpu)")
    sv.set_defaults(fn=_cmd_serve)


def _checkpoint_task(checkpoint_dir, crop_override=None, device="cuda"):
    """The CLI face of :func:`.checkpoints.resolve_checkpoint`: prints the
    missing or unreadable meta diagnosis and returns None (the caller
    exits 1); a crop/architecture conflict exits with the message."""
    from .checkpoints import resolve_checkpoint

    try:
        return resolve_checkpoint(checkpoint_dir, crop_override, device=device)
    except FileNotFoundError as e:
        print(e)
        return None
    except (json.JSONDecodeError, KeyError) as e:
        # A truncated or foreign dsst_model.json, or one missing a key.
        print(f"unreadable model metadata in {checkpoint_dir}/dsst_model.json "
              f"({type(e).__name__}: {e}) — was this checkpoint written by `train`?")
        return None
    except ValueError as e:
        raise SystemExit(str(e))


def _cmd_predict(args: argparse.Namespace) -> int:
    import numpy as np
    import pyarrow as pa
    import torch

    from ..data import batch_loader, write_delta
    from ..data.transform import imagenet_transform_spec
    from ..parallel import restore_state
    from .checkpoints import make_scorer

    if _no_card(args.device):
        return 1
    resolved = _checkpoint_task(args.checkpoint_dir, args.crop, args.device)
    if resolved is None:
        return 1
    meta, crop, model, task = resolved
    device = next(model.parameters()).device
    spec = imagenet_transform_spec(crop=crop, backend=args.decode_backend)
    step = restore_state(task, args.checkpoint_dir, step=args.step)
    # The scorer serve uses: parity by construction.
    predict = make_scorer(task)
    labels, preds, probs = [], [], []
    # One worker with shuffling off: rows stream in table order, so "row"
    # is the table's row index.
    with batch_loader(args.data, batch_size=args.batch_size, num_epochs=1,
                      transform_spec=spec, shuffle_row_groups=False, drop_last=False,
                      workers_count=1) as reader:
        for batch in reader:
            images = torch.from_numpy(batch["image"])
            n = len(images)
            if n < args.batch_size:  # the tail padded to the one shape, as serve pads
                images = torch.cat(
                    [images, images.new_zeros((args.batch_size - n, *images.shape[1:]))])
            pred, prob = predict(images.to(device))
            preds.append(pred[:n].cpu().numpy())
            probs.append(prob[:n].cpu().numpy())
            labels.append(np.asarray(batch["label"]))
    if not preds:
        print("no rows to score")
        return 1
    pred = np.concatenate(preds).astype(np.int64)
    label = np.concatenate(labels).astype(np.int64)
    total = len(pred)
    columns = {
        "row": pa.array(np.arange(total, dtype=np.int64)),
        "label_index": pa.array(label),
        "pred_index": pa.array(pred),
        "pred_prob": pa.array(np.concatenate(probs).astype(np.float64)),
    }
    # Names from the vocabulary persisted with the checkpoint at train
    # time, never the scored table's labels.json.
    names = meta.get("label_names")
    if names:
        columns["pred_label"] = pa.array(
            [names[i] if 0 <= i < len(names) else None for i in pred], type=pa.string())
    write_delta(pa.table(columns), args.out)
    print(json.dumps({
        "rows": total,
        "checkpoint_step": step,
        "accuracy_vs_label_index": round(float((pred == label).sum()) / total, 4),
        "out": str(args.out),
        "device": str(device),
    }), flush=True)
    return 0


def _cmd_export(args: argparse.Namespace) -> int:
    from ..models.pretrained import export_torchvision
    from ..parallel import restore_state

    if not args.out.endswith(".npz"):
        # export_torchvision refuses it too; before the restore, at once.
        raise SystemExit(f"--out must end in .npz (got {args.out!r})")
    if _no_card(args.device):
        return 1
    resolved = _checkpoint_task(args.checkpoint_dir, device=args.device)
    if resolved is None:
        return 1
    _meta, _crop, model, task = resolved
    step = restore_state(task, args.checkpoint_dir, step=args.step)
    exported = export_torchvision(model, args.out)
    print(json.dumps({"checkpoint_step": step, "tensors": len(exported), "out": args.out}),
          flush=True)
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    from ..serving import SchedulerConfig
    from ..workloads.serving import Predictor, serve_in_thread

    if _no_card(args.device):
        return 1
    # The metadata first, with its own diagnosis; a KeyError from the
    # restore below is not the meta file's fault. The resolved tuple goes
    # to the Predictor, so startup resolves the checkpoint once.
    resolved = _checkpoint_task(args.checkpoint_dir, device=args.device)
    if resolved is None:
        return 1
    try:
        predictor = Predictor(args.checkpoint_dir, step=args.step,
                              micro_batch=args.micro_batch, resolved=resolved)
    except FileNotFoundError as e:
        print(e)
        return 1
    config = SchedulerConfig(
        queue_depth=args.queue_depth,
        batch_window_ms=args.batch_window_ms,
        deadline_ms=args.deadline_ms,
        drain_timeout_s=args.drain_timeout,
        decode_workers=args.decode_workers,
    )
    # The accept loop runs in the handle's thread so Ctrl-C lands here,
    # where close() drains while the server still answers.
    handle = serve_in_thread(predictor, args.host, args.port, config=config,
                             access_log=args.access_log)
    try:
        # The boot line inside the interrupt handling: a client that sends
        # Ctrl-C as soon as it reads the line still gets a drained run.
        print(json.dumps({
            "serving": handle.address,
            "port": handle.port,
            "model": predictor.meta.get("model"),
            "checkpoint_step": predictor.step,
            "crop": predictor.crop,
            "micro_batch": predictor.micro_batch,
            "queue_depth": config.queue_depth,
            "batch_window_ms": config.batch_window_ms,
            "deadline_ms": config.deadline_ms,
            "device": str(predictor.device),
        }), flush=True)
        while handle.thread.is_alive():
            handle.thread.join(1.0)
    except KeyboardInterrupt:
        print(json.dumps({"draining": True, "pending_images": handle.scheduler.pending}),
              flush=True)
    finally:
        handle.close(args.drain_timeout)
    return 0


def _register_lm(sub) -> None:
    lm = sub.add_parser(
        "lm",
        help="train a Transformer LM on a synthetic Markov token stream "
        "(flash attention), on one card or data-parallel over several",
    )
    lm.add_argument("--vocab", type=int, default=256)
    lm.add_argument("--dim", type=int, default=128)
    lm.add_argument("--heads", type=int, default=4)
    lm.add_argument("--layers", type=int, default=2)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--batch-size", type=int, default=8)
    lm.add_argument("--epochs", type=int, default=2)
    lm.add_argument("--steps-per-epoch", type=int, default=50)
    lm.add_argument("--learning-rate", type=float, default=3e-4)
    lm.add_argument("--attention", choices=["flash", "reference"], default="flash",
                    help="flash: the hand-written kernel on the card (its plain "
                    "version on the CPU); reference: plain attention")
    lm.add_argument("--ffn", choices=["dense", "moe"], default="dense",
                    help="moe swaps every block's MLP for a top-1 routed mixture of "
                    "experts with the load-balance aux loss in the objective; across "
                    "processes the experts are split over them when their count "
                    "divides --num-experts")
    lm.add_argument("--num-experts", type=int, default=8, help="with --ffn moe")
    lm.add_argument("--aux-loss-weight", type=float, default=0.01, help="with --ffn moe")
    lm.add_argument(
        "--concentration", type=float, default=0.05,
        help="Dirichlet concentration of the Markov source's transition "
        "rows; lower = more predictable = lower entropy floor")
    lm.add_argument("--seed", type=int, default=0, help="seed of the Markov chain")
    lm.add_argument("--limit-val-batches", type=int, default=5)
    lm.add_argument(
        "--sample", type=int, default=0, metavar="N",
        help="after training, greedy-generate N tokens from the trained "
        "model (KV-cached decode) and report the mean TRUE-chain "
        "probability of the generated transitions (uniform chance is 1/vocab)")
    _add_lr_schedule_args(lm)
    _add_checkpoint_args(lm)
    lm.add_argument("--feeder-depth", type=int, default=2,
                    help="bound of the background feeder's on-device batch queue")
    _add_health_args(lm)
    _add_tracking_args(lm, "lm")
    _add_coordinator_arg(lm)
    lm.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cuda:N, or cpu)")
    lm.set_defaults(fn=_cmd_lm)


def resolve_lr_schedule(args: argparse.Namespace, meta: dict, total_steps: int):
    """Port of ``config/commands.py::_resolve_lr_schedule``: resolve
    ``--lr-schedule``/``--warmup-steps`` against persisted metadata.

    Returns the learning rate (a float, or a schedule of the update count)
    and updates ``meta`` with the full trajectory (``lr_schedule``,
    ``warmup_steps``, ``decay_steps``): a flag-less ``--resume`` rebuilds
    the SAME warmup/decay trajectory, so the restored step count lands on
    the curve it was trained on. Passing ``--lr-schedule`` explicitly
    redefines the trajectory from this invocation's run length.
    """
    from ..parallel.schedules import warmup_cosine_decay_schedule

    explicit = args.lr_schedule is not None
    schedule = args.lr_schedule if explicit else meta.get("lr_schedule", "constant")
    if schedule != "cosine":
        meta["lr_schedule"] = "constant"
        meta.pop("warmup_steps", None)
        meta.pop("decay_steps", None)
        return args.learning_rate
    if explicit or "decay_steps" not in meta:
        decay = max(1, total_steps)
        warmup = args.warmup_steps if args.warmup_steps is not None else max(1, decay // 20)
    else:
        decay = int(meta["decay_steps"])
        warmup = (args.warmup_steps if args.warmup_steps is not None
                  else int(meta.get("warmup_steps", max(1, decay // 20))))
    warmup = min(warmup, decay)
    meta.update(lr_schedule="cosine", warmup_steps=warmup, decay_steps=decay)
    return warmup_cosine_decay_schedule(args.learning_rate, warmup, decay)


def run_lm(args: argparse.Namespace) -> dict:
    """What ``lm`` does, returning its summary (with the per-epoch history)
    instead of printing it. Raises ``ValueError`` for flags that do not fit
    together. With a coordinator this process joins the process group for
    the run and leaves it after."""

    from ..runtime import initialize_distributed, shutdown_distributed

    if args.sample > 0 and args.seq <= 4:
        raise ValueError("--sample needs --seq > 4 (4 prompt tokens + at least one "
                         "generated token must fit in max_seq)")
    joined = initialize_distributed(args.coordinator, device=args.device)
    try:
        return _lm(args)
    except BaseException:
        fail_active_tracker()
        raise
    finally:
        if joined:
            shutdown_distributed()


def _lm(args: argparse.Namespace) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..datagen.tokens import (
        TokenStreamConfig, entropy_floor, token_batches, transition_matrix,
    )
    from ..models import generate, seeded_lm
    from ..ops import flash_attention
    from ..parallel import LMTask, Trainer, TrainerConfig
    from ..resilience import durability
    from ..runtime import local_topology, process_device

    topo = local_topology()
    device = process_device(args.device)
    stream = TokenStreamConfig(vocab_size=args.vocab, batch_size=args.batch_size,
                               seq_len=args.seq, concentration=args.concentration,
                               seed=args.seed)
    floor = entropy_floor(stream)
    moe = args.ffn == "moe"
    ranks = topo.process_count
    # Weights from seed 0, as the JAX trainer's default init key. Across
    # ranks the MoE routes the global batch, and splits the experts' work
    # when the rank count divides their number (JAX commands.py:1039-1041).
    model = seeded_lm(0, device=device, vocab_size=args.vocab, dim=args.dim,
                      num_heads=args.heads, num_layers=args.layers, max_seq=args.seq,
                      attention=args.attention, ffn=args.ffn,
                      num_experts=args.num_experts if moe else 0,
                      expert_group=dist.group.WORLD if moe and ranks > 1 else None,
                      shard_experts=moe and ranks > 1 and args.num_experts % ranks == 0)
    meta_path = Path(args.checkpoint_dir) / "dsst_lm.json" if args.checkpoint_dir else None
    meta = (json.loads(meta_path.read_text())
            if meta_path is not None and meta_path.exists() else {})
    lr = resolve_lr_schedule(args, meta, total_steps=args.steps_per_epoch * args.epochs)
    if meta_path is not None and topo.is_coordinator:
        meta_path.parent.mkdir(parents=True, exist_ok=True)
        durability.durable_write_json(meta_path, meta)
    task = LMTask(model=model, learning_rate=lr,
                  aux_loss_weight=args.aux_loss_weight if moe else 0.0)
    _mark_interrupted_predecessors(args)
    tracker = _open_tracker(args, "lm")
    if tracker is not None:
        tracker.log_params({"entropy_floor": floor})
    health_cfg, quarantine = _health_config(args)
    trainer = Trainer(TrainerConfig(
        max_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        limit_val_batches=args.limit_val_batches, checkpoint_dir=args.checkpoint_dir,
        resume=args.resume, resume_auto=args.resume_auto, feeder_depth=args.feeder_depth,
        health=health_cfg), device=device, tracker=tracker)
    # Each process draws its own trajectory of the same chain (the
    # multi-process counterpart of a reader shard); eval shares one seed.
    result = _fit(
        trainer, task, token_batches(stream, sample_seed=args.seed + 1 + topo.process_index),
        lambda: token_batches(
            stream, num_batches=args.limit_val_batches, sample_seed=args.seed + 100_000),
        quarantine,
    )
    _finish_tracker(tracker)
    last = result.history[-1] if result.history else {}
    summary = {
        "steps": result.steps,
        "train_loss": last.get("train_loss"),
        "val_loss": last.get("val_loss"),
        "val_ppl": last.get("val_ppl"),
        "entropy_floor_nats": round(floor, 4),
        "best_checkpoint": result.best_checkpoint_path,
        "tokens_per_sec": last.get("tokens_per_sec"),
        "steady_tokens_per_sec": last.get("steady_tokens_per_sec"),
        "steady_data_wait_s": last.get("steady_data_wait_s"),
        "lr_schedule": meta["lr_schedule"],
        "device": str(device),
        "process_index": topo.process_index,
        "process_count": topo.process_count,
        **_resilience_summary(result, health_cfg, quarantine),
    }
    if args.sample > 0:
        # KV-cached greedy decode from the trained weights, scored against
        # the TRUE chain (the generator is the fixture).
        first = next(token_batches(stream, num_batches=1, sample_seed=args.seed + 200_000))
        prompt = torch.as_tensor(first["tokens"][:1, :4], dtype=torch.long, device=device)
        n = min(args.sample, args.seq - 4)
        if n < args.sample:
            summary["sample_truncated_to"] = n
        out = generate(model, prompt, n).cpu().numpy()
        t = transition_matrix(stream)
        probs = [float(t[int(out[0, i]), int(out[0, i + 1])])
                 for i in range(3, out.shape[1] - 1)]
        summary["sample_tokens"] = out[0].tolist()
        summary["sample_mean_true_prob"] = round(float(np.mean(probs)), 4)
        summary["sample_chance_prob"] = round(1.0 / args.vocab, 4)
    # This process's launches of the flash kernel (K4): 0 with reference
    # attention or on the CPU.
    summary["flash_launches"] = flash_attention.launches
    summary["history"] = result.history
    return summary


def _cmd_lm(args: argparse.Namespace) -> int:
    return _run_command(run_lm, args)


def _cmd_serve_lm(args: argparse.Namespace) -> int:
    import torch

    from ..serving.lm import LMConfig, LMEngine, StubLMDecoder
    from ..workloads.serving import serve_lm_in_thread

    try:
        buckets = tuple(
            int(b) for b in str(args.prefill_buckets).split(",") if b
        )
        config = LMConfig(
            slots=args.slots,
            max_len=args.max_len,
            prefill_buckets=buckets,
            queue_depth=args.queue_depth,
            deadline_ms=args.deadline_ms,
            inter_token_budget_ms=args.inter_token_budget_ms,
            drain_timeout_s=args.drain_timeout,
        )
    except ValueError as e:
        print(e)
        return 1
    if args.stub:
        decoder = StubLMDecoder(
            vocab_size=args.vocab, step_ms=args.step_ms,
            slots=args.slots, max_len=args.max_len,
            buckets=config.prefill_buckets,
        )
    else:
        from ..models import seeded_lm
        from ..serving.lm import TransformerDecoder

        device = torch.device(args.device)
        if _no_card(args.device):
            return 1
        model = seeded_lm(
            args.seed, device=device, vocab_size=args.vocab, dim=args.dim,
            num_heads=args.heads, num_layers=args.layers,
            max_seq=args.max_len, attention=args.attention,
        )
        decoder = TransformerDecoder(
            model, slots=args.slots, max_len=args.max_len,
            buckets=config.prefill_buckets,
        )
    # The journal's start event (pid + boot id) is what lets `runs doctor`
    # classify a killed replica INTERRUPTED.
    tracker = _open_tracker(args, "serve-lm")
    engine = LMEngine(decoder, config).start()
    handle = serve_lm_in_thread(engine, args.host, args.port,
                                access_log=args.access_log)
    try:
        # The boot line inside the interrupt handling: a client that sends
        # Ctrl-C as soon as it reads the line still gets a drained run.
        print(json.dumps({
            "serving": handle.address,
            "port": handle.port,
            "decoder": type(decoder).__name__,
            "device": None if args.stub else args.device,
            "slots": config.slots,
            "max_len": config.max_len,
            "prefill_buckets": list(config.prefill_buckets),
            "queue_depth": config.queue_depth,
            "deadline_ms": config.deadline_ms,
        }), flush=True)
        while handle.thread.is_alive():
            handle.thread.join(1.0)
    except KeyboardInterrupt:
        print(json.dumps({"draining": True, "pending": engine.pending}),
              flush=True)
    finally:
        handle.close(args.drain_timeout)
        _finish_tracker(tracker)
    return 0


def _register_checkpoints(sub) -> None:
    ck = sub.add_parser("checkpoints", help="checkpoint maintenance: verify per-step "
                        "integrity manifests")
    csub = ck.add_subparsers(dest="checkpoints_cmd", required=True)
    vf = csub.add_parser(
        "verify", help="walk a checkpoint dir's steps and report intact / corrupt / "
        "unverified per the dsst_manifest.json content checksums")
    vf.add_argument("dir", help="a train/lm checkpoint directory")
    vf.add_argument("--json", action="store_true",
                    help="emit the full report as one JSON document instead of lines")
    vf.set_defaults(fn=_cmd_checkpoints_verify)


def _cmd_checkpoints_verify(args: argparse.Namespace) -> int:
    from ..resilience import verify_checkpoint_dir

    if not Path(args.dir).is_dir():
        print(f"no such checkpoint directory: {args.dir}")
        return 2
    report = verify_checkpoint_dir(args.dir)
    counts = {"intact": 0, "corrupt": 0, "unverified": 0}
    for entry in report:
        counts[entry["status"]] += 1
    if args.json:
        print(json.dumps({"dir": args.dir, "steps": report, **counts}))
    else:
        if not report:
            print(f"no checkpoint steps under {args.dir}")
        for entry in report:
            line = f"step {entry['step']}: {entry['status']}"
            if entry["problems"]:
                line += " (" + "; ".join(entry["problems"]) + ")"
            print(line)
        if report:
            print(f"{counts['intact']} intact, {counts['corrupt']} corrupt, "
                  f"{counts['unverified']} unverified (no manifest)")
    return 1 if counts["corrupt"] else 0


def _register_quarantine(sub) -> None:
    qr = sub.add_parser("quarantine", help="manage the poison-batch blocklist the health "
                        "supervisor writes (rows excluded from replay/resume)")
    qsub = qr.add_subparsers(dest="quarantine_cmd", required=True)
    target_help = ("a quarantine .jsonl file, or a checkpoint dir holding quarantine.jsonl "
                   "(where train/lm --health-policy write it)")
    ls = qsub.add_parser("list", help="print quarantined row ranges, one JSON line each")
    ls.add_argument("target", help=target_help)
    ls.set_defaults(fn=_cmd_quarantine_list)
    cl = qsub.add_parser("clear", help="drop every entry (the rows rejoin the next "
                         "replay/resume)")
    cl.add_argument("target", help=target_help)
    cl.set_defaults(fn=_cmd_quarantine_clear)


def _quarantine_target(target: str) -> Path:
    p = Path(target)
    return p / "quarantine.jsonl" if p.is_dir() else p


def _cmd_quarantine_list(args: argparse.Namespace) -> int:
    from ..resilience.rollback import QuarantineList

    path = _quarantine_target(args.target)
    if not path.exists():
        print(f"no quarantine list at {path}")
        return 1
    q = QuarantineList(path)
    rows = 0
    for entry in q.entries:
        rows += int(entry["row_hi"]) - int(entry["row_lo"])
        print(json.dumps(entry))
    print(f"{len(q)} entries, {rows} rows quarantined ({path})", file=sys.stderr)
    return 0


def _cmd_quarantine_clear(args: argparse.Namespace) -> int:
    from ..resilience.rollback import QuarantineList

    path = _quarantine_target(args.target)
    if not path.exists():
        print(f"no quarantine list at {path}")
        return 1
    print(f"cleared {QuarantineList(path).clear()} entries from {path}")
    return 0


def _register_runs(sub) -> None:
    rn = sub.add_parser("runs", help="browse the run store: list runs, show one, and "
                        "sweep interrupted ones (doctor)")
    rsub = rn.add_subparsers(dest="runs_cmd", required=True)
    # The writers' default root and env override, so the browser reads
    # where they wrote.
    root = os.environ.get("DSST_TRACKING_ROOT", DEFAULT_TRACKING_ROOT)
    root_help = f"run-store root (default ./{DEFAULT_TRACKING_ROOT}, or env DSST_TRACKING_ROOT)"
    ls = rsub.add_parser("list", help="one JSON line per run, newest first")
    ls.add_argument("--tracking-root", default=root, help=root_help)
    ls.add_argument("--experiment", default=None)
    ls.set_defaults(fn=_cmd_runs_list)
    sh = rsub.add_parser("show", help="full record of one run (meta, params, last metrics)")
    sh.add_argument("run", help="EXPERIMENT/RUN_ID (as `runs list` prints)")
    sh.add_argument("--tracking-root", default=root, help=root_help)
    sh.set_defaults(fn=_cmd_runs_show)
    dr = rsub.add_parser(
        "doctor", help="classify every run from its journal (PID + boot id), durably mark "
        "dead RUNNING runs INTERRUPTED, clean stranded .tmp files, and report resumable "
        "checkpoints; --resume relaunches each interrupted run's recorded command with "
        "--resume-auto")
    dr.add_argument("--tracking-root", default=root, help=root_help)
    dr.add_argument("--experiment", default=None)
    dr.add_argument("--json", action="store_true",
                    help="emit the full classification report as one JSON document")
    dr.add_argument("--resume", action="store_true",
                    help="after the sweep, re-execute the recorded command of each "
                    "interrupted run that has a checkpoint dir, with --resume-auto "
                    "ensured and --fault-plan stripped; sequentially, newest run per "
                    "checkpoint dir first")
    dr.set_defaults(fn=_cmd_runs_doctor)


def _cmd_runs_list(args: argparse.Namespace) -> int:
    from ..tracking import list_runs

    runs = list_runs(args.tracking_root, args.experiment)
    for meta in runs:
        print(json.dumps(meta))
    if not runs:
        print(f"no runs under {args.tracking_root}"
              + (f" (experiment {args.experiment})" if args.experiment else ""),
              file=sys.stderr)
    return 0


def _cmd_runs_show(args: argparse.Namespace) -> int:
    from ..tracking import load_run

    if "/" not in args.run:
        print(f"expected EXPERIMENT/RUN_ID, got {args.run!r}")
        return 1
    experiment, run_id = args.run.split("/", 1)
    try:
        print(json.dumps(load_run(args.tracking_root, experiment, run_id), indent=1))
    except (OSError, json.JSONDecodeError, KeyError):
        print(f"no readable run {args.run} under {args.tracking_root}")
        return 1
    return 0


def _cmd_runs_doctor(args: argparse.Namespace) -> int:
    from ..tracking import sweep_interrupted

    if not Path(args.tracking_root).is_dir():
        print(f"no run store at {args.tracking_root}")
        return 0
    report = sweep_interrupted(args.tracking_root, args.experiment)
    if args.json:
        print(json.dumps({"root": str(args.tracking_root), "runs": report}))
    else:
        for cls in report:
            line = f"{cls['experiment']}/{cls['run_id']}: {cls['effective_status']}"
            if cls.get("marked"):
                line += f" (was RUNNING, pid {cls['pid']} dead; marked)"
            if cls.get("resumable_step") is not None:
                line += (f" - resumable: step {cls['resumable_step']} in "
                         f"{cls['checkpoint_dir']}")
            if cls["effective_status"] == "INTERRUPTED" and cls.get("firing_alerts"):
                line += " - SLO alerts firing at death: " + ", ".join(cls["firing_alerts"])
            print(line)
        n_marked = sum(1 for c in report if c.get("marked"))
        n_resumable = sum(1 for c in report if c.get("resumable_step") is not None)
        print(f"{len(report)} run(s), {n_marked} newly marked INTERRUPTED, "
              f"{n_resumable} resumable")
    if not args.resume:
        return 0
    return _doctor_resume(report)


def _doctor_resume(report: list[dict]) -> int:
    """Re-execute interrupted runs' recorded commands with --resume-auto:
    one relaunch per checkpoint dir (the newest run wins), sequentially,
    from the run's recorded working directory, with the fault plan
    dropped from the environment and this checkout on the path."""
    import subprocess

    resumable = [c for c in report
                 if c["effective_status"] == "INTERRUPTED" and c.get("cmdline")
                 and (c.get("resumable_step") is not None or c.get("checkpoint_dir"))]
    resumable.sort(key=lambda c: c.get("start_time") or 0.0, reverse=True)
    env = {k: v for k, v in os.environ.items() if k != "DSST_FAULT_PLAN"}
    checkout = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(p for p in (checkout, env.get("PYTHONPATH")) if p)
    seen: set[str] = set()
    rc = 0
    for cls in resumable:
        if cls["checkpoint_dir"] in seen:
            continue
        seen.add(cls["checkpoint_dir"])
        argv = _resume_argv(cls["cmdline"])
        if argv is None:
            continue
        print(f"doctor --resume: {cls['experiment']}/{cls['run_id']} -> " + " ".join(argv),
              flush=True)
        cwd = cls.get("cwd")
        if cwd and not os.path.isdir(cwd):
            print(f"doctor --resume: recorded cwd {cwd} is gone; skipping {cls['run_id']}")
            rc = rc or 1
            continue
        proc = subprocess.run(
            [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", *argv],
            env=env, cwd=cwd)
        rc = rc or proc.returncode
    if not resumable:
        print("doctor --resume: nothing resumable")
    return rc


def _resume_argv(cmdline: list[str]) -> list[str] | None:
    """Recorded argv -> relaunch argv: --resume-auto ensured for train and
    lm, --fault-plan stripped (a fault-armed run must not re-arm its own
    faults when revived); None for any other command."""
    argv: list[str] = []
    skip_next = False
    for tok in cmdline:
        if skip_next:
            skip_next = False
            continue
        if tok == "--fault-plan":
            skip_next = True
            continue
        if tok.startswith("--fault-plan="):
            continue
        argv.append(tok)
    if not any(tok in ("train", "lm") for tok in argv):
        return None
    if "--resume-auto" not in argv:
        argv.append("--resume-auto")
    return argv


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    # The exact invocation, for the run journal: what `runs doctor
    # --resume` re-executes.
    set_invocation_argv(argv if argv is not None else sys.argv[1:])
    fault_spec = args.fault_plan or os.environ.get("DSST_FAULT_PLAN")
    if fault_spec:
        # Armed before any command work, and exported so subprocesses arm
        # the same plan.
        from ..resilience.faults import install_from_spec

        os.environ["DSST_FAULT_PLAN"] = fault_spec
        install_from_spec(fault_spec)
    try:
        return args.fn(args)
    except BaseException:
        # A crashed command must not leave its run RUNNING.
        fail_active_tracker()
        raise


if __name__ == "__main__":
    sys.exit(main())
