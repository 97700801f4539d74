"""Command line of the port: ``python -m dss_ml_at_scale_tpu_torch.config.cli``.

Ports of the JAX package's commands (``config/commands.py``):

- ``serve-lm``: the same flags, plus ``--device``. The run-tracking flags
  wait for the port of the tracking store.
- ``datagen images``: the synthetic JPEG-grating Delta table.
- ``train``: single-card image-classifier training from a Delta table,
  with the JAX command's flags that the port supports (names and
  defaults kept), plus ``--device``. Checkpointing, resume, health,
  tracking, profiling, augmentation, the pretrained loader, the ViT models
  and multi-host training wait for their ports.

``--device`` defaults to ``cuda``; a missing card is an error, never a
silent CPU run.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dss_ml_at_scale_tpu_torch",
        description="PyTorch/CUDA port of dss_ml_at_scale_tpu",
    )
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
    sv.set_defaults(fn=_cmd_serve_lm)
    _register_datagen(sub)
    _register_train(sub)
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
        "train", help="single-card image-classifier training from a Delta table")
    tr.add_argument("--data", required=True, help="train Delta table (content/label_index)")
    tr.add_argument("--val-data", default=None, help="validation Delta table")
    tr.add_argument("--epochs", type=int, default=2)
    tr.add_argument("--batch-size", type=int, default=212)
    tr.add_argument("--learning-rate", type=float, default=1e-5)
    tr.add_argument("--num-classes", type=int, default=1000)
    tr.add_argument("--crop", type=int, default=224)
    tr.add_argument("--model", choices=list(CLASSIFIERS), default="resnet50")
    tr.add_argument(
        "--torch-padding", action=argparse.BooleanOptionalAction, default=False,
        help="torchvision-style symmetric stride-2 padding (default: off, "
        "XLA SAME padding as in the JAX package)",
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
    tr.add_argument("--workers", type=int, default=2)
    tr.add_argument("--queue-size", type=int, default=20)
    tr.add_argument("--feeder-depth", type=int, default=2,
                    help="bound of the feeder's on-device batch queue")
    tr.add_argument(
        "--image-dtype", choices=["float32", "uint8"], default="float32",
        help="uint8 ships raw bytes to the device and normalizes inside the "
        "step; float32 normalizes on the host",
    )
    tr.add_argument(
        "--decode-backend", choices=["auto", "native", "pil"], default="auto",
        help="JPEG decode path; the port has the PIL path only, and auto "
        "resolves to it (reported in the run summary)",
    )
    tr.add_argument("--on-decode-error", choices=["raise", "substitute"], default="raise")
    tr.add_argument("--shuffle", action=argparse.BooleanOptionalAction, default=True,
                    help="shuffle row groups per epoch (seeded)")
    tr.add_argument("--limit-val-batches", type=int, default=5)
    tr.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda, cuda:N, or cpu)")
    tr.set_defaults(fn=_cmd_train)


def run_train(args: argparse.Namespace) -> dict:
    """What ``train`` does, returning its summary (with the per-epoch
    history) instead of printing it. Raises ``ValueError`` for flags that do
    not fit together or that the port does not support."""
    import torch

    from ..data import DeltaTable, batch_loader, make_batch_reader
    from ..data.transform import imagenet_transform_spec
    from ..parallel import ClassifierTask, Trainer, TrainerConfig
    from .checkpoints import build_classifier_model

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
    device = torch.device(args.device)
    table = DeltaTable(args.data)
    rows = table.num_records()
    spec = imagenet_transform_spec(crop=args.crop, backend=args.decode_backend,
                                   output_dtype=args.image_dtype,
                                   on_error=args.on_decode_error)
    model = build_classifier_model(
        args.model, num_classes=args.num_classes,
        torch_padding=args.torch_padding, fused_bn=fused_bn, device=device)
    task = ClassifierTask(model=model, learning_rate=args.learning_rate,
                          eval_topk=tuple(args.eval_topk))
    trainer = Trainer(TrainerConfig(max_epochs=args.epochs, total_train_rows=rows,
                                    limit_val_batches=args.limit_val_batches,
                                    feeder_depth=args.feeder_depth), device=device)
    val_factory = None
    if args.val_data:
        val_table = DeltaTable(args.val_data)

        def val_factory():
            return make_batch_reader(val_table, batch_size=args.batch_size, num_epochs=1,
                                     transform_spec=spec, shuffle_row_groups=False)

    with batch_loader(table, batch_size=args.batch_size, num_epochs=None,
                      workers_count=args.workers, results_queue_size=args.queue_size,
                      transform_spec=spec, shuffle_row_groups=args.shuffle) as reader:
        result = trainer.fit(task, reader, val_data_factory=val_factory)
    last = result.history[-1] if result.history else {}
    return {
        "steps": result.steps,
        "epochs": len(result.history),
        "images_per_sec": last.get("images_per_sec", 0.0),
        "train_loss": last.get("train_loss"),
        "val_acc": last.get("val_acc"),
        **{f"val_top{k}_acc": last.get(f"val_top{k}_acc") for k in args.eval_topk},
        "decode_backend": spec.backend,
        "decode_substitutions": spec.substitutions.count,
        "device": str(device),
        "history": result.history,
    }


def _cmd_train(args: argparse.Namespace) -> int:
    if _no_card(args.device):
        return 1
    try:
        summary = run_train(args)
    except ValueError as e:
        print(e)
        return 1
    summary.pop("history")
    print(json.dumps(summary), flush=True)
    return 0


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
    engine = LMEngine(decoder, config).start()
    handle = serve_lm_in_thread(engine, args.host, args.port,
                                access_log=args.access_log)
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
    try:
        while handle.thread.is_alive():
            handle.thread.join(1.0)
    except KeyboardInterrupt:
        print(json.dumps({"draining": True, "pending": engine.pending}),
              flush=True)
    finally:
        handle.close(args.drain_timeout)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
