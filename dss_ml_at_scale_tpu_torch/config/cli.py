"""Command line of the port: ``python -m dss_ml_at_scale_tpu_torch.config.cli``.

``serve-lm`` is the port of ``dsst serve-lm`` (``config/commands.py`` of the
JAX package): the same flags, plus ``--device`` (default ``cuda``; a
missing card is an error, never a silent CPU run). The run-tracking flags
of the JAX command wait for the port of the tracking store.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
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
    return parser


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
        if device.type == "cuda" and not torch.cuda.is_available():
            print(json.dumps({"error": f"--device {args.device}: no CUDA "
                              "device is available (pass --device cpu to "
                              "run on the CPU)"}), flush=True)
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
    args = _build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
