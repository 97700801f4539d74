"""The audited entrypoint registry: the port's REAL programs.

Port of ``dss_ml_at_scale_tpu/analysis/audit/entrypoints.py``: the same
13 entrypoints, each built through the factory production uses
(``ClassifierTask``/``LMTask`` wrapped by ``Trainer.data_parallel``, the
health guard, ``PipelinedLMTask`` on a ``pipe_grid``, ``decode_step``,
``slot_decode``/``prefill_bucket``, ``make_scorer``, the fused ops'
public entries, ``sarimax_fit``), on JAX's tiny shapes: the ResNet
``[1, 1]`` of 8 filters on a 16x16 batch of 16, and the LM of vocab 64,
dim 32, 4 heads, 2 layers. The process group is the audit's fake world of
8 ranks, so the data-parallel steps run DDP (through the audit's comm
hook) and their BatchNorm statistics are global, as in production.

The kernel entrypoints run in f32 on the CPU (each kernel's plain
version) and in bf16 on a card, where K1–K3 refuse f32; there their
launch counters must move.

Adding an entrypoint: write a ``build(device, world) -> ProgramSpec`` here
and add it to :data:`_BUILDERS`; the first audit reports it
``unbaselined`` until ``--update-baseline --reason`` pins it.
Suppressions live HERE, next to the entrypoint they silence, with a
mandatory reason.
"""

from __future__ import annotations

from typing import Callable, Mapping

from .core import ProgramSpec

# -- shared tiny-input helpers ------------------------------------------------


def _generator():
    import torch

    return torch.Generator().manual_seed(0)


def _train_state(task) -> Callable[[], dict]:
    """Params, buffers (BN running statistics) and optimizer state: what
    JAX's train step donates, by name."""
    import torch

    def read() -> dict:
        out = {f"param:{n}": p for n, p in task.model.named_parameters()}
        out.update({f"buffer:{n}": b for n, b in task.model.named_buffers()})
        names = {p: n for n, p in task.model.named_parameters()}
        for p, state in task.optimizer.state.items():
            for k, v in state.items():
                if torch.is_tensor(v):
                    out[f"adam:{names.get(p, '?')}:{k}"] = v
        return out

    return read


def _adam_steps(task) -> Callable[[], list]:
    """Adam's per-parameter step counters: host tensors by design."""
    import torch

    return lambda: [st["step"] for st in task.optimizer.state.values()
                    if torch.is_tensor(st.get("step"))
                    and st["step"].device.type == "cpu"]


# DDP rebuilds its buckets once, in the second iteration's forward (a
# broadcast of the bucket order through a device->host copy): the recorded
# call of a DDP step is the third.
_DDP_WARMUP = 2


def _data_parallel(task, device: str, world) -> None:
    """The production wrap (DDP over the audit's world), with the audit's
    comm hook on the DDP module."""
    from ...parallel.trainer import Trainer, TrainerConfig

    Trainer(TrainerConfig(), device=device).data_parallel(task)
    if task.net is not task.model:
        world.attach(task.net)


def _classifier_task(device: str):
    import torch

    from ...models.resnet import ResNet, ResNetBlock
    from ...parallel.trainer import ClassifierTask

    model = ResNet([1, 1], block_cls=ResNetBlock, num_classes=4,
                   num_filters=8, dtype=torch.float32).to(device)
    return ClassifierTask(model=model, learning_rate=1e-3)


def _classifier_batch(device: str) -> dict:
    import torch

    g = _generator()
    return {
        "image": torch.randn(16, 16, 16, 3, generator=g).to(device),
        "label": torch.randint(0, 4, (16,), generator=g).to(device),
    }


def _lm_model(device: str):
    import torch

    from ...models.transformer import TransformerLM

    return TransformerLM(vocab_size=64, dim=32, num_heads=4, num_layers=2,
                         max_seq=64, dtype=torch.float32,
                         attention="reference", device=device)


def _tokens(shape, device: str):
    import torch

    return torch.randint(0, 64, shape, generator=_generator()).to(device)


def _kernel_dtype(device: str):
    """f32 on the CPU (JAX's audit dtype), bf16 on a card: K1–K3 take
    bf16 only there."""
    import torch

    return torch.bfloat16 if device.startswith("cuda") else torch.float32


def _inference(fn: Callable) -> Callable:
    """``fn`` under ``torch.inference_mode``, as the serving engine and
    ``generate`` call the decode programs."""
    import torch

    def call(*args):
        with torch.inference_mode():
            return fn(*args)

    return call


# -- trainer steps ------------------------------------------------------------


def train_step_classifier(device: str, world) -> ProgramSpec:
    task = _classifier_task(device)
    _data_parallel(task, device, world)
    return ProgramSpec(
        name="train_step.classifier",
        fn=task.train_step,
        args=(_classifier_batch(device),),
        donated=_train_state(task),
        host_state=_adam_steps(task),
        warmup=_DDP_WARMUP,
    )


def train_step_classifier_health(device: str, world) -> ProgramSpec:
    """The health-supervised step: compute, judge, commit or discard —
    audited separately because the guard's signals and its buffer snapshot
    are a different program."""
    from ...resilience import health

    task = _classifier_task(device)
    _data_parallel(task, device, world)
    guarded = health.guard_train_step(task, health.HealthConfig())
    return ProgramSpec(
        name="train_step.classifier.health",
        fn=guarded,
        args=(health.HealthState.create(device), _classifier_batch(device),
              health.INJECT_NONE),
        donated=_train_state(task),
        host_state=_adam_steps(task),
        warmup=_DDP_WARMUP,
        # The verdict read is the step's one sync: on a card it runs under
        # sync-debug "warn", and the two suppressions below pin it to
        # exactly one scalar read and one synchronizing call — a second
        # sync changes both idents and fails the audit.
        sync_debug="warn",
        suppress={
            f"host-interop:{ident}": (
                "the guard reads its verdict on the host once a step to "
                "commit or discard (JAX's trainer reads the same verdict "
                "right after its program)")
            for ident in ("sync:aten._local_scalar_dense:1", "sync-debug:1")
        },
    )


def eval_step_classifier(device: str, world) -> ProgramSpec:
    task = _classifier_task(device)
    return ProgramSpec(
        name="eval_step.classifier",
        fn=task.eval_step,
        args=(_classifier_batch(device),),
    )


def train_step_lm(device: str, world) -> ProgramSpec:
    from ...parallel.trainer import LMTask

    task = LMTask(model=_lm_model(device), learning_rate=1e-3)
    _data_parallel(task, device, world)
    return ProgramSpec(
        name="train_step.lm",
        fn=task.train_step,
        args=({"tokens": _tokens((16, 32), device)},),
        donated=_train_state(task),
        host_state=_adam_steps(task),
        warmup=_DDP_WARMUP,
    )


def train_step_pipelined_lm(device: str, world) -> ProgramSpec:
    """The pipeline-parallel LM step on a 4-stage x 2-column grid of the
    audit's 8 ranks (this process is stage 0, column 0): its stage sends,
    receives and the column all-reduce are the collectives it pins."""
    import torch

    from ...models.pipelined_lm import PipelinedLM, PipelinedLMTask
    from ...parallel.pipeline import pipe_grid

    grid = pipe_grid(4)
    model = PipelinedLM(vocab_size=64, dim=32, num_heads=4, grid=grid,
                        max_seq=32, dtype=torch.float32, device=device)
    task = PipelinedLMTask(model)
    return ProgramSpec(
        name="train_step.pipelined_lm",
        fn=task.train_step,
        # [n_micro, micro_batch, seq]: the pipeline's microbatch layout.
        args=({"tokens": _tokens((4, 4, 16), device)},),
        donated=_train_state(task),
        host_state=_adam_steps(task),
    )


# -- LM decode + serving score ------------------------------------------------


def decode_step_lm(device: str, world) -> ProgramSpec:
    import torch

    from ...models.transformer import decode_step, init_kv_cache

    model = _lm_model(device).eval()
    cache = init_kv_cache(model, 8)
    return ProgramSpec(
        name="decode_step.lm",
        fn=_inference(decode_step),
        args=(model, _tokens((8, 1), device), cache,
              torch.zeros(8, dtype=torch.long, device=device)),
        donated=lambda: {f"cache:{i}:{k}": layer[k]
                         for i, layer in enumerate(cache) for k in layer},
    )


def slot_decode_lm(device: str, world) -> ProgramSpec:
    """The continuous-batching serving step: one token for every slot of
    the arena at a per-slot position. The donation pin is the point: the
    engine holds ONE arena for the life of the server, written in place."""
    import torch

    from ...serving.lm import kvcache

    model = _lm_model(device).eval()
    arena = kvcache.make_arena(model, 4, 32)
    return ProgramSpec(
        name="slot_decode.lm",
        fn=_inference(kvcache.slot_decode),
        args=(model, _tokens((4,), device), arena,
              torch.zeros(4, dtype=torch.long, device=device)),
        donated=lambda: {f"arena:{i}:{k}": layer[k]
                         for i, layer in enumerate(arena) for k in layer},
    )


def prefill_lm(device: str, world) -> ProgramSpec:
    """One bucketed prefill (the canonical 16-token bucket) into the
    single-sequence cache the engine recycles across admissions."""
    from ...serving.lm import kvcache

    model = _lm_model(device).eval()
    cache = kvcache.make_arena(model, 1, 32)
    return ProgramSpec(
        name="prefill.lm",
        fn=_inference(kvcache.prefill_bucket),
        args=(model, _tokens((1, 16), device), cache),
        donated=lambda: {f"cache:{i}:{k}": layer[k]
                         for i, layer in enumerate(cache) for k in layer},
    )


def serving_score(device: str, world) -> ProgramSpec:
    from ...config.checkpoints import make_scorer

    task = _classifier_task(device)
    return ProgramSpec(
        name="serving.score",
        fn=make_scorer(task),
        args=(_classifier_batch(device)["image"],),
    )


# -- fused ops ----------------------------------------------------------------


def fused_matmul_grad(device: str, world) -> ProgramSpec:
    """``bn_relu_matmul`` forward and backward (K1, then K2 and K3 on a
    card) at JAX's audit shape, M 512 and K = N = 128."""
    import torch

    from ...ops import fused_matmul as fm

    dtype = _kernel_dtype(device)
    g = _generator()
    k = 128
    y = torch.randn(512, k, generator=g).to(device, dtype).requires_grad_()
    y32 = y.detach().float()
    mean, var = y32.mean(0), y32.var(0, unbiased=False)
    gamma = (1 + 0.1 * torch.randn(k, generator=g)).to(device).requires_grad_()
    beta = (0.1 * torch.randn(k, generator=g)).to(device).requires_grad_()
    w = (torch.randn(k, k, generator=g) / k ** 0.5).to(device, dtype).requires_grad_()

    def value_and_grad(y, gamma, beta, mean, var, w):
        loss = fm.bn_relu_matmul(y, gamma, beta, mean, var, w).float().sum()
        return loss.detach(), torch.autograd.grad(loss, (y, gamma, beta, w))

    return ProgramSpec(
        name="ops.fused_matmul.grad",
        fn=value_and_grad,
        args=(y, gamma, beta, mean, var, w),
        launches={
            "K1": lambda: fm.bn_relu_matmul_fwd.launches,
            "K2": lambda: fm.bn_relu_matmul_bwd_da.launches,
            "K3": lambda: fm.bn_relu_matmul_bwd_dw.launches,
        },
    )


def fused_norm_grad(device: str, world) -> ProgramSpec:
    import torch

    from ...ops.fused_norm import bn_act

    g = _generator()
    x = torch.randn(256, 64, generator=g).to(device).requires_grad_()
    scale = torch.ones(64, device=device, requires_grad=True)
    bias = torch.zeros(64, device=device, requires_grad=True)

    def value_and_grad(x, scale, bias):
        out, _mean, _var = bn_act(x, scale, bias, relu=True)
        loss = out.sum()
        return loss.detach(), torch.autograd.grad(loss, (x, scale, bias))

    return ProgramSpec(
        name="ops.fused_norm.grad",
        fn=value_and_grad,
        args=(x, scale, bias),
    )


def flash_attention_grad(device: str, world) -> ProgramSpec:
    """Causal flash attention forward (K4 on a card) and its chunked
    recompute backward, ``[b 2, heads 2, seq 128, head_dim 32]``."""
    import torch

    from ...ops.flash_attention import flash_attention

    dtype = _kernel_dtype(device)
    g = _generator()
    q, k, v = (torch.randn(2, 2, 128, 32, generator=g).to(device, dtype)
               .requires_grad_() for _ in range(3))

    def value_and_grad(q, k, v):
        loss = flash_attention(q, k, v, causal=True).float().sum()
        return loss.detach(), torch.autograd.grad(loss, (q, k, v))

    return ProgramSpec(
        name="ops.flash_attention.grad",
        fn=value_and_grad,
        args=(q, k, v),
        launches={"K4": lambda: flash_attention.launches},
        # bf16 on a card: the operands' and the cotangent's f32 round
        # trips of the plain recompute backward.
        cast_budget=12,
    )


# -- batched SARIMAX fitter ---------------------------------------------------


def sarimax_batched_fit(device: str, world) -> ProgramSpec:
    """The grid-fused group fit: 4 groups x the full 8-order grid of a
    (1, 1, 1) bound with one regressor, 12 weeks, in one batched
    ``sarimax_fit`` (its lanes, three starting points each), at a cut
    iteration count: the audit reads the program's structure, which the
    iteration count only repeats."""
    import torch

    from ...ops.sarimax import SarimaxConfig, grid_orders, sarimax_fit

    cfg = SarimaxConfig(max_p=1, max_d=1, max_q=1, k_exog=1, max_iter=2,
                        bfgs_iter=1)
    g = _generator()
    groups, weeks = 4, 12
    y = (10 + torch.randn(groups, 1, weeks, generator=g).cumsum(-1)).to(device)
    exog = torch.randn(groups, 1, weeks, 1, generator=g).to(device)
    orders = torch.as_tensor(grid_orders(cfg), device=device)[None]
    return ProgramSpec(
        name="sarimax.batched_fit",
        fn=lambda y, exog, orders: sarimax_fit(cfg, y, exog, orders),
        args=(y, exog, orders),
        # A batch job, not a latency path: the fit's BFGS state machine
        # reads its lanes' convergence on the host once a round, so it is
        # declared cold (no host-interop check, no sync-debug).
        hotpath=False,
        cast_budget=96,
    )


# -- the registry -------------------------------------------------------------

_BUILDERS: dict[str, Callable] = {
    "train_step.classifier": train_step_classifier,
    "train_step.classifier.health": train_step_classifier_health,
    "eval_step.classifier": eval_step_classifier,
    "train_step.lm": train_step_lm,
    "train_step.pipelined_lm": train_step_pipelined_lm,
    "decode_step.lm": decode_step_lm,
    "slot_decode.lm": slot_decode_lm,
    "prefill.lm": prefill_lm,
    "serving.score": serving_score,
    "ops.fused_matmul.grad": fused_matmul_grad,
    "ops.fused_norm.grad": fused_norm_grad,
    "ops.flash_attention.grad": flash_attention_grad,
    "sarimax.batched_fit": sarimax_batched_fit,
}


def builders() -> Mapping[str, Callable]:
    return dict(_BUILDERS)


def entrypoint_names() -> list[str]:
    return sorted(_BUILDERS)
