"""Single-card trainer: the port of ``dss_ml_at_scale_tpu/parallel/trainer.py``
cut to the training slice.

``ClassifierTask`` is the JAX task: Adam at 1e-5 by default, softmax
cross-entropy, top-1 accuracy (and top-k on eval); uint8 images are
normalized inside the step and NCHW input is transposed to NHWC.
``optax.adam(lr)`` and ``torch.optim.Adam(lr, betas=(0.9, 0.999),
eps=1e-8)`` compute the same update: both divide the bias-corrected first
moment by the square root of the bias-corrected second moment plus eps.

``Trainer.fit`` keeps the reference's epoch semantics: an infinite reader,
``steps_per_epoch = rows // batch``, eval each epoch capped at
``limit_val_batches``, per-epoch throughput. Each epoch's summary also
carries the steady throughput after the first step (the first step builds
the kernels and warms the convolution and allocator caches; the trainer
synchronizes once after it) and the data wait of the steps that follow it.

Not ported yet: checkpoint/resume with manifests, the health supervisor,
preemption, tracking, profiling windows, and data parallelism (DDP with BN
sums all-reduced across ranks, and ZeRO-1).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from ..data.prefetch import Feeder
from ..data.transform import IMAGENET_MEAN, IMAGENET_STD
from ..models.metrics import cross_entropy_loss, multiclass_accuracy, topk_accuracy
from ..utils.profiling import StepTimer

log = logging.getLogger(__name__)

Batch = Mapping[str, Any]


@dataclasses.dataclass
class ClassifierTask:
    """Image classification: a ResNet and its optimizer.

    Batches carry ``image`` (NHWC or NCHW, float or uint8) and ``label``
    (int) tensors on the model's device.
    """

    model: torch.nn.Module
    learning_rate: float = 1e-5
    eval_topk: tuple = ()
    optimizer: torch.optim.Optimizer = dataclasses.field(init=False)

    def __post_init__(self):
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)

    def images(self, batch: Batch) -> torch.Tensor:
        x = batch["image"]
        if x.ndim == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
            x = x.permute(0, 2, 3, 1).contiguous()  # NCHW -> NHWC
        if x.dtype == torch.uint8:
            mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
            std = torch.as_tensor(IMAGENET_STD, device=x.device)
            x = (x.float() / 255.0 - mean) / std
        return x

    def train_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        """One Adam step; metrics are 0-d tensors (no host sync)."""
        images, labels = self.images(batch), batch["label"].long()
        self.model.train()
        logits = self.model(images)
        loss = cross_entropy_loss(logits, labels)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        norms = [torch.linalg.vector_norm(p.grad.float())
                 for p in self.model.parameters() if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(norms))  # optax.global_norm
        self.optimizer.step()
        return {
            "train_loss": loss.detach(),
            "train_acc": multiclass_accuracy(logits.detach(), labels),
            "grad_norm": grad_norm,
        }

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> dict[str, torch.Tensor]:
        images, labels = self.images(batch), batch["label"].long()
        self.model.eval()
        logits = self.model(images)
        out = {
            "val_loss": cross_entropy_loss(logits, labels),
            "val_acc": multiclass_accuracy(logits, labels),
        }
        for k in self.eval_topk:
            out[f"val_top{k}_acc"] = topk_accuracy(logits, labels, k)
        return out


@dataclasses.dataclass
class TrainerConfig:
    total_train_rows: int                    # steps per epoch = rows // batch
    max_epochs: int = 2                      # reference MAX_EPOCHS
    limit_val_batches: int | None = 5
    log_every_steps: int = 10
    feeder_depth: int = 2


@dataclasses.dataclass
class FitResult:
    steps: int
    history: list[dict]


class Trainer:
    """Explicit epoch/step loop on one device."""

    def __init__(self, config: TrainerConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)

    def _steps_per_epoch(self, batch_size: int) -> int:
        steps = self.config.total_train_rows // batch_size
        if steps == 0:
            raise ValueError(
                f"total_train_rows={self.config.total_train_rows} < batch {batch_size}; "
                "no full step per epoch"
            )
        return steps

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        task: ClassifierTask,
        train_data: Iterable[Mapping[str, np.ndarray]],
        val_data_factory: Callable[[], Iterable[Mapping[str, np.ndarray]]] | None = None,
    ) -> FitResult:
        cfg = self.config
        train_iter = iter(train_data)
        first = next(train_iter)
        batch_size = len(next(iter(first.values())))
        steps_per_epoch = self._steps_per_epoch(batch_size)
        feeder = Feeder(itertools.chain([first], train_iter), self.device,
                        depth=cfg.feeder_depth, name="train")
        history: list[dict] = []
        step = 0
        try:
            for epoch in range(cfg.max_epochs):
                t0 = time.perf_counter()
                wait0 = feeder.wait_seconds
                timer = StepTimer()
                epoch_steps, metrics = 0, {}
                t_first = wait_first = None
                while epoch_steps < steps_per_epoch:
                    try:
                        batch = next(feeder)
                    except StopIteration:
                        break
                    metrics = task.train_step(batch)
                    epoch_steps += 1
                    step += 1
                    timer.tick()
                    if epoch_steps == 1:
                        self._sync()
                        t_first, wait_first = time.perf_counter(), feeder.wait_seconds
                    if step % cfg.log_every_steps == 0:
                        log.info("step %d: %s", step, {k: float(v) for k, v in metrics.items()})
                if epoch_steps == 0:
                    log.warning("train data exhausted at step %d", step)
                    break
                self._sync()
                t_end = time.perf_counter()
                summary = {
                    "epoch": epoch,
                    "steps": epoch_steps,
                    "epoch_time_s": t_end - t0,
                    "images_per_sec": epoch_steps * batch_size / (t_end - t0),
                    "data_wait_s": feeder.wait_seconds - wait0,
                    **timer.summary(),
                    **{k: float(v) for k, v in metrics.items()},
                }
                if epoch_steps > 1:
                    steady = t_end - t_first
                    summary.update(
                        steady_images_per_sec=(epoch_steps - 1) * batch_size / steady,
                        steady_step_time_s=steady / (epoch_steps - 1),
                        steady_data_wait_s=(feeder.wait_seconds - wait_first) / (epoch_steps - 1),
                    )
                if val_data_factory is not None:
                    summary.update(self._evaluate(task, val_data_factory))
                history.append(summary)
                log.info("epoch %d: %s", epoch, summary)
                if epoch_steps < steps_per_epoch:
                    log.warning("train data exhausted at step %d", step)
                    break
        finally:
            feeder.close()
        return FitResult(steps=step, history=history)

    def _evaluate(self, task: ClassifierTask, val_data_factory) -> dict:
        totals: dict[str, float] = {}
        count = 0
        val_data = val_data_factory()
        source = iter(val_data)
        if self.config.limit_val_batches is not None:
            # Limit before the feeder, so no extra batch is decoded.
            source = itertools.islice(source, self.config.limit_val_batches)
        feeder = Feeder(source, self.device, depth=self.config.feeder_depth, name="eval")
        try:
            for batch in feeder:
                for k, v in task.eval_step(batch).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
        finally:
            feeder.close()
            stop = getattr(val_data, "stop", None)
            if callable(stop):
                stop()
        return {k: v / max(count, 1) for k, v in totals.items()}
