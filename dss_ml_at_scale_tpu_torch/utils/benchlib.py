"""Shared benchmark scaffolding: model/task construction, synthetic batches,
and the timing method.

Port of ``dss_ml_at_scale_tpu/utils/benchlib.py``. The sync discipline is
JAX's: a timing window ends by fetching a scalar that depends on the last
step (``.item()`` of its loss). On a card the steps only queue kernels, so
a window without that read times the host's dispatch rate, not the card.
"""

from __future__ import annotations

import time


def build_resnet_task(num_classes: int, on_accel: bool,
                      learning_rate: float = 1e-5, fused_bn=True,
                      device: str = "cuda"):
    """Benchmark ResNet-50 as a ``ClassifierTask`` on ``device``: full-size
    bf16 on a card, a small f32 stand-in (8 filters) on the CPU, where the
    number is a harness check, not a result. ``fused_bn`` takes the
    ResNet's levels (False, True, or "pallas": the K1-K3 kernels), seed-0
    weights as ``train`` builds them."""
    import torch

    from ..models.convert import seeded_resnet
    from ..models.resnet import BottleneckBlock
    from ..parallel.trainer import ClassifierTask

    config = dict(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock,
                  num_classes=num_classes, fused_bn=fused_bn)
    if not on_accel:
        config.update(num_filters=8, dtype=torch.float32)
    model = seeded_resnet(0, device=device, **config)
    return ClassifierTask(model=model, learning_rate=learning_rate)


def dp_sharded_step(task, batch_per_rank: int, image: int, num_classes: int,
                    device: str = "cuda"):
    """(step, batch) for data parallelism over the port's process group:
    the task's model wrapped by the trainer's own ``data_parallel`` (DDP
    when the group has more than one rank), and this rank's synthetic batch
    on ``device``. Join the group first (``runtime.initialize_distributed``);
    alone, the step is the one-process step."""
    from ..parallel.trainer import Trainer, TrainerConfig

    Trainer(TrainerConfig(), device=device).data_parallel(task)
    batch = synthetic_image_batch(batch_per_rank, image, num_classes=num_classes)
    return task.train_step, _to_device(batch, device)


def _to_device(batch: dict, device: str) -> dict:
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def synthetic_image_batch(batch: int, image: int, num_classes: int,
                          seed: int = 0) -> dict:
    """Host batch of numpy arrays, JAX's generator draw for draw: the
    arrays equal the JAX package's for the same arguments."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(batch, image, image, 3)).astype(np.float32),
        "label": rng.integers(0, num_classes, batch).astype(np.int32),
    }


def synthetic_image_batch_device(batch: int, image: int, num_classes: int,
                                 seed: int = 0, device: str = "cuda") -> dict:
    """Synthetic batch generated ON ``device`` with an explicit
    ``torch.Generator`` of ``seed``: no host-to-device copy of the images
    enters a compute benchmark. (The draws are torch's, not JAX's.)"""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {
        "image": torch.randn((batch, image, image, 3), generator=gen,
                             device=device, dtype=torch.float32),
        "label": torch.randint(0, num_classes, (batch,), generator=gen,
                               device=device, dtype=torch.int32),
    }
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out


def timed_train_steps(step_fn, batch, steps: int,
                      loss_key: str = "train_loss", warmup: int = 2) -> float:
    """Seconds for ``steps`` chained calls of ``step_fn(batch)`` after
    ``warmup`` of them. The task holds its own state, so where JAX threads
    and returns the state this returns the seconds alone.

    The window ends with a host read of the last step's loss: the read
    waits for every kernel the steps queued."""
    metrics = None
    for _ in range(warmup):
        metrics = step_fn(batch)
    if metrics is not None:
        metrics[loss_key].item()

    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step_fn(batch)
    metrics[loss_key].item()
    return time.perf_counter() - t0
