"""Bitwise replay of ``train`` and the device monitor, on the card.

Needs an NVIDIA card; every test skips without one. Like
``tests/test_torch_cuda_kernels.py`` it imports no JAX and runs there
without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_replay.py

- The chaos soak's ``train`` argv (``--model tiny``, ``--workers 1
  --no-shuffle``, no augmentation), run twice for 2 epochs, leaves
  checkpoints with the same digest (the soak's ``params_bitwise_equal``
  probe: every tensor's bytes), and the same steps taken in one process
  twice give the same parameters after every step.
- ``DeviceMonitor`` reports what the allocator reports.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def chaos_data(tmp_path):
    from dss_ml_at_scale_tpu_torch.datagen.images import write_image_delta

    write_image_delta(tmp_path / "data", 48, classes=4, size=32, seed=0, mode="overwrite")
    return tmp_path / "data"


def test_train_replays_bitwise_on_the_card(cuda, chaos_data, tmp_path):
    from dss_ml_at_scale_tpu_torch.resilience.chaos import _tree_digest

    digests = []
    for run in ("a", "b"):
        ckpt = tmp_path / f"ckpt_{run}"
        proc = subprocess.run(
            [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli", "train",
             "--data", str(chaos_data), "--model", "tiny", "--num-classes", "4",
             "--crop", "32", "--batch-size", "16", "--epochs", "2", "--learning-rate", "0.01",
             "--workers", "1", "--no-shuffle", "--checkpoint-dir", str(ckpt),
             "--tracking-root", str(tmp_path / "runs"), "--device", "cuda"],
            cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)}, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        digests.append(_tree_digest(ckpt))
    assert digests[0] == digests[1] and digests[0][0] == 6


def test_every_step_replays_bitwise_in_one_process(cuda, chaos_data):
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.data import batch_loader
    from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask
    from dss_ml_at_scale_tpu_torch.parallel.trainer import _deterministic_kernels

    _deterministic_kernels(torch.device("cuda"))
    spec = imagenet_transform_spec(crop=32)
    with batch_loader(str(chaos_data), batch_size=16, num_epochs=None, workers_count=1,
                      transform_spec=spec, shuffle_row_groups=False) as reader:
        it = iter(reader)
        batches = [{k: torch.from_numpy(v.copy()) for k, v in next(it).items()}
                   for _ in range(6)]
    runs = []
    for _ in range(2):
        model = build_classifier_model("tiny", num_classes=4, torch_padding=False,
                                       fused_bn=True, device="cuda", crop=32)
        task = ClassifierTask(model=model, learning_rate=0.01)
        states = []
        for b in batches:
            task.train_step({k: v.cuda() for k, v in b.items()})
            states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        runs.append(states)
    for step, (a, b) in enumerate(zip(*runs), start=1):
        assert all(torch.equal(a[k], b[k]) for k in a), f"parameters part at step {step}"


def test_device_monitor_reports_the_allocator(cuda):
    from dss_ml_at_scale_tpu_torch.telemetry import MetricsRegistry
    from dss_ml_at_scale_tpu_torch.telemetry.device import DeviceMonitor

    registry = MetricsRegistry()
    x = torch.empty(64, 1024, 1024, device="cuda")  # 256 MiB
    monitor = DeviceMonitor(registry, devices=["cuda:0", "cpu"])
    monitor.sample()

    def gauge(name, device="cuda:0"):
        return registry.gauge(name, labels=("device",)).labels(device=device).value

    assert gauge("device_memory_stats_supported") == 1.0
    assert gauge("device_memory_stats_supported", "cpu:0") == 0.0
    assert gauge("device_hbm_bytes_in_use") == torch.cuda.memory_allocated(0)
    assert gauge("device_hbm_bytes_peak") == torch.cuda.max_memory_allocated(0)
    assert gauge("device_hbm_bytes_limit") == torch.cuda.mem_get_info(0)[1]
    assert gauge("device_live_buffers") >= 1
    del x
