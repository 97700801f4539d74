"""Checkpoints of the port: manifests, fallback, resume, best and retention.

The manifest format is the JAX package's (each side verifies the other's).
Training runs on the CPU: a tiny f32 TransformerLM on the port's token
source under a cosine schedule (a resume continues by step count on a fresh
stream, as the JAX trainer does: N/2 steps, a resume and N/2 more equal N/2
steps followed by N/2 steps of the stream from its start, bit for bit), and
a scripted task whose validation loss is a fixed function of the step count
(best selection, retention). The ``train`` command resumes the ResNet path
too, bit for bit where the JAX trainer guarantees it: no shuffle and a
table of whole epochs, resumed at an epoch boundary.
"""

import contextlib
import dataclasses
import io
import itertools
import json

import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.resilience import checkpoint as jax_integrity
from dss_ml_at_scale_tpu_torch import telemetry
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, token_batches
from dss_ml_at_scale_tpu_torch.models import seeded_lm
from dss_ml_at_scale_tpu_torch.parallel import (
    LMTask, Trainer, TrainerConfig, warmup_cosine_decay_schedule,
)
from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

STREAM = TokenStreamConfig(vocab_size=32, batch_size=4, seq_len=16, seed=3)
STEPS_PER_EPOCH = 3


def _step_dir(tmp_path, files):
    d = tmp_path / "7"
    (d / "sub").mkdir(parents=True)
    for name, data in files.items():
        (d / name).write_bytes(data)
    return d


@pytest.mark.parametrize("writer,reader", [(integrity, integrity), (jax_integrity, integrity),
                                           (integrity, jax_integrity)])
def test_manifest_written_verified_and_flags_corruption(tmp_path, writer, reader):
    d = _step_dir(tmp_path, {"state.pt": b"x" * 1000, "sub/m.json": b"{}"})
    assert reader.verify_step(d) == ("unverified", [])
    manifest = writer.write_manifest(d)
    assert set(manifest["files"]) == {"state.pt", "sub/m.json"}
    assert reader.verify_step(d) == ("intact", [])
    (d / "late.json").write_text("{}")  # written after the manifest: ignored
    assert reader.verify_step(d) == ("intact", [])
    raw = bytearray((d / "state.pt").read_bytes())
    raw[500] ^= 1
    (d / "state.pt").write_bytes(bytes(raw))
    status, problems = reader.verify_step(d)
    assert status == "corrupt" and "checksum" in problems[0]
    (d / "sub/m.json").unlink()
    assert any("missing" in p for p in reader.verify_step(d)[1])
    (d / integrity.MANIFEST_NAME).write_text("not json")
    assert reader.verify_step(d)[0] == "corrupt"


def test_list_verify_and_quarantine(tmp_path):
    for step in (3, 10):
        integrity.write_manifest(_step_dir(tmp_path, {"a": b"1"}).rename(tmp_path / str(step)))
    (tmp_path / "x").mkdir()
    assert integrity.list_steps(tmp_path) == [3, 10]
    assert [r["step"] for r in integrity.verify_checkpoint_dir(tmp_path)] == [10, 3]
    assert integrity.quarantine_step(tmp_path / "10").name == "10.corrupt"
    (tmp_path / "10").mkdir()
    assert integrity.quarantine_step(tmp_path / "10").name == "10.corrupt-1"
    assert integrity.list_steps(tmp_path) == [3]


def _lm_task():
    model = seeded_lm(0, device="cpu", vocab_size=32, dim=32, num_heads=2, num_layers=1,
                      max_seq=16, attention="flash", dtype=torch.float32)
    return LMTask(model=model, learning_rate=warmup_cosine_decay_schedule(1e-2, 2, 12))


def _fit_lm(ckpt, epochs, resume=False, task=None):
    task = task or _lm_task()
    trainer = Trainer(TrainerConfig(max_epochs=epochs, steps_per_epoch=STEPS_PER_EPOCH,
                                    limit_val_batches=1, checkpoint_dir=ckpt, resume=resume,
                                    keep_checkpoints=2), device="cpu")
    result = trainer.fit(task, token_batches(STREAM),
                         val_data_factory=lambda: token_batches(STREAM, 1, sample_seed=99))
    return task, result


def _assert_same_state(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key, value in st.items():
            assert torch.equal(value, sb["state"][i][key]), (i, key)
    assert a.scheduler.state_dict()["last_epoch"] == b.scheduler.state_dict()["last_epoch"]


def _steps_by_hand(task, n, losses=None):
    """``n`` train steps on the stream from its start, outside ``fit``."""
    for batch in itertools.islice(token_batches(STREAM), n):
        metrics = task.train_step({"tokens": torch.from_numpy(batch["tokens"])})
        if losses is not None:
            losses.append(metrics["train_loss"])
    return task


def test_resume_is_bit_for_bit(tmp_path):
    # The reference: 6 steps, then 6 steps of a fresh stream from its start.
    losses = []
    straight = _steps_by_hand(_steps_by_hand(_lm_task(), 6), 6, losses)
    _, r1 = _fit_lm(str(tmp_path), 2)
    assert r1.steps == 6 and integrity.list_steps(tmp_path) == [3, 6]
    resumed, r2 = _fit_lm(str(tmp_path), 4, resume=True)
    assert r2.steps == 12 and [h["epoch"] for h in r2.history] == [2, 3]
    _assert_same_state(straight, resumed)
    assert r2.history[-1]["train_loss"] == float(losses[-1])
    for step in integrity.list_steps(tmp_path):
        assert integrity.verify_step(tmp_path / str(step))[0] == "intact"


def _fallbacks() -> float:
    return sum(m["value"] for m in telemetry.snapshot()["metrics"]
               if m["name"] == "checkpoint_fallback_total")


def test_resume_falls_back_past_a_corrupt_newest_step(tmp_path):
    _fit_lm(str(tmp_path), 2)
    state = tmp_path / "6" / "state.pt"
    raw = bytearray(state.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    state.write_bytes(bytes(raw))
    before = _fallbacks()
    task, result = _fit_lm(str(tmp_path), 2, resume=True)
    assert _fallbacks() == before + 1
    # Restored step 3, re-ran step 4-6; the torn step 6 was moved aside.
    assert result.steps == 6 and [h["epoch"] for h in result.history] == [1]
    assert (tmp_path / "6.corrupt").is_dir()
    assert integrity.verify_step(tmp_path / "6")[0] == "intact"
    # The same as a run that never saw the torn step: step 3, then a resume
    # that takes a fresh stream.
    _fit_lm(str(tmp_path / "clean"), 1)
    clean, _ = _fit_lm(str(tmp_path / "clean"), 2, resume=True)
    _assert_same_state(task, clean)


def test_resume_with_every_step_corrupt_raises(tmp_path):
    _fit_lm(str(tmp_path), 1)
    (tmp_path / "3" / "state.pt").write_bytes(b"torn")
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        _fit_lm(str(tmp_path), 2, resume=True)


class _Counter(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.register_buffer("steps", torch.zeros((), dtype=torch.long))


@dataclasses.dataclass
class _ScriptedTask:
    """Validation loss LOSSES[step count]: the steps live in a buffer, so a
    checkpoint carries them."""

    model: torch.nn.Module = dataclasses.field(default_factory=_Counter)
    scheduler = None
    throughput_unit = "rows"
    default_best_metric = "val_loss"
    default_best_mode = "min"

    LOSSES = {2: 3.0, 4: 1.0, 6: 2.0, 8: 2.5, 10: 0.5}

    def __post_init__(self):
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=0.1)

    @staticmethod
    def batch_units(batch):
        return len(batch["x"])

    def train_step(self, batch):
        self.model.steps += 1
        return {"train_loss": torch.zeros(())}

    def eval_step(self, batch):
        return {"val_loss": torch.tensor(self.LOSSES[int(self.model.steps)])}


def _fit_scripted(ckpt, epochs, resume=False, val=True):
    trainer = Trainer(TrainerConfig(max_epochs=epochs, steps_per_epoch=2, checkpoint_dir=ckpt,
                                    resume=resume, limit_val_batches=1), device="cpu")
    batches = itertools.repeat({"x": np.zeros((2, 1), np.float32)})
    factory = (lambda: [{"x": np.zeros((2, 1), np.float32)}]) if val else None
    return trainer.fit(_ScriptedTask(), batches, val_data_factory=factory)


def test_best_by_val_loss_survives_resume_and_retention_keeps_two(tmp_path):
    r1 = _fit_scripted(str(tmp_path), 2)
    assert (r1.best_checkpoint_step, r1.best_metric_value) == (4, 1.0)
    r2 = _fit_scripted(str(tmp_path), 4, resume=True)
    # Steps 6 (2.0) and 8 (2.5) are worse than step 4's 1.0.
    assert r2.steps == 8
    assert (r2.best_checkpoint_step, r2.best_metric_value) == (4, 1.0)
    assert r2.best_checkpoint_path == str(tmp_path / "4")
    assert integrity.list_steps(tmp_path) == [4, 6]  # the two best; 2 and 8 pruned
    # Resume restores the newest step retention kept (6), not the pruned 8.
    r3 = _fit_scripted(str(tmp_path), 5, resume=True)
    assert r3.steps == 10 and [h["epoch"] for h in r3.history] == [3, 4]
    assert (r3.best_checkpoint_step, r3.best_metric_value) == (10, 0.5)
    assert integrity.list_steps(tmp_path) == [4, 10]


def test_retention_keeps_the_newest_two_without_eval(tmp_path):
    r = _fit_scripted(str(tmp_path), 4, val=False)
    assert r.steps == 8 and r.best_checkpoint_step is None
    assert integrity.list_steps(tmp_path) == [6, 8]
    meta = json.loads((tmp_path / "8" / "metrics.json").read_text())
    assert meta["epoch"] == 3 and meta["steps"] == 2


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_train_command_checkpoints_and_resumes_the_resnet(tmp_path):
    table, ckpt = str(tmp_path / "t"), str(tmp_path / "ckpt")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["datagen", "images", "--out", table, "--n", "16", "--classes", "4",
                         "--size", "32"]) == 0
    common = ["train", "--data", table, "--val-data", table, "--model", "tiny",
              "--batch-size", "8", "--crop", "32", "--num-classes", "4", "--device", "cpu",
              "--limit-val-batches", "1", "--workers", "1", "--checkpoint-dir", ckpt]
    s1 = _cli(common + ["--epochs", "1"])
    assert s1["steps"] == 2 and s1["best_checkpoint"] == str(tmp_path / "ckpt" / "2")
    s2 = _cli(common + ["--epochs", "2", "--resume"])
    assert s2["steps"] == 4 and s2["epochs"] == 1
    assert integrity.list_steps(ckpt) == [2, 4]
    assert all(integrity.verify_step(f"{ckpt}/{s}")[0] == "intact" for s in (2, 4))
    state = torch.load(f"{ckpt}/4/state.pt", weights_only=True)
    assert state["step"] == 4 and state["scheduler"] is None and "fc.weight" in state["model"]


def test_train_resume_at_an_epoch_boundary_is_bit_for_bit(tmp_path):
    """No shuffle and rows = steps x batch: every epoch reads the same
    batches, so a fresh stream at the boundary continues the run exactly."""
    table = str(tmp_path / "t")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["datagen", "images", "--out", table, "--n", "16", "--classes", "4",
                         "--size", "32"]) == 0
    common = ["train", "--data", table, "--model", "tiny", "--batch-size", "8", "--crop", "32",
              "--num-classes", "4", "--device", "cpu", "--workers", "1", "--no-shuffle",
              "--learning-rate", "1e-2"]
    straight = str(tmp_path / "straight")
    assert _cli(common + ["--epochs", "2", "--checkpoint-dir", straight])["steps"] == 4
    split = str(tmp_path / "split")
    assert _cli(common + ["--epochs", "1", "--checkpoint-dir", split])["steps"] == 2
    assert _cli(common + ["--epochs", "2", "--checkpoint-dir", split, "--resume"])["steps"] == 4
    a, b = (torch.load(f"{d}/4/state.pt", weights_only=True) for d in (straight, split))
    for name, x in a["model"].items():
        assert torch.equal(x, b["model"][name]), name
    for i, st in a["optimizer"]["state"].items():
        for key, value in st.items():
            assert torch.equal(value, b["optimizer"]["state"][i][key]), (i, key)
    assert a["metrics"]["train_loss"] == b["metrics"]["train_loss"]


def test_lm_command_resumes_from_the_persisted_schedule(tmp_path):
    common = ["lm", "--vocab", "32", "--dim", "32", "--heads", "2", "--layers", "1",
              "--seq", "16", "--batch-size", "4", "--steps-per-epoch", "3",
              "--limit-val-batches", "1", "--device", "cpu",
              "--checkpoint-dir", str(tmp_path)]
    s1 = _cli(common + ["--epochs", "2", "--lr-schedule", "cosine"])
    assert s1["steps"] == 6 and s1["lr_schedule"] == "cosine"
    meta = json.loads((tmp_path / "dsst_lm.json").read_text())
    assert meta == {"lr_schedule": "cosine", "warmup_steps": 1, "decay_steps": 6}
    s2 = _cli(common + ["--epochs", "3", "--resume"])  # flag-less: the trained curve
    assert s2["steps"] == 9 and s2["lr_schedule"] == "cosine"
    assert json.loads((tmp_path / "dsst_lm.json").read_text()) == meta


def test_a_fresh_run_never_overwrites_a_step(tmp_path):
    _fit_scripted(str(tmp_path), 1)
    with pytest.raises(FileExistsError, match="already exists"):
        _fit_scripted(str(tmp_path), 1)
    assert integrity.list_steps(tmp_path) == [2]
    assert [p.name for p in tmp_path.iterdir()] == ["2"]  # no temporary left
