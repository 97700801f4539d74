"""The port's ViT against the JAX package's flax ViT.

- ``vit-tiny`` (patch 8, dim 32, depth 2, heads 2, crop 32) on the same
  numpy weights: logits in f32 at 1e-5, in bf16 (f32 params, bf16
  compute, f32 head) at 2e-2 of max-abs; the geometry errors; the presets.
- Three ``ClassifierTask`` Adam steps against JAX's ``ClassifierTask``
  under ``optax.adam``, by the rules of ``tests/test_torch_train.py``
  (metrics rtol 1e-5 each step, Adam's moments within 5e-4 of max-abs,
  the parameters within 1e-3 of lr per step taken).
- Torchvision layout across packages: the port's ``export_torchvision``
  read by JAX's ``load_pretrained_vit`` gives JAX's forward equal to the
  port's, and JAX's export read by the port's ``load_pretrained_vit``;
  a live torch module in torchvision's ``VisionTransformer`` layout
  (``nn.MultiheadAttention``'s fused ``in_proj``) loads and matches; the
  head and resolution rules.
- The seeded init draws flax's kinds; ``train --model vit-tiny`` on the
  CPU, ``--pretrained`` from the checkpoint's export starts from its
  weights, and the checkpoint serves (``tests/test_serving.py:216``),
  scored only at its training crop.
"""

import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dss_ml_at_scale_tpu.models import ViT as JaxViT
from dss_ml_at_scale_tpu.models import pretrained as jax_pretrained
from dss_ml_at_scale_tpu.parallel.trainer import ClassifierTask as JaxTask
from dss_ml_at_scale_tpu_torch.config import cli
from dss_ml_at_scale_tpu_torch.models import (
    ViT,
    export_torchvision,
    init_vit_state,
    load_pretrained_vit,
    seeded_vit,
    vit_s16,
    vit_state_from_flax,
    vit_t16,
)
from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

TINY = dict(patch=8, dim=32, depth=2, num_heads=2)
CROP, CLASSES = 32, 4


def _images(n=2, crop=CROP, seed=0):
    return np.random.default_rng(seed).normal(size=(n, crop, crop, 3)).astype(np.float32)


def _pair(dtype=jnp.float32, tdtype=torch.float32, seed=0):
    jm = JaxViT(num_classes=CLASSES, dtype=dtype, **TINY)
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(seed), jnp.zeros((1, CROP, CROP, 3))))
    # Nonzero cls token and biases, non-unit LayerNorm scales: every
    # parameter moves the output.
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0.0, 0.05, a.shape)).astype(np.float32), variables)
    tm = ViT(CLASSES, image_size=CROP, dtype=tdtype, device="cpu", **TINY)
    tm.load_state_dict(vit_state_from_flax(variables))
    return jm, variables, tm


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_f32_logits_match_flax():
    jm, variables, tm = _pair()
    x = _images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bf16_logits_match_flax():
    jm, variables, tm = _pair(jnp.bfloat16, torch.bfloat16)
    x = _images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the head is an f32 product
    assert _rel(got.numpy(), want) < 2e-2


def test_geometry_errors():
    tm = ViT(CLASSES, image_size=CROP, device="cpu", **TINY)
    with pytest.raises(ValueError, match="not divisible"):
        tm(torch.zeros(1, 36, 36, 3))
    with pytest.raises(ValueError, match="position table"):
        tm(torch.zeros(1, 40, 40, 3))
    with pytest.raises(ValueError, match="not divisible"):
        ViT(CLASSES, image_size=36, device="cpu", **TINY)


def test_preset_geometries():
    t, s = vit_t16(10, device="meta"), vit_s16(10, device="meta")
    assert (t.dim, t.depth, t.num_heads, t.patch) == (192, 12, 3, 16)
    assert (s.dim, s.depth, s.num_heads, s.patch) == (384, 12, 6, 16)
    assert s.pos_embed.shape == (1, 197, 384)
    # ~5.7M and ~22M parameters at 1000 classes, as the JAX docstrings.
    for fn, want in ((vit_t16, 5.7e6), (vit_s16, 22e6)):
        n = sum(p.numel() for p in fn(1000, device="meta").parameters())
        assert abs(n / want - 1) < 0.05, (fn.__name__, n)


@pytest.fixture(scope="module")
def stepped():
    lr, steps = 1e-3, 3
    jm, variables, tm = _pair(seed=1)
    jtask = JaxTask(model=jm, tx=optax.adam(lr))
    state = jtask.state_from_variables(variables)
    ttask = ClassifierTask(model=tm, learning_rate=lr)
    train_step = jax.jit(jtask.train_step)
    out = {"metrics": [], "params": []}
    for i in range(steps):
        images = _images(4, seed=10 + i)
        labels = np.array([0, 1, 2, 3], np.int32)
        state, jmetrics = train_step(state, {"image": images, "label": labels})
        tmetrics = ttask.train_step({"image": torch.from_numpy(images),
                                     "label": torch.from_numpy(labels)})
        out["metrics"].append((jmetrics, tmetrics))
    out["grads"] = {n: p.grad.clone() for n, p in tm.named_parameters()}
    out.update(state=state, ttask=ttask, tm=tm, steps=steps, lr=lr)
    return out


def test_classifier_steps_metrics_match_optax(stepped):
    for jm, tm in stepped["metrics"]:
        for key in ("train_loss", "train_acc", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)


def test_classifier_steps_moments_and_params_match_optax(stepped):
    state, lr = stepped["state"], stepped["lr"]
    adam = state.opt_state[0]
    mu = vit_state_from_flax(jax.tree_util.tree_map(np.asarray, adam.mu))
    nu = vit_state_from_flax(jax.tree_util.tree_map(np.asarray, adam.nu))
    want = vit_state_from_flax(jax.tree_util.tree_map(np.asarray, state.params))
    opt = stepped["ttask"].optimizer
    for name, p in stepped["tm"].named_parameters():
        if name.endswith(".k.bias"):
            # A key bias adds one constant to every score of a query: the
            # softmax cancels it, so its gradient is rounding noise in both
            # frameworks (and Adam turns that noise into lr-sized steps).
            continue
        st = opt.state[p]
        for got, ref in ((st["exp_avg"], mu[name]), (st["exp_avg_sq"], nu[name])):
            err = (got - ref).abs().max().item() / (ref.abs().max().item() + 1e-30)
            assert err < 5e-4, f"{name}: moment rel err {err}"
        g = stepped["grads"][name]
        sure = g.abs() > 1e-3 * g.abs().max()
        ulp = 2 * torch.finfo(torch.float32).eps * want[name].abs()
        err = (p.detach() - want[name]).abs() - ulp * stepped["steps"]
        assert (err <= 1e-3 * lr * stepped["steps"])[sure].all(), name


def _mini_torchvision_vit(num_classes=6, image=CROP, seed=0):
    """A live torch module with torchvision ``VisionTransformer``'s keys
    and forward (fused ``in_proj`` attention, ``mlp.0``/``mlp.3``), written
    apart from the converter."""
    nn = torch.nn
    torch.manual_seed(seed)
    dim, patch, heads, depth = 32, 8, 2, 2
    n = (image // patch) ** 2

    class MiniViT(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv_proj = nn.Conv2d(3, dim, patch, stride=patch)
            self.class_token = nn.Parameter(torch.randn(1, 1, dim) * 0.02)
            self.encoder = nn.Module()
            self.encoder.pos_embedding = nn.Parameter(torch.randn(1, n + 1, dim) * 0.02)
            self.encoder.layers = nn.Module()
            for i in range(depth):
                blk = nn.Module()
                blk.ln_1 = nn.LayerNorm(dim, eps=1e-6)
                blk.self_attention = nn.MultiheadAttention(dim, heads, batch_first=True)
                blk.ln_2 = nn.LayerNorm(dim, eps=1e-6)
                blk.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(), nn.Dropout(0.0),
                                        nn.Linear(4 * dim, dim), nn.Dropout(0.0))
                setattr(self.encoder.layers, f"encoder_layer_{i}", blk)
            self.encoder.ln = nn.LayerNorm(dim, eps=1e-6)
            self.heads = nn.Module()
            self.heads.head = nn.Linear(dim, num_classes)

        def forward(self, x):  # [b, 3, h, w]
            x = self.conv_proj(x).flatten(2).transpose(1, 2)
            x = torch.cat([self.class_token.expand(x.shape[0], -1, -1), x], dim=1)
            x = x + self.encoder.pos_embedding
            for i in range(depth):
                blk = getattr(self.encoder.layers, f"encoder_layer_{i}")
                h = blk.ln_1(x)
                x = x + blk.self_attention(h, h, h, need_weights=False)[0]
                x = x + blk.mlp(blk.ln_2(x))
            return self.heads.head(self.encoder.ln(x)[:, 0])

    return MiniViT().eval()


def test_torchvision_layout_loads_and_matches_torch(tmp_path):
    ref_model = _mini_torchvision_vit()
    torch.save(ref_model.state_dict(), tmp_path / "vit.pt")
    x = _images()
    with torch.no_grad():
        want = ref_model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    tm = ViT(6, image_size=CROP, dtype=torch.float32, device="cpu", **TINY)
    load_pretrained_vit(tmp_path / "vit.pt", tm)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)
    # And back out: the export is the file's tensors.
    out = export_torchvision(tm, tmp_path / "back.npz")
    for k, v in ref_model.state_dict().items():
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)


def test_head_and_resolution_rules(tmp_path):
    torch.save(_mini_torchvision_vit(num_classes=6).state_dict(), tmp_path / "vit.pt")
    tm = ViT(11, image_size=CROP, device="cpu", **TINY)
    fresh = tm.head.weight.detach().clone()
    load_pretrained_vit(tmp_path / "vit.pt", tm)
    assert torch.equal(tm.head.weight, fresh)  # another class count: the head stays
    with pytest.raises(ValueError, match="pos_embedding"):
        load_pretrained_vit(tmp_path / "vit.pt", ViT(6, image_size=64, device="cpu", **TINY))


def test_port_export_loads_into_jax(tmp_path):
    jm, _, _ = _pair()
    tm = seeded_vit(3, device="cpu", num_classes=CLASSES, image_size=CROP,
                    dtype=torch.float32, **TINY)
    export_torchvision(tm, tmp_path / "port.npz")
    variables = jax_pretrained.load_pretrained_vit(tmp_path / "port.npz", jm, image_size=CROP)
    x = _images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_jax_export_loads_into_the_port(tmp_path):
    jm, variables, _ = _pair(seed=2)
    jax_pretrained.export_torchvision(variables, jm, tmp_path / "jax.npz")
    tm = ViT(CLASSES, image_size=CROP, dtype=torch.float32, device="cpu", **TINY)
    loaded = load_pretrained_vit(tmp_path / "jax.npz", tm)
    for name, value in vit_state_from_flax(variables).items():
        np.testing.assert_array_equal(loaded[name], value, err_msg=name)
    x = _images()
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, atol=1e-5,
                                   rtol=1e-5)


def test_seeded_init_draws_flax_kinds():
    tm = ViT(10, image_size=64, dim=64, depth=1, num_heads=2, patch=8, device="cpu")
    state = init_vit_state(tm, 0)
    assert not state["cls_token"].any()
    assert abs(float(state["pos_embed"].std()) / 0.02 - 1) < 0.05
    for name in ("blocks.0.ln_attn.weight", "ln_final.weight"):
        assert torch.equal(state[name], torch.ones_like(state[name]))
    for name in ("blocks.0.q.bias", "blocks.0.ln_mlp.bias", "head.bias", "patch_embed.bias"):
        assert not state[name].any(), name
    # LeCun normal: std 1/sqrt(fan_in), fan_in = in (Dense), 8*8*3 (patch).
    for name, fan_in in (("blocks.0.mlp_in.weight", 64), ("blocks.0.mlp_out.weight", 256),
                         ("patch_embed.weight", 192)):
        assert abs(float(state[name].std()) * math.sqrt(fan_in) - 1) < 0.1, name
    assert torch.equal(init_vit_state(tm, 0)["blocks.0.q.weight"], state["blocks.0.q.weight"])


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0, buf.getvalue()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def vit_ckpt(tmp_path_factory):
    """``train --model vit-tiny`` on the CPU: 16 rows, 2 steps, a checkpoint."""
    from dss_ml_at_scale_tpu_torch.datagen.images import write_image_delta

    tmp_path = tmp_path_factory.mktemp("vit")
    write_image_delta(str(tmp_path / "t"), 16, classes=CLASSES, size=40, seed=0)
    common = ["--data", str(tmp_path / "t"), "--model", "vit-tiny", "--batch-size", "8",
              "--crop", str(CROP), "--num-classes", str(CLASSES), "--epochs", "1",
              "--device", "cpu", "--no-tracking", "--workers", "1"]
    summary = _run(["train", *common, "--checkpoint-dir", str(tmp_path / "ck")])
    return tmp_path, common, summary


def test_train_vit_tiny_and_pretrained_from_its_export(vit_ckpt):
    tmp_path, common, summary = vit_ckpt
    assert summary["steps"] == 2 and math.isfinite(summary["train_loss"])
    meta = json.loads((tmp_path / "ck" / "dsst_model.json").read_text())
    assert meta["model"] == "vit-tiny" and meta["crop"] == CROP
    out = _run(["export", "--checkpoint-dir", str(tmp_path / "ck"), "--out",
                str(tmp_path / "v.npz"), "--device", "cpu"])
    assert out["checkpoint_step"] == 2
    state = torch.load(tmp_path / "ck" / "2" / "state.pt", weights_only=True)["model"]
    tm = ViT(CLASSES, image_size=CROP, device="cpu", **TINY)
    loaded = load_pretrained_vit(tmp_path / "v.npz", tm)
    for name, value in state.items():
        assert torch.equal(loaded[name], value), name
    # At lr 0 the run keeps the weights it started from: the file's.
    summary = _run(["train", *common, "--pretrained", str(tmp_path / "v.npz"),
                    "--learning-rate", "0", "--checkpoint-dir", str(tmp_path / "ck2")])
    assert summary["steps"] == 2
    again = torch.load(tmp_path / "ck2" / "2" / "state.pt", weights_only=True)["model"]
    for name, value in state.items():
        assert torch.equal(again[name], value), name


def test_a_vit_checkpoint_serves_and_pins_its_crop(vit_ckpt):
    import http.client

    import pyarrow.parquet as pq

    from dss_ml_at_scale_tpu_torch.data import DeltaTable
    from dss_ml_at_scale_tpu_torch.workloads.serving import Predictor, serve_in_thread

    tmp_path, _, _ = vit_ckpt
    jpeg = pq.read_table(DeltaTable(str(tmp_path / "t")).file_uris()[0]).column("content")[0]
    with serve_in_thread(Predictor(str(tmp_path / "ck"), micro_batch=4, device="cpu")) as h:
        conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=30)
        conn.request("POST", "/predict", jpeg.as_py(), {"Content-Type": "image/jpeg"})
        resp = conn.getresponse()
        (pred,) = json.loads(resp.read())["predictions"]
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
    assert resp.status == 200 and 0 <= pred["pred_index"] < CLASSES
    assert health["model"] == "vit-tiny" and health["crop"] == CROP
    with pytest.raises(SystemExit, match="training crop"):
        cli.main(["predict", "--data", str(tmp_path / "t"), "--checkpoint-dir",
                  str(tmp_path / "ck"), "--out", str(tmp_path / "p"), "--crop", "64",
                  "--device", "cpu"])


def test_pallas_fused_refused_for_a_vit(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["train", "--data", str(tmp_path), "--model", "vit-tiny",
                       "--pallas-fused", "--device", "cpu", "--no-tracking"])
    assert rc == 1 and "bottleneck ResNets only" in buf.getvalue()
