"""The port's on-device augmentation vs the JAX package's
(``data/augment.py``).

The draws come from the port's numpy threefry2x32 and must equal
``jax.random``'s on this machine bit for bit: ``key``, ``fold_in``,
``split``, ``bits``, ``uniform`` and ``bernoulli``, with the JAX installed
here (partitionable threefry). The box math follows XLA's float32
arithmetic on the CPU (``exp`` and ``log`` as XLA computes them), so the
boxes are bit-equal too.

The crop (``jax.image.scale_and_translate``'s antialiased bilinear
weights, applied as two products): each weight matrix within 1e-5 of
JAX's; the crop of decoded JPEG gratings (the inputs the train step sees)
and the identity crop within rtol/atol 1e-5, the tolerance of
``tests/test_augment.py:85``. XLA contracts some of the sample-position
arithmetic into multiply-adds, so a position may differ by an ulp or two
and a weight by a few 1e-6; on white noise, where neighbouring pixels
differ by up to ~8, that moves an output by up to ~3e-5, so the noise
crops are held to atol 1e-4 (a weight error of 1e-5 times the 2 x 2 pixels
of at most |5| a bilinear weight touches, twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.data import augment as jax_aug
from dss_ml_at_scale_tpu_torch.data import augment as aug
from dss_ml_at_scale_tpu_torch.data.augment import AugmentConfig, ThreefryKey


def _jkey(seed, step=None):
    key = jax.random.key(seed)
    return key if step is None else jax.random.fold_in(key, step)


def _tkey(seed, step=None):
    key = ThreefryKey.from_seed(seed)
    return key if step is None else key.fold_in(step)


def _words(key) -> tuple[int, int]:
    data = np.asarray(jax.random.key_data(key))
    return int(data[0]), int(data[1])


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**32 + 7])
@pytest.mark.parametrize("step", [0, 1, 999, 2**31 - 1])
def test_key_and_fold_in_are_jax_bit_for_bit(seed, step):
    assert _words(jax.random.key(seed)) == (ThreefryKey.from_seed(seed).k1,
                                             ThreefryKey.from_seed(seed).k2)
    tk = _tkey(seed, step)
    assert _words(_jkey(seed, step)) == (tk.k1, tk.k2)


@pytest.mark.parametrize("num", [2, 4, 7])
def test_split_is_jax_bit_for_bit(num):
    for step in range(5):
        got = _tkey(3, step).split(num)
        want = jax.random.split(_jkey(3, step), num)
        assert [(k.k1, k.k2) for k in got] == [_words(k) for k in want]


@pytest.mark.parametrize("n", [1, 5, 64, 212, 1000])
def test_bits_uniform_and_bernoulli_are_jax_bit_for_bit(n):
    for step in range(4):
        jk, tk = _jkey(0, step), _tkey(0, step)
        np.testing.assert_array_equal(tk.random_bits(n),
                                      np.asarray(jax.random.bits(jk, (n,), jnp.uint32)))
        np.testing.assert_array_equal(tk.uniform(n), np.asarray(jax.random.uniform(jk, (n,))))
        for lo, hi in ((0.08, 1.0), (-0.3, 0.25), (0.0, 7.5)):
            np.testing.assert_array_equal(
                tk.uniform(n, lo, hi),
                np.asarray(jax.random.uniform(jk, (n,), minval=lo, maxval=hi)))
        np.testing.assert_array_equal(tk.bernoulli(n, 0.5),
                                      np.asarray(jax.random.bernoulli(jk, 0.5, (n,))))


def test_exp_and_log_are_xla_bit_for_bit():
    x = np.random.default_rng(0).uniform(-0.4, 0.4, 100_000).astype(np.float32)
    np.testing.assert_array_equal(aug.xla_exp(x), np.asarray(jax.jit(jnp.exp)(x)))
    for r in (0.75, 4.0 / 3.0, 0.5, 2.0):  # the ratio bounds the box draw logs
        assert aug.xla_log(np.float32(r)) == np.asarray(jnp.log(r))


@pytest.mark.parametrize("hw", [(224, 224), (40, 48), (32, 32)])
def test_boxes_and_flips_are_jax_bit_for_bit(hw):
    h, w = hw
    cfg = AugmentConfig()
    for step in range(20):
        k_box, k_flip = jax.random.split(_jkey(0, step))
        want = jax_aug._sample_boxes(k_box, 64, float(h), float(w), jax_aug.AugmentConfig())
        got = aug.draws(_tkey(0, step), 64, h, w, cfg)
        for name, g, wv in zip(("top", "left", "box_h", "box_w"), got, want):
            np.testing.assert_array_equal(g, np.asarray(wv), err_msg=f"step {step} {name}")
        np.testing.assert_array_equal(got[4], np.asarray(jax.random.bernoulli(k_flip, 0.5, (64,))))


def _images(b=6, h=40, w=48, seed=0):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def gratings(tmp_path_factory):
    """Normalized center crops of the port's synthetic JPEG table, as the
    decode pool hands them to the train step."""
    from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec
    from dss_ml_at_scale_tpu_torch.datagen import write_image_delta
    from dss_ml_at_scale_tpu_torch.data import DeltaTable
    import pyarrow.parquet as pq

    path = tmp_path_factory.mktemp("aug") / "t"
    write_image_delta(path, 6, classes=3, size=64, seed=2)
    rows = pq.read_table(DeltaTable(path).file_uris()).to_pydict()
    spec = imagenet_transform_spec(resize=48, crop=40, backend="pil")
    return spec({"content": np.array(rows["content"], dtype=object),
                 "label_index": np.array(rows["label_index"])})["image"]


CONFIGS = [dict(), dict(flip=False), dict(scale=(0.5, 1.0), ratio=(1.0, 1.0), seed=9),
           dict(scale=(1.0, 1.0), ratio=(1.0, 1.0), flip=False)]
CONFIG_IDS = ["default", "no-flip", "square", "identity"]


def _both(x, crop, cfg, step):
    want = jax_aug.augment_for_step(jnp.int32(step), jnp.asarray(x), crop,
                                    jax_aug.AugmentConfig(**cfg))
    got = aug.augment_for_step(step, torch.from_numpy(x), crop, AugmentConfig(**cfg))
    assert got.shape == (len(x), crop, crop, 3) and got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("crop", [32, 24, 56])
def test_crop_matches_jax(cfg, crop, gratings):
    for step in (0, 3, 11):
        got, want = _both(gratings, crop, cfg, step)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
@pytest.mark.parametrize("crop", [32, 24, 56])
def test_crop_of_noise_matches_jax(cfg, crop):
    for step in (0, 3, 11):
        got, want = _both(_images(), crop, cfg, step)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("size,crop", [(40, 32), (48, 24), (40, 56)])
def test_weight_matrices_match_jax(size, crop):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    top, _, box_h, _, _ = aug.draws(_tkey(0, 7), 8, size, size, AugmentConfig())
    scale = np.float32(crop) / box_h
    got = aug.weight_matrices(size, crop, torch.from_numpy(scale),
                              torch.from_numpy(-top * scale)).numpy()
    weights = jax.jit(jax.vmap(lambda s, t: compute_weight_mat(
        size, crop, s, t, _fill_triangle_kernel, True)))
    np.testing.assert_allclose(got, np.asarray(weights(scale, -top * scale)), rtol=0, atol=1e-5)


def test_identity_config_recovers_the_input():
    x = _images(h=32, w=32)
    cfg = AugmentConfig(scale=(1.0, 1.0), ratio=(1.0, 1.0), flip=False)
    got = aug.random_resized_crop_flip(_tkey(4), torch.from_numpy(x), 32, cfg)
    np.testing.assert_allclose(got.numpy(), x, rtol=1e-5, atol=1e-5)


def test_each_rank_takes_its_rows_of_the_global_batch():
    x = _images(b=8)
    whole = aug.augment_for_step(5, torch.from_numpy(x), 32)
    parts = [aug.augment_for_step(5, torch.from_numpy(x[r * 4:(r + 1) * 4]), 32, rank=r, ranks=2)
             for r in range(2)]
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_classifier_task_augments_train_steps_only():
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.resnet import ResNetBlock
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask

    def task(augment):
        model = seeded_resnet(0, device="cpu", stage_sizes=[1, 1], block_cls=ResNetBlock,
                              num_filters=8, num_classes=4, dtype=torch.float32)
        return ClassifierTask(model=model, learning_rate=1e-3, augment=augment)

    batch = {"image": torch.from_numpy(_images(b=4, h=32, w=32)),
             "label": torch.tensor([0, 1, 2, 3])}
    plain, augmented = task(None), task(AugmentConfig())
    a, b = plain.train_step(batch), augmented.train_step(batch)
    assert augmented.step == plain.step == 1
    assert a["train_loss"] != b["train_loss"]  # the step saw other pixels
    plain.model.load_state_dict(augmented.model.state_dict())
    # Eval never augments.
    assert plain.eval_step(batch)["val_loss"] == augmented.eval_step(batch)["val_loss"]
