"""What the benchmark counts from published shapes: the configurations'
FLOPs and K1-K3's calls and bounds."""

from __future__ import annotations

import pytest

from portbench import peaks, spec

# chip_smoke.py::FUSED_SHAPES, K1-K3's (M, K, N) at batch 212.
FUSED_SHAPES = ((212 * 56 * 56, 64, 256), (212 * 28 * 28, 128, 512),
                (212 * 14 * 14, 256, 1024), (212 * 7 * 7, 512, 2048))
# Their bounds by hand (PERF.md's kernel table, ms): K1, K2, K3 at s1-s4.
HAND_MS = {"K1": (0.127, 0.064, 0.032, 0.022), "K2": (0.152, 0.076, 0.038, 0.022),
           "K3": (0.127, 0.064, 0.032, 0.022)}


def test_resnet50_forward_macs():
    models = spec.load_module("models", "resnet50")
    macs = models.forward_macs(spec.load_json("configs", "resnet50"), 224)
    assert macs == pytest.approx(4.1e9, rel=0.02)
    assert models.train_flops_per_image(spec.load_json("configs", "resnet50"), 224) == 6 * macs


def test_vit_s16_forward_macs():
    models = spec.load_module("models", "vit_s16")
    config = spec.load_json("configs", "vit_s16")
    assert models.forward_macs(config, 224) == pytest.approx(4.6e9, rel=0.02)
    # 577 tokens: attention's share of the products about 20%, against 8% at 197.
    share = models.attention_macs(config, 384) / models.forward_macs(config, 384)
    assert 0.18 < share < 0.22
    assert models.attention_macs(config, 224) / models.forward_macs(config, 224) < 0.09


def test_fused_calls_are_fused_shapes():
    models = spec.load_module("models", "resnet50")
    calls = models.fused_calls(spec.load_json("configs", "resnet50"),
                               spec.load_json("traffic", "train_b212_224"))
    assert [(m, k, n) for _, m, k, n in calls] == list(FUSED_SHAPES)
    assert [c for c, _, _, _ in calls] == [3, 4, 6, 3]
    assert spec.load_module("models", "vit_s16").fused_calls({}, {}) == []


@pytest.mark.parametrize("stage", range(4))
def test_fused_bounds_match_hand_values(stage):
    m, k, n = FUSED_SHAPES[stage]
    got = peaks.fused_bounds_s(m, k, n)
    for kernel, hand in HAND_MS.items():
        assert got[kernel] * 1e3 == pytest.approx(hand[stage], abs=0.0006), kernel


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(3.35e12, 0.0) == 1.0
    assert peaks.bound_s(0.0, 989e12) == 1.0
    assert peaks.bound_s(3.35e12, 2 * 989e12) == 2.0
    # K1 at s1 is bound by bytes, at s4 by operations.
    m, k, n = FUSED_SHAPES[0]
    assert peaks.k1_bytes(m, k, n) / peaks.PEAK_BYTES > 2 * m * k * n / peaks.PEAK_FLOPS["bfloat16"]
    m, k, n = FUSED_SHAPES[3]
    assert peaks.k1_bytes(m, k, n) / peaks.PEAK_BYTES < 2 * m * k * n / peaks.PEAK_FLOPS["bfloat16"]
