"""The reading of a trace, on events built here, and the per-layer
metrics' readers over it."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.run import Context
from portbench.trace import SLICE, Trace, kind, profile_slice


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 0,
            "args": args}


def _events():
    """A slice of 1000 us over two steps: a _BnAct forward launching a
    kernel, its backward on another thread launching two, an attention
    product, K1 and K3 launched outside any op, and a kernel outside the
    slice."""
    return [
        _x("user_annotation", SLICE, 0, 1000),
        _x("cpu_op", "_BnAct", 10, 50),
        _x("cpu_op", "aten::add", 20, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 2, correlation=1),
        _x("kernel", "void at::native::elementwise_kernel<...>", 30, 100, tid=7, correlation=1),
        _x("cpu_op", "autograd::engine::evaluate_function: _BnActBackward", 300, 100, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 2, tid=2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 320, 2, tid=2, correlation=3),
        _x("kernel", "void at::native::reduce_kernel<...>", 400, 50, tid=7, correlation=2),
        _x("kernel", "void at::native::elementwise_kernel<...>", 450, 50, tid=7, correlation=3),
        _x("cpu_op", "aten::bmm", 600, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 605, 2, correlation=4),
        _x("kernel", "sm90_xmma_gemm_bf16", 610, 40, tid=7, correlation=4),
        _x("kernel", "void (anonymous namespace)::fwd_kernel<true>(...)", 700, 30, tid=7,
           correlation=5),
        _x("kernel", "void (anonymous namespace)::bwd_dw_kernel(...)", 720, 60, tid=8,
           correlation=6),
        _x("kernel", "late", 1200, 10, tid=7, correlation=7),
        {"ph": "i", "name": "instant"},
    ]


def test_window_busy_and_gaps():
    tr = Trace.from_events(_events(), steps=2)
    assert tr.window_s == pytest.approx(1e-3)
    # Busy: [30,130] [400,500] [610,650] [700,780] = 320 us.
    assert tr.busy_s() == pytest.approx(320e-6)
    assert [(a, b) for a, b in tr.gaps()] == [(0, 30), (130, 400), (500, 610), (650, 700),
                                              (780, 1000)]
    out = tr.breakdown()
    assert out["idle_gaps"][0][1] == pytest.approx(270e-6)
    assert out["idle_gaps"][1] == ["python", pytest.approx(220e-6)]
    assert dict(out["device_ops"])["K1-K3"] == pytest.approx(90e-6)


def test_attribution_through_the_operator_tree():
    tr = Trace.from_events(_events(), steps=2)
    bn = spec.load_module("metrics", "bn_layer_ms")
    assert tr.device_seconds_under(bn.OPS) == (pytest.approx(200e-6), 3)
    att = spec.load_module("metrics", "attention_ms")
    assert tr.device_seconds_under(att.OPS) == (pytest.approx(40e-6), 1)


def _ctx(tr, **kw):
    base = dict(trace=tr, timeline=tr, images_per_s=100.0, train_flops_per_image=989e10,
                fused_calls=[(1, 1024, 64, 64)])
    base.update(kw)
    return Context(**base)


def test_metric_readers():
    tr = Trace.from_events(_events(), steps=2)
    read = {m: spec.load_module("metrics", m).read for m in
            ("dispatch_ms", "mfu", "bn_layer_ms", "attention_ms", "device_idle_share",
             "fused_mm_roofline")}
    ctx = _ctx(tr)
    # No launch waited: the host's 1000 us over two steps.
    assert read["dispatch_ms"](ctx) == pytest.approx(0.5)
    assert read["mfu"](ctx) == pytest.approx(100.0)
    assert read["bn_layer_ms"](ctx) == pytest.approx(0.1)
    assert read["attention_ms"](ctx) == pytest.approx(0.02)
    assert read["device_idle_share"](ctx) == pytest.approx(68.0)
    # Two steps of one call each: K1 launched twice is required; once reads nothing.
    assert read["fused_mm_roofline"](ctx) is None
    ctx = _ctx(tr, fused_calls=[(1, 1024, 64, 64)])
    ctx.trace.steps = 1
    from portbench.peaks import fused_bounds_s

    bound = sum(fused_bounds_s(1024, 64, 64).values())
    assert read["fused_mm_roofline"](ctx) == pytest.approx(100 * bound / 90e-6)


def test_readers_find_nothing_without_their_source():
    empty = Trace.from_events([_x("user_annotation", SLICE, 0, 10)], steps=1)
    ctx = _ctx(empty, images_per_s=0.0, fused_calls=[])
    for m in ("dispatch_ms", "mfu", "bn_layer_ms", "attention_ms", "device_idle_share",
              "fused_mm_roofline"):
        assert spec.load_module("metrics", m).read(ctx) is None, m


def test_host_waits_are_full_queue_launches_and_synchronize():
    """100 launches of kernels that run 100 us each, one after another, from
    1 ms on: the first 64 launches (fewer than 64 waiting) take 2 us, the
    next 36 wait 28 us beyond that; the slice ends on a 500 us
    synchronize."""
    events, t = [], 0.0
    for i in range(100):
        dur = 2.0 if i < 64 else 30.0
        events.append(_x("cuda_runtime", "cudaLaunchKernel", t, dur, correlation=i))
        events.append(_x("kernel", "k", 1000.0 + 100 * i, 100, tid=7, correlation=i))
        t += dur + 1
    events.append(_x("cuda_runtime", "cudaDeviceSynchronize", t, 500))
    # A driver call inside the last launch (usually 1 us, as at the start)
    # waits with it: counted once.
    events.append(_x("cuda_driver", "cuLaunchKernel", 0.5, 1))
    events.append(_x("cuda_driver", "cuLaunchKernel", t - 31 + 1, 29))
    tr = Trace.from_events(events, steps=2)
    assert tr.window == (0.0, 1808.0)
    assert tr.host_waits_s() == pytest.approx((36 * 28 + 500) * 1e-6)
    dispatch = spec.load_module("metrics", "dispatch_ms").read(_ctx(tr))
    assert dispatch == pytest.approx((1808 - 36 * 28 - 500) / 2 / 1e3)


def test_trace_without_slice_is_refused():
    with pytest.raises(ValueError):
        Trace.from_events([_x("cpu_op", "aten::add", 0, 1)], steps=1)


def test_device_only_trace_takes_its_window_from_the_runtime_calls():
    events = [e for e in _events() if e.get("cat") not in ("cpu_op", "user_annotation")]
    events.append(_x("cuda_runtime", "cudaDeviceSynchronize", 790, 20))
    tr = Trace.from_events(events, steps=2)
    assert tr.window == (21.0, 810.0)
    assert tr.busy_s() == pytest.approx(320e-6)


def test_kinds():
    assert kind("void (anonymous namespace)::sum_rows_kernel<4>(...)") == "K1-K3"
    assert kind("cudnn::bn_fw_tr_1C11_kernel") == "convolutions and products (cuDNN, cuBLAS)"
    assert kind("void at::native::reduce_kernel<512, 1>") == "reductions"
    assert kind("Memcpy DtoD (Device -> Device)") == "copies and casts"
    assert kind("void at::native::vectorized_elementwise_kernel<4>") == "other elementwise"


def test_profile_slice_on_the_cpu_finds_the_operators():
    """A real CPU profile of a tiny model's steps: the slice, the attention
    operators and the fused BN Functions are in it (no device events)."""
    import torch

    from dss_ml_at_scale_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from dss_ml_at_scale_tpu_torch.models.vit import vit_tiny

    res = ResNet(stage_sizes=[1], block_cls=BottleneckBlock, num_filters=8, num_classes=4,
                 fused_bn="pallas")
    vit = vit_tiny(4, image_size=16)
    x = torch.randn(2, 16, 16, 3)

    def steps(n):
        for _ in range(n):
            (res(x).sum() + vit(x).sum()).backward()

    tr = profile_slice(steps, 2, "cpu")
    names = {name for ops in tr.ops.values() for _, _, name in ops}
    bn = spec.load_module("metrics", "bn_layer_ms").OPS
    att = spec.load_module("metrics", "attention_ms").OPS
    assert {"_BnAct", "_BnReluMatmul", "_BnActBackward", "_BnReluMatmulBackward"} <= names
    assert set(att) <= names and set(bn) & names
    assert tr.device_ops == [] and tr.window_s > 0
