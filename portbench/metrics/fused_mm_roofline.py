"""``fused_mm_roofline``: K1-K3's share of their roofline over the traced
slice, the sum of their bounds over the sum of their device time.

The calls are counted from the configuration's published shapes
(``portbench/models/<config>.py::fused_calls``: one call each of K1, K2
and K3 per bottleneck block a step, at the stage's (M, K, N)). Each call's
bound is the larger of its bytes over 3.35 TB/s and its 2·M·K·N operations
over 989 TFLOP/s (``portbench/peaks.py``), each input byte read once and
each output byte written once. The time is that of every launch of the
kernels named below in ``csrc/fused_matmul.cu``, K2's second pass over its
channel sums (``sum_rows_kernel``) with it. A slice whose launches of K1
differ from the count the shapes give reads nothing."""

import re

from portbench.peaks import fused_bounds_s

UNIT = "%"
LAYER = "kernels K1-K3: csrc/fused_matmul.cu"
SOURCE = "device_trace"
MOVES = "images_per_s"
KERNELS = re.compile(r"::(fwd|bwd_da|bwd_dw|sum_rows)_kernel\b")
K1 = re.compile(r"::fwd_kernel\b")


def read(ctx):
    if ctx.trace is None or not ctx.fused_calls:
        return None
    steps = ctx.trace.steps
    calls = sum(c for c, _, _, _ in ctx.fused_calls) * steps
    if ctx.trace.device_seconds_named(K1.search)[1] != calls:
        return None
    seconds, _ = ctx.trace.device_seconds_named(KERNELS.search)
    bound = steps * sum(c * sum(fused_bounds_s(m, k, n).values()) for c, m, k, n in ctx.fused_calls)
    return 100.0 * bound / seconds if seconds else None
