"""``bn_layer_ms``: device milliseconds a step of the kernels launched
under the fused BatchNorm's autograd Functions, forward and backward:
``ops/fused_norm.py::_BnAct`` (BN + ReLU + residual) and
``ops/fused_matmul.py::_BnReluMatmul`` (the middle BN applied inside
K1-K3), found through the profiler's operator tree (each kernel's launch
by its correlation id inside the Function's operator). The middle BN's
statistics and the running averages, computed outside the Functions, are
not counted."""

UNIT = "ms"
LAYER = "BN-ReLU(-matmul) layer: ops/fused_norm.py, ops/fused_matmul.py"
SOURCE = "device_trace"
MOVES = "images_per_s"
OPS = ("_BnAct", "_BnReluMatmul", "_BnActBackward", "_BnReluMatmulBackward",
       "autograd::engine::evaluate_function: _BnActBackward",
       "autograd::engine::evaluate_function: _BnReluMatmulBackward")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = ctx.trace.device_seconds_under(OPS)
    return 1e3 * seconds / ctx.trace.steps if count else None
