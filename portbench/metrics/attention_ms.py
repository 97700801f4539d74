"""``attention_ms``: device milliseconds a step of attention's batched
products and softmax, forward and backward: the kernels launched under
``aten::bmm``, ``aten::_softmax`` and ``aten::_softmax_backward_data``
(through the profiler's operator tree). In the ViT only
``ops/flash_attention.py::attention_reference`` calls them. Its float32
casts and the scale are elementwise work outside those operators and are
not counted."""

UNIT = "ms"
LAYER = "attention: ops/flash_attention.py::attention_reference in models/vit.py"
SOURCE = "device_trace"
MOVES = "images_per_s"
OPS = ("aten::bmm", "aten::_softmax", "aten::_softmax_backward_data")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = ctx.trace.device_seconds_under(OPS)
    return 1e3 * seconds / ctx.trace.steps if count else None
