"""``mfu``: the whole training step's share of the card's bf16 dense peak
(989 TFLOP/s, ``portbench/peaks.py``): the configuration's FLOPs an image,
counted from its published shapes by ``portbench/models/<config>.py``
(every convolution and product, forward and backward, nothing recomputed),
times the window's images a second. The same work reads the same whatever
implements it."""

from portbench.peaks import PEAK_FLOPS

UNIT = "%"
LAYER = "whole train step: models and trainer"
SOURCE = "host_clock"
MOVES = "images_per_s"


def read(ctx):
    if not ctx.images_per_s or not ctx.train_flops_per_image:
        return None
    return 100.0 * ctx.train_flops_per_image * ctx.images_per_s / PEAK_FLOPS["bfloat16"]
