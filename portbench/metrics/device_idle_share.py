"""``device_idle_share``: the share of the traced window in which no device
operation ran (the window less the union of the kernels', copies' and
sets' intervals), read from the slice that records the device's activity
alone: recording the host's operators would slow the dispatch and idle
the device for the profiler's sake."""

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    if ctx.timeline is None or not ctx.timeline.device_ops:
        return None
    return 100.0 * (1.0 - ctx.timeline.busy_s() / ctx.timeline.window_s)
