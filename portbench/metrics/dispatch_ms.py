"""``dispatch_ms``: the host's own time a training step, forward,
``_backward`` and ``_update`` of ``ClassifierTask.train_step``: the traced
slice that records the device's activity and the runtime calls (not the
host's operators), less the time the host spent in runtime calls waiting
on the device (a launch into a full queue, a synchronize;
:meth:`portbench.trace.Trace.host_waits_s`), over its steps. Where it
reaches the device's busy time a step, the host paces the card; below it,
the device does. The runtime calls' tracing adds its own small cost a
call."""

UNIT = "ms"
LAYER = "train step, host side: parallel/trainer.py"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    tl = ctx.timeline
    waits = None if tl is None else tl.host_waits_s()
    if waits is None:
        return None
    return 1e3 * (tl.window_s - waits) / tl.steps
