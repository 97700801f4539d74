"""Device telemetry: the card's memory, live blocks, and compile events.

Port of ``dss_ml_at_scale_tpu/telemetry/device.py`` on ``torch.cuda``
(the JAX module reads ``Device.memory_stats()`` and ``jax.live_arrays()``).
The caching allocator's view of a card (:func:`torch.cuda.memory_stats`,
:func:`torch.cuda.max_memory_allocated`, :func:`torch.cuda.mem_get_info`)
fills the same gauges the JAX package's monitor fills from its backend. A
CPU device has no such statistics: every probe degrades to "no sample"
(``device_memory_stats_supported`` 0) instead of raising, so the same
instrumented code runs in the CPU tests.

Compile events: the JAX package counts executable compiles of a jitted
step (a retrace turns a 10 ms step into a 30 s one). Eager torch never
traces, so a torch run has one kind of compile event only: the first-use
build or load of one of the port's kernel libraries
(:mod:`..ops._build`, ``nvcc`` into ``build/kernels/`` or a load of what
is there). :class:`CompileTracker` counts those, so
``train_compile_events_total`` stops growing after the first step that
reaches each kernel, and stays 0 for a model that reaches none.
"""

from __future__ import annotations

import threading
from typing import Sequence

import torch


def device_memory_stats(device) -> dict:
    """The allocator's statistics of one card as the JAX package names
    them (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``,
    ``num_live_blocks``), or ``{}`` for a device without them (the CPU)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    _free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(total),
        "num_live_blocks": int(stats.get("active.all.current", 0)),
    }


def device_label(device) -> str:
    device = torch.device(device)
    return f"{device.type}:{device.index or 0}"


def _default_devices() -> list[torch.device]:
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


class DeviceMonitor:
    """Background sampler of per-device memory gauges.

    ``sample()`` takes one sample synchronously (what the thread calls
    every ``interval_s``); ``start()``/``stop()`` manage the daemon
    thread. Gauges written (labeled ``device="cuda:0"`` style):

    - ``device_hbm_bytes_in_use`` / ``device_hbm_bytes_peak`` /
      ``device_hbm_bytes_limit``: allocated bytes, the allocator's peak
      since its last reset, and the card's total memory.
    - ``device_live_buffers``: the allocator's active blocks.
    - ``device_memory_stats_supported``: 1/0 per device, so a reader can
      tell "no data" from "zero bytes".
    """

    # Lock contract: start()/stop() race from embedding code and the
    # teardown paths; the sampler-thread handle only under _lock.
    _guarded_by_lock = ("_thread",)

    def __init__(self, registry=None, *, interval_s: float = 1.0,
                 devices: Sequence | None = None):
        if registry is None:
            from . import get_registry

            registry = get_registry()
        self.registry = registry
        self.interval_s = interval_s
        self.devices = ([torch.device(d) for d in devices] if devices is not None
                        else _default_devices())
        self._in_use = registry.gauge(
            "device_hbm_bytes_in_use", "allocator bytes in use", labels=("device",))
        self._peak = registry.gauge(
            "device_hbm_bytes_peak", "allocator peak bytes in use", labels=("device",))
        self._limit = registry.gauge(
            "device_hbm_bytes_limit", "allocator byte limit", labels=("device",))
        self._live = registry.gauge(
            "device_live_buffers", "live on-device buffers", labels=("device",))
        self._supported = registry.gauge(
            "device_memory_stats_supported",
            "1 when memory_stats() reports on this device", labels=("device",))
        self._samples = registry.counter(
            "device_monitor_samples_total", "DeviceMonitor sampling passes")
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def sample(self) -> None:
        """One sampling pass over every device. Never raises for a device
        without statistics: a CPU device reports supported=0."""
        for d in self.devices:
            label = device_label(d)
            stats = device_memory_stats(d)
            self._supported.labels(device=label).set(1.0 if stats else 0.0)
            if stats:
                self._in_use.labels(device=label).set(stats["bytes_in_use"])
                self._peak.labels(device=label).set(stats["peak_bytes_in_use"])
                self._limit.labels(device=label).set(stats["bytes_limit"])
            self._live.labels(device=label).set(stats.get("num_live_blocks", 0))
        self._samples.inc()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            # dsst: ignore[bare-except] sampler thread: a flaky device query must not kill it
            except Exception:
                pass

    def start(self) -> "DeviceMonitor":
        # The whole check-then-spawn under _lock: two concurrent start()
        # calls must not both spawn a sampler.
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self.sample()  # one immediate sample so the gauges exist at once
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="device-monitor")
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        # The event is set inside the lock, so every sampler swapped out
        # below has seen its stop signal.
        with self._lock:
            self._stop.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=timeout)

    def __enter__(self) -> "DeviceMonitor":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def _kernel_libraries_loaded() -> int:
    from ..ops import _build

    # A lock-free read: len() of a dict is atomic, and a build in flight
    # on another thread holds _build's lock for the whole nvcc run.
    return len(_build._loaded)


class CompileTracker:
    """Count compile events: kernel libraries built or loaded since the
    tracker was made (see the module docstring: the one compile event of
    an eager torch run). ``update()`` after each step adds the growth to
    the counter and returns it; one ``len`` per call, no
    device sync."""

    def __init__(self, counter=None):
        if counter is None:
            from . import get_registry

            counter = get_registry().counter(
                "kernel_compile_events_total",
                "kernel libraries built or loaded at first use")
        self._counter = counter
        self._last = _kernel_libraries_loaded()

    def update(self) -> int:
        """Record (and return) the compile events since the last update."""
        size = _kernel_libraries_loaded()
        delta = size - self._last
        if delta > 0:
            self._counter.inc(delta)
            self._last = size
        return delta
