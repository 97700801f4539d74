"""The port's profiling hooks vs the JAX package's
(``dss_ml_at_scale_tpu/utils/profiling.py``): ``trace(logdir)`` profiles the
enclosed block into a directory, and ``annotate(name)`` names a span in it.
JAX writes a ``jax.profiler`` trace (``plugins/profile/<run>/*.trace.json.gz``);
the port a ``torch.profiler`` Chrome trace (``trace_<pid>.json``). The same
block, with the same span, goes through both on the CPU.
"""

import gzip
import json
import os

import jax.numpy as jnp
import torch

from dss_ml_at_scale_tpu.utils import profiling as jax_profiling
from dss_ml_at_scale_tpu_torch.utils import profiling

SPAN = "decode_batch"


def test_trace_writes_a_chrome_trace_that_names_the_span(tmp_path):
    with profiling.trace(tmp_path / "port") as path:
        with profiling.annotate(SPAN):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert path == tmp_path / "port" / f"trace_{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == SPAN]
    assert spans and all(e["dur"] >= 0 for e in spans if "dur" in e)
    # The product ran inside the span, and the trace recorded it.
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_and_annotate_follow_the_jax_hooks(tmp_path):
    """Both packages' hooks take the same arguments and name the span in the
    trace each writes."""
    with jax_profiling.trace(str(tmp_path / "jax")):
        with jax_profiling.annotate(SPAN):
            (jnp.ones((64, 64)) @ jnp.ones((64, 64))).block_until_ready()
    (jax_file,) = (tmp_path / "jax").glob("plugins/profile/*/*.trace.json.gz")
    assert SPAN in gzip.decompress(jax_file.read_bytes()).decode()
    with profiling.trace(str(tmp_path / "port")) as path:
        with profiling.annotate(SPAN):
            torch.ones(8).sum()
    assert SPAN in path.read_text()


def test_annotate_outside_a_trace_is_a_no_op_span():
    with profiling.annotate(SPAN):
        assert torch.ones(3).sum().item() == 3.0
