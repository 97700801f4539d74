"""The benchmark of the PyTorch and CUDA port (``dss_ml_at_scale_tpu_torch``).

One command runs one cell of ``BENCHMARK.json``::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the configuration's published sizes;
- ``models/<config>.py``: how the port's model is built for it, and the
  FLOPs and kernel shapes counted from its published shapes;
- ``reference/<config>.py``: its plain float32 PyTorch reference, which
  also names and draws the weights both sides are given;
- ``traffic/<traffic>.json``: the parameters the one generator
  (:mod:`portbench.traffic`) reads;
- ``workloads/<cell>.json``: the cell's trace slice and the limits of its
  correctness check;
- ``metrics/<metric>.py``: a per-layer metric's reader.

The yardstick lives here and nowhere in the port: the generator, the
reading of the profiler's trace, the table of peaks, the FLOP and byte
counts, the references and the comparison that decides ``correct``.
Nothing here imports JAX or the JAX package; ``reference/`` imports
nothing of the port either.
"""
