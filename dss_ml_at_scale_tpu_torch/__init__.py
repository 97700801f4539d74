"""PyTorch/CUDA port of dss_ml_at_scale_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference. Module
paths mirror the JAX package's (``ops/``, ``models/``, ``serving/lm/``,
``telemetry/``, ``workloads/``, ``config/``). Every TPU (Pallas) kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built with nvcc
at first use. The port imports torch and never jax, nor any module of the
JAX package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
