"""Synthetic token streams for the LM track: seeded Markov chains.

Port of ``dss_ml_at_scale_tpu/datagen/tokens.py``: the same order-1 Markov
source, the same transition matrix, the same tokens for the same config and
``sample_seed``, bit for bit. Its per-row transition entropy is a computable
cross-entropy floor, so "the model learns" is a checkable claim (loss →
floor) rather than "loss went down".

Two things differ, for speed, not in result:

- The chain of one config is built once per process (the last config
  asked for is kept): at vocab 8192 the Dirichlet draw of the 8192 x 8192
  matrix takes seconds and 512 MiB, and the JAX module draws it again at
  every call. :func:`transition_matrix` returns that shared array read-only.
- The inverse-CDF draw. The JAX loop counts, for all rows of the batch at
  once, the entries of the state's cumulative row below the uniform draw:
  a gather of ``batch x vocab`` floats per position. Here each row walks
  its own chain with ``bisect_left`` on a view of the cumulative row. A
  cumulative sum of non-negative f32 values never decreases, so
  ``bisect_left`` returns exactly that count; both compare f32 values
  (a Python float holds an f32 exactly).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenStreamConfig:
    vocab_size: int = 256
    batch_size: int = 8
    seq_len: int = 128
    # Dirichlet concentration of each transition row: lower = peakier
    # rows = more predictable chain = lower entropy floor.
    concentration: float = 0.05
    seed: int = 0


@functools.lru_cache(maxsize=1)
def _chain(vocab_size: int, concentration: float, seed: int):
    """The transition matrix (f64, read-only) and a memoryview of each row
    of its f32 cumulative sum."""
    rng = np.random.default_rng(seed)
    t = rng.dirichlet(np.full(vocab_size, concentration), size=vocab_size)
    t = t.astype(np.float64)
    t.flags.writeable = False
    cum = np.cumsum(t.astype(np.float32), axis=1)
    return t, [memoryview(row) for row in cum]


def transition_matrix(cfg: TokenStreamConfig) -> np.ndarray:
    """The chain's row-stochastic transition matrix [V, V] (seeded,
    read-only: the array is shared by every caller of the same config)."""
    return _chain(cfg.vocab_size, cfg.concentration, cfg.seed)[0]


def entropy_floor(cfg: TokenStreamConfig) -> float:
    """Expected next-token cross entropy (nats) of the optimal predictor.

    The stationary-weighted row entropy of the transition matrix: no
    model can beat it, and a converged LM approaches it.
    """
    t = transition_matrix(cfg)
    # Stationary distribution via power iteration (rows sum to 1).
    pi = np.full(cfg.vocab_size, 1.0 / cfg.vocab_size)
    for _ in range(200):
        nxt = pi @ t
        if np.abs(nxt - pi).max() < 1e-12:
            break
        pi = nxt
    with np.errstate(divide="ignore", invalid="ignore"):
        row_entropy = -np.sum(np.where(t > 0, t * np.log(t), 0.0), axis=1)
    return float(pi @ row_entropy)


def token_batches(
    cfg: TokenStreamConfig,
    num_batches: int | None = None,
    sample_seed: int | None = None,
) -> Iterator[dict]:
    """Yield ``{"tokens": int32 [batch, seq]}`` batches from the chain.

    ``num_batches=None`` streams forever (the reader-semantics match of
    ``num_epochs=None``); a finite count makes an eval split.

    ``sample_seed`` seeds the SAMPLE PATH only — the transition matrix
    always comes from ``cfg.seed``, so train (default) and eval
    (``sample_seed=...``) splits draw different trajectories of the SAME
    chain.
    """
    _, rows = _chain(cfg.vocab_size, cfg.concentration, cfg.seed)
    last = cfg.vocab_size - 1
    rng = np.random.default_rng(
        cfg.seed + 1 if sample_seed is None else sample_seed
    )
    count = 0
    while num_batches is None or count < num_batches:
        tokens = np.empty((cfg.batch_size, cfg.seq_len), np.int32)
        state = rng.integers(0, cfg.vocab_size, cfg.batch_size)
        u = rng.random((cfg.batch_size, cfg.seq_len - 1), np.float32)
        for b, draws in enumerate(u.tolist()):
            x = int(state[b])
            path = [x]
            for val in draws:
                # Inverse-CDF draw; the clip guards f32 rows summing to <1.
                x = min(bisect.bisect_left(rows[x], val), last)
                path.append(x)
            tokens[b] = path
        yield {"tokens": tokens}
        count += 1
