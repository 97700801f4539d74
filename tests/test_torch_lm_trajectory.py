"""The port's LM learns as the JAX package's does: 50 Adam steps.

A tiny f32 LM (vocab 64, dim 64, 2 heads, 2 layers, seq 32, flash
attention: Pallas in interpret mode on the JAX side, the plain version and
its chunked-recompute backward on the port's) starts from the same weights
(``lm_state_from_flax``) and takes 50 steps of ``optax.adam(3e-3)`` and
of the port's ``LMTask`` on the same batches of the port's Markov token
source. Both packages compute in f32 here, so every step's loss agrees to
1e-4 relative; the loss must also fall, so the comparison covers a
trajectory that learns. A slow drift of the port away from JAX, which one
step cannot show, fails here.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dss_ml_at_scale_tpu.models import TransformerLM as JaxLM
from dss_ml_at_scale_tpu.parallel.trainer import LMTask as JaxLMTask
from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, token_batches
from dss_ml_at_scale_tpu_torch.models import TransformerLM, lm_state_from_flax
from dss_ml_at_scale_tpu_torch.parallel import LMTask

STEPS, LR = 50, 3e-3
KW = dict(vocab_size=64, dim=64, num_heads=2, num_layers=2, max_seq=32)
STREAM = TokenStreamConfig(vocab_size=64, batch_size=4, seq_len=32, concentration=0.05, seed=0)


def test_fifty_adam_steps_follow_the_jax_trajectory():
    batches = [b["tokens"].astype(np.int32)
               for b in itertools.islice(token_batches(STREAM, sample_seed=1), STEPS)]
    jm = JaxLM(attention="flash", dtype=jnp.float32, **KW)
    jtask = JaxLMTask(model=jm, tx=optax.adam(LR))
    state = jtask.init_state(jax.random.key(0), {"tokens": batches[0]})
    tm = TransformerLM(attention="flash", dtype=torch.float32, device="cpu", **KW)
    tm.load_state_dict(lm_state_from_flax(jax.tree_util.tree_map(np.asarray, state.params)))
    task = LMTask(model=tm, learning_rate=LR)
    step = jax.jit(jtask.train_step)
    want, got = [], []
    for tokens in batches:
        state, metrics = step(state, {"tokens": tokens})
        want.append(float(metrics["train_loss"]))
        got.append(float(task.train_step({"tokens": torch.from_numpy(tokens).long()})["train_loss"]))
    want, got = np.array(want), np.array(got)
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < 1e-4, f"step {rel.argmax()}: port {got[rel.argmax()]} jax {want[rel.argmax()]}"
    assert got[-5:].mean() < got[:5].mean() - 0.3  # it learns
