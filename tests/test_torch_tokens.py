"""The port's Markov token source against the JAX package's.

The same config and ``sample_seed`` must give the same tokens bit for bit
(the port walks each row with ``bisect`` where JAX counts with a gather),
the same transition matrix bit for bit, and the same entropy floor to
1e-12.
"""

import itertools

import numpy as np
import pytest

from dss_ml_at_scale_tpu.datagen import tokens as jax_tokens
from dss_ml_at_scale_tpu_torch.datagen import tokens

CONFIGS = [
    dict(vocab_size=16, batch_size=4, seq_len=2, concentration=0.05, seed=0),
    dict(vocab_size=64, batch_size=3, seq_len=33, concentration=0.5, seed=7),
    dict(vocab_size=256, batch_size=8, seq_len=64, concentration=0.05, seed=1),
    dict(vocab_size=512, batch_size=2, seq_len=64, concentration=0.01, seed=3),
    dict(vocab_size=100, batch_size=5, seq_len=17, concentration=2.0, seed=11),
]


def _cfgs(kw):
    return jax_tokens.TokenStreamConfig(**kw), tokens.TokenStreamConfig(**kw)


@pytest.mark.parametrize("sample_seed", [None, 5, 100_000])
@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"v{kw['vocab_size']}s{kw['seq_len']}")
def test_token_batches_bit_identical(kw, sample_seed):
    jcfg, tcfg = _cfgs(kw)
    want = list(jax_tokens.token_batches(jcfg, num_batches=3, sample_seed=sample_seed))
    got = list(tokens.token_batches(tcfg, num_batches=3, sample_seed=sample_seed))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g["tokens"].dtype == np.int32 and g["tokens"].shape == w["tokens"].shape
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_infinite_stream_matches():
    jcfg, tcfg = _cfgs(CONFIGS[1])
    want = itertools.islice(jax_tokens.token_batches(jcfg), 4)
    got = itertools.islice(tokens.token_batches(tcfg), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: f"v{kw['vocab_size']}")
def test_transition_matrix_and_entropy_floor(kw):
    jcfg, tcfg = _cfgs(kw)
    t = tokens.transition_matrix(tcfg)
    np.testing.assert_array_equal(t, jax_tokens.transition_matrix(jcfg))
    assert t.dtype == np.float64 and not t.flags.writeable
    assert abs(tokens.entropy_floor(tcfg) - jax_tokens.entropy_floor(jcfg)) <= 1e-12
