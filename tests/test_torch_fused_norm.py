"""The port's fused BatchNorm + ReLU (+ residual) vs the JAX package's.

The same numpy inputs go through ``dss_ml_at_scale_tpu.ops.fused_norm.bn_act``
(its custom VJP) and the port's ``torch.autograd.Function``; outputs,
statistics and every cotangent are compared in f32 at atol 2e-4, the
tolerance of ``tests/test_fused_norm.py:58``. The module's running averages
(momentum 0.9, biased variance) and its ``stats_only`` and eval modes are
checked against the JAX ``BatchNorm`` module the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_ml_at_scale_tpu.ops import fused_norm as jax_fn
from dss_ml_at_scale_tpu_torch.ops.fused_norm import BatchNorm, bn_act

ATOL = 2e-4


def _inputs(seed=0, shape=(2, 4, 4, 6)):
    rng = np.random.default_rng(seed)
    k = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(1.0, 0.3, k).astype(np.float32),
            rng.normal(0.0, 0.3, k).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))  # x, scale, bias, residual, cotangent


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
def test_bn_act_forward_and_grads_match_jax(relu, with_res):
    x, scale, bias, res, cot = _inputs()

    def jax_loss(args):
        out, _, _ = jax_fn.bn_act(args[0], args[1], args[2], eps=1e-5, relu=relu,
                                  residual=args[3] if with_res else None)
        return jnp.sum(out * cot)

    jargs = tuple(jnp.asarray(a) for a in (x, scale, bias, res))
    j_out, j_mean, j_var = jax_fn.bn_act(*jargs[:3], eps=1e-5, relu=relu,
                                        residual=jargs[3] if with_res else None)
    j_grads = jax.grad(jax_loss)(jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in (x, scale, bias, res)]
    t_out, t_mean, t_var = bn_act(*targs[:3], eps=1e-5, relu=relu,
                                  residual=targs[3] if with_res else None)
    (t_out * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(t_out.detach(), j_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_mean, j_mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_var, j_var, rtol=0, atol=1e-6)
    assert not t_mean.requires_grad and not t_var.requires_grad
    for name, tj, tt in zip(("dx", "dscale", "dbias", "dres"), j_grads, targs):
        if name == "dres" and not with_res:
            assert tt.grad is None
            continue
        np.testing.assert_allclose(tt.grad, tj, rtol=0, atol=ATOL, err_msg=name)


def test_bn_act_bf16_io():
    x = torch.from_numpy(_inputs()[0]).to(torch.bfloat16).requires_grad_()
    out, mean, var = bn_act(x, torch.ones(6), torch.zeros(6), relu=True)
    assert out.dtype == torch.bfloat16
    assert mean.dtype == torch.float32 and var.dtype == torch.float32
    assert (out.float() >= 0).all()
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16


def _jax_bn(act, x, res=None, *, train=True, stats_only=False, variables=None):
    mod = jax_fn.BatchNorm(use_running_average=not train, act=act)
    xj = jnp.asarray(x)
    if variables is None:
        variables = mod.init(jax.random.key(0), xj)
    out, upd = mod.apply(variables, xj, None if res is None else jnp.asarray(res),
                         stats_only=stats_only, mutable=["batch_stats"])
    return out, upd["batch_stats"], variables


def _torch_bn(act, variables):
    bn = BatchNorm(6, act=act)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
        bn.running_mean.copy_(torch.from_numpy(np.asarray(variables["batch_stats"]["mean"])))
        bn.running_var.copy_(torch.from_numpy(np.asarray(variables["batch_stats"]["var"])))
    return bn


@pytest.mark.parametrize("act", [None, "relu"])
def test_module_train_updates_running_stats_like_jax(act):
    x, scale, bias, res, _ = _inputs(1)
    rng = np.random.default_rng(2)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": rng.normal(0, 0.5, 6).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
    j_out, j_stats, _ = _jax_bn(act, x, res, variables=variables)
    bn = _torch_bn(act, variables).train()
    t_out = bn(torch.from_numpy(x), torch.from_numpy(res))
    np.testing.assert_allclose(t_out.detach(), j_out, rtol=0, atol=ATOL)
    np.testing.assert_allclose(bn.running_mean, j_stats["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var, j_stats["var"], rtol=0, atol=1e-6)


def test_module_stats_only_and_eval_match_jax():
    x, scale, bias, res, _ = _inputs(3)
    rng = np.random.default_rng(4)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": rng.normal(0, 0.5, 6).astype(np.float32),
                                 "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
    # stats_only, train: the batch statistics, and the same running update.
    (js, jb, jm, jv), j_stats, _ = _jax_bn(None, x, stats_only=True, variables=variables)
    bn = _torch_bn(None, variables).train()
    ts, tb, tm, tv = bn(torch.from_numpy(x), stats_only=True)
    for a, b in ((ts, js), (tb, jb), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(a.detach(), b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean, j_stats["mean"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(bn.running_var, j_stats["var"], rtol=0, atol=1e-6)
    # Eval: running statistics, with the activation and residual applied.
    j_out, _, _ = _jax_bn("relu", x, res, train=False, variables=variables)
    bn = _torch_bn("relu", variables).eval()
    t_out = bn(torch.from_numpy(x), torch.from_numpy(res))
    np.testing.assert_allclose(t_out.detach(), j_out, rtol=0, atol=ATOL)
    (_, _, jm, jv), _, _ = _jax_bn(None, x, train=False, stats_only=True, variables=variables)
    _, _, tm, tv = bn(torch.from_numpy(x), stats_only=True)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=0)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=0)
