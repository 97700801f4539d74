"""What the references share: their precision, the loss, Adam, and the
readings of three training steps.

Plain PyTorch. The references import nothing of the port and take nothing
it made: the benchmark hands both sides the same weights and batches, and
the reference works out everything else again.

``Precision(None)`` is the reference: every product and every activation
in float32, with TF32 off (:func:`exact_float32`). A lower precision
rounds where the configuration states bfloat16, and only there: the
operands of the bfloat16 products (:meth:`Precision.conv2d`,
:meth:`Precision.linear`) and each activation the model keeps in
bfloat16 (:meth:`Precision.act`), the gradient reaching each of those
points rounded alike; statistics, softmax, attention's float32 products,
the head and the optimizer stay float32, as the configurations state.
``"float8"`` is the correctness check's control, the step below
bfloat16: e4m3 with a per-tensor scale from the tensor's largest
magnitude, e5m2 for the gradients (an fp8 training recipe with current
scaling). ``"bfloat16"`` is a witness: the reference rounded where the
port rounds, which the port should read alike.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..check import Readings

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@contextlib.contextmanager
def exact_float32():
    """float32 products with TF32 off for cuBLAS and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _scaled_round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = largest / amax
    return ((x * scale).to(dtype).to(x.dtype)) / scale


class _Float8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, 57344.0)


class _BFloat16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    """Where a lower precision rounds: nowhere (float32), or at the
    bfloat16 points of the configuration, to float8 (the control) or to
    bfloat16 (the witness)."""

    KINDS = {None: None, "float8": _Float8, "bfloat16": _BFloat16}

    def __init__(self, kind: str | None = None):
        if kind not in self.KINDS:
            raise ValueError(f"precision {kind!r} is not one of {tuple(self.KINDS)}")
        self.kind = kind
        self._round = self.KINDS[kind]

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation the configuration keeps in bfloat16."""
        return x if self._round is None else self._round.apply(x)

    def conv2d(self, x, w, bias=None, stride=1, padding=0):
        """A bfloat16 convolution: operands and result rounded, the bias
        (rounded) added to the rounded result."""
        y = self.act(F.conv2d(self.act(x), self.act(w), stride=stride, padding=padding))
        return y if bias is None else self.act(y + self.act(bias)[:, None, None])

    def linear(self, x, w, bias=None):
        """A bfloat16 dense layer, as ``conv2d``."""
        y = self.act(torch.matmul(self.act(x), self.act(w).t()))
        return y if bias is None else self.act(y + self.act(bias))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    return -logp.gather(1, labels.long()[:, None]).mean()


def train_readings(model: torch.nn.Module, batches: list[dict], lr: float,
                   steps: int = 3) -> Readings:
    """Adam (optax's update: the bias-corrected moments, eps outside the
    root) over ``steps`` batches from the model's loaded state, and what
    the check compares: each step's loss, each leaf's norm of the first
    gradient, and each leaf's norm of the change of the parameters and of
    the buffers after the last step."""
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    buffers0 = {n: b.detach().clone() for n, b in model.named_buffers()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = ADAM_BETAS
    losses, first = [], None
    for t in range(1, steps + 1):
        batch = batches[t - 1]
        loss = cross_entropy(model(batch["image"]), batch["label"])
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(loss.detach())
        if t == 1:
            first = torch.stack([torch.linalg.vector_norm(g) for g in grads])
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** t)
                v_hat = v[n] / (1 - b2 ** t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
        del grads, loss
    with torch.no_grad():
        change = torch.stack([torch.linalg.vector_norm(p - start[n]) for n, p in params.items()])
        stats = [torch.linalg.vector_norm(b.float() - buffers0[n].float())
                 for n, b in model.named_buffers()]
        stats = torch.stack(stats) if stats else torch.zeros(0, device=change.device)
    names = list(params)
    return Readings(losses=[float(x) for x in torch.stack(losses).tolist()],
                    grad=dict(zip(names, first.tolist())),
                    change=dict(zip(names, change.tolist())),
                    stats=dict(zip([n for n, _ in model.named_buffers()], stats.tolist())))


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """TensorFlow's SAME padding of one spatial dimension: ``(low, high)``,
    the odd pixel on the high side."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2
