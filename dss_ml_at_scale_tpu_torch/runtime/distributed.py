"""Multi-process runtime of the port: ``torch.distributed`` set up once.

Port of ``dss_ml_at_scale_tpu/runtime/distributed.py``. The JAX package
runs one process per host and reaches every local chip from it; here one
process drives one card, so a host with N cards runs N processes, each with
its own ``PROCESS_ID``. :func:`initialize_distributed` takes the same
arguments and environment variables as the JAX call
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``); without a
coordinator it does nothing and the run is one process.

The collectives the rest of the port needs live here too: the sum of a
tensor over the group that autograd differentiates (its gradient is the
sum of the ranks' gradients, as ``SyncBatchNorm``'s), the group the
BatchNorm statistics are reduced over, the mean of metrics over the
ranks, and the two differentiable moves of the parallel extras:
:func:`ring_shift` (JAX's ``lax.ppermute`` one hop round a ring, whose
transpose is the hop back) and :func:`all_to_all` (its own transpose).

On gloo the port hands point-to-point ops and ``all_to_all`` host copies
of CUDA tensors, explicitly (whether gloo would take device memory there
is not relied on), and logs the first such copy of each op
(:func:`host_routed` lists them). NCCL moves CUDA tensors as they are.
"""

from __future__ import annotations

import datetime
import logging
import os
import time

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# How long a collective (the rendezvous included) waits for the other ranks.
_TIMEOUT_S = 600.0


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    *,
    device: str | torch.device | None = None,
) -> bool:
    """Join this process to the process group of a multi-process run;
    True when this call set the group up (the caller then leaves it with
    :func:`shutdown_distributed`).

    Arguments fall back to ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
    ``PROCESS_ID``. Without a coordinator this is a no-op that latches
    nothing: a later call that does carry one still connects. The
    rendezvous is ``tcp://<coordinator>`` (``host:port`` of process 0); an
    address that already names a scheme (``file://<path>``) is used as it
    is. ``backend=None`` takes NCCL when ``device`` (default: a card if
    there is one) is a CUDA device and gloo otherwise; an explicit
    ``"gloo"`` also reduces CUDA tensors, through the host.
    """
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if dist.is_initialized():
        if coordinator_address is not None:
            log.warning("initialize_distributed called again with coordinator_address=%s "
                        "after the process group was set up; ignoring", coordinator_address)
        return False
    if coordinator_address is None:
        log.info("no coordinator address; running single-process")
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if cuda:
        torch.cuda.set_device(process_device(device, process_id))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    log.info("torch.distributed initialized: process %d/%d, backend %s",
             process_id, num_processes, backend)
    return True


# How long shutdown waits at its barrier for the other ranks.
_SHUTDOWN_TIMEOUT_S = 120.0


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one.

    Every rank first meets the others at a barrier, so that no rank tears
    down its gloo pairs while a peer still uses them. The wait is bounded
    (``_SHUTDOWN_TIMEOUT_S``): a rank whose peer died or hangs raises
    ``RuntimeError`` instead of hanging."""
    if not dist.is_initialized():
        return
    timeout = _SHUTDOWN_TIMEOUT_S
    if dist.get_backend() == "gloo":
        # gloo's monitored barrier keeps its bound, and leaves nothing
        # pending that the teardown would wait on.
        try:
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout),
                                   wait_all_ranks=True)
        finally:
            dist.destroy_process_group()
        return
    # Polled: a pending barrier must not hang this rank.
    work = dist.barrier(async_op=True)
    deadline = time.monotonic() + timeout
    while not work.is_completed() and time.monotonic() < deadline:
        time.sleep(0.005)
    if not work.is_completed():
        # Destroying the group would wait on the pending barrier, so the
        # group is left to the process's exit.
        raise RuntimeError(f"shutdown_distributed: the other ranks did not reach the "
                           f"barrier within {timeout:g} s")
    try:
        work.wait()
    finally:
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_device(device: str | torch.device, index: int | None = None) -> torch.device:
    """The card of this process: a bare ``cuda`` resolves to
    ``cuda:{process_index % device_count}``; anything else is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    index = process_index() if index is None else index
    return torch.device("cuda", index % max(1, torch.cuda.device_count()))


def stats_group():
    """The group the BatchNorm statistics are reduced over: every rank of
    a run of more than one process, else ``None`` (local statistics)."""
    return dist.group.WORLD if process_count() > 1 else None


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def group_rank(group=None) -> int:
    """This process's rank within ``group`` (``None``: every rank)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def global_rank(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


_HOST_ROUTED: set[str] = set()


def host_routed() -> list[str]:
    """The ops that have copied CUDA tensors through host memory for gloo."""
    return sorted(_HOST_ROUTED)


def _via_host(op: str, tensor: torch.Tensor, group) -> bool:
    if not tensor.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if op not in _HOST_ROUTED:
        _HOST_ROUTED.add(op)
        log.warning("gloo: %s of CUDA tensors is copied through host memory", op)
    return True


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` of every rank sent ``step`` ranks on round ``group``'s ring;
    returns what arrived from ``step`` ranks back."""
    size = group_size(group)
    if size == 1 or step % size == 0:
        return x.clone()
    me = group_rank(group)
    host = _via_host("send/recv", x, group)
    buf = (x.detach().cpu() if host else x.detach()).contiguous()
    out = torch.empty_like(buf)
    reqs = [dist.isend(buf, global_rank(group, (me + step) % size), group=group),
            dist.irecv(out, global_rank(group, (me - step) % size), group=group)]
    for req in reqs:
        req.wait()
    return out.to(x.device) if host else out


def send(x: torch.Tensor, dst: int) -> None:
    """``x`` to global rank ``dst`` (blocking)."""
    host = _via_host("send/recv", x, None)
    dist.send((x.detach().cpu() if host else x.detach()).contiguous(), dst)


def recv(like: torch.Tensor, src: int) -> torch.Tensor:
    """A tensor shaped, typed and placed as ``like``, from global rank ``src``."""
    host = _via_host("send/recv", like, None)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
    dist.recv(buf, src)
    return buf.to(like.device) if host else buf


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.step), None, None


def ring_shift(x: torch.Tensor, group=None, step: int = 1) -> torch.Tensor:
    """One hop round ``group``'s ring, differentiable: rank ``i`` gets rank
    ``i - step``'s ``x``; the gradient takes the hop back."""
    return _RingShift.apply(x, group, step)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    host = _via_host("all_to_all", x, group)
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if host else out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` is ``[ranks, ...]``: chunk ``j`` goes to rank ``j`` of
    ``group``, and chunk ``j`` of the result came from rank ``j``.
    Differentiable; the op is its own transpose."""
    if x.shape[0] != group_size(group):
        raise ValueError(f"all_to_all needs a leading axis of {group_size(group)} chunks, "
                         f"got {tuple(x.shape)}")
    return _AllToAll.apply(x, group)


def all_reduce_sum(tensor: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``tensor`` over ``group``, differentiable: the gradient
    that reaches each rank's input is the sum of every rank's gradient of
    the output (the rule ``SyncBatchNorm`` uses)."""
    return _AllReduceSum.apply(tensor, group)


def mean_over_ranks(values: dict[str, float]) -> dict[str, float]:
    """Each value's mean over the ranks (one all-reduce of f64 scalars);
    the values themselves in a one-process run."""
    if process_count() == 1 or not values:
        return values
    keys = sorted(values)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    buf = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(buf)
    buf /= process_count()
    return dict(zip(keys, buf.tolist()))
