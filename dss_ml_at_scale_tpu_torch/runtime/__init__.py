"""Multi-process runtime of the port: ``torch.distributed``, and the small
host-level RPC of the control plane (:mod:`.rpc`)."""

from .distributed import (
    all_reduce_sum,
    all_to_all,
    barrier,
    host_routed,
    initialize_distributed,
    mean_over_ranks,
    process_count,
    process_device,
    process_index,
    ring_shift,
    shutdown_distributed,
    stats_group,
)
from .rpc import (
    RpcAuthError,
    RpcConnectTimeout,
    RpcHandshakeTimeout,
    RpcRemoteError,
    RpcServer,
    rpc_call,
)
from .topology import Topology, local_topology

__all__ = [
    "RpcAuthError",
    "RpcConnectTimeout",
    "RpcHandshakeTimeout",
    "RpcRemoteError",
    "RpcServer",
    "Topology",
    "all_reduce_sum",
    "all_to_all",
    "barrier",
    "host_routed",
    "initialize_distributed",
    "local_topology",
    "mean_over_ranks",
    "process_count",
    "process_device",
    "process_index",
    "ring_shift",
    "rpc_call",
    "shutdown_distributed",
    "stats_group",
]
