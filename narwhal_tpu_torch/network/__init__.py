from .auth import AuthError, Credentials, Peer, cached_allow_sets, committee_resolver
from .pool import LanePool, node_pool, register_node_pool, unregister_node_pool
from .rpc import (
    LANE_PRIMARY,
    NetworkClient,
    PeerClient,
    PeerLink,
    RetryConfig,
    RpcError,
    RpcLaneUnavailable,
    RpcServer,
    RpcTimeout,
    WireCounters,
    worker_lane,
)

__all__ = [
    "AuthError",
    "Credentials",
    "LANE_PRIMARY",
    "LanePool",
    "NetworkClient",
    "Peer",
    "PeerClient",
    "PeerLink",
    "RetryConfig",
    "RpcError",
    "RpcLaneUnavailable",
    "RpcServer",
    "RpcTimeout",
    "WireCounters",
    "cached_allow_sets",
    "committee_resolver",
    "node_pool",
    "register_node_pool",
    "unregister_node_pool",
    "worker_lane",
]
