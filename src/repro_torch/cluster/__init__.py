"""Distributed skim cluster (DESIGN.md §5).

Sharded storage nodes + scatter-gather coordinator + content-addressed
skim-result cache: the multi-node layer over the single-node fast
path.  ``build_cluster`` wires the whole stack in one call; merged
cluster output is bit-identical to the single-node ``run_skim`` result
for any node count, shard policy, replica retry, or cache state.
"""

from repro_torch.cluster.cache import (
    CacheStats,
    SkimResultCache,
    cache_key,
    canonical_query,
    query_hash,
    versioned_key,
)
from repro_torch.cluster.coordinator import (
    ClusterBatchResult,
    ClusterCoordinator,
    ClusterError,
    ClusterSkimResult,
    DegradedResult,
    IntegrityError,
    NodeTimeout,
    ShardError,
    build_cluster,
    merge_responses,
)
from repro_torch.cluster.retry import (
    DEFAULT_RETRY_POLICY,
    HedgePolicy,
    RetryEvent,
    RetryPolicy,
    classify_fault,
)
from repro_torch.cluster.node import (
    BatchResponse,
    NodeFailure,
    NodeResponse,
    StorageNode,
)
from repro_torch.cluster.shard import Shard, ShardMap, partition_store, window_spans

__all__ = [
    "BatchResponse",
    "CacheStats",
    "ClusterBatchResult",
    "ClusterCoordinator",
    "ClusterError",
    "ClusterSkimResult",
    "DEFAULT_RETRY_POLICY",
    "DegradedResult",
    "HedgePolicy",
    "IntegrityError",
    "NodeFailure",
    "NodeResponse",
    "NodeTimeout",
    "RetryEvent",
    "RetryPolicy",
    "Shard",
    "ShardError",
    "classify_fault",
    "ShardMap",
    "SkimResultCache",
    "StorageNode",
    "build_cluster",
    "cache_key",
    "canonical_query",
    "merge_responses",
    "partition_store",
    "query_hash",
    "versioned_key",
    "window_spans",
]
