"""repro_torch.serve — the port's continuous-batching engine over the
paged KV pool, with the DAG-aware radix prefix cache (own copy of
``repro.serve.prefix_store``) and the step schedulers (own copy of
``repro.serve.scheduler``) underneath, and ``ReferencePrefixStore``
(own copy of ``repro.serve.reference``), the store's brute-force oracle.
``TieredKVStore`` (own copy of ``repro.serve.tiered``) with
``HostBlockPool`` and ``DiskBlockPool`` (own copy of
``repro.serve.disk_pool``) adds the compressed tier ladder: device-pressure
victims demote to page-locked host memory (optionally transcoded to
int8/fp8 by ``repro_torch.quant``), host-pressure victims to a file-backed
disk tier, and demoted chains promote back on reuse instead of being
recomputed. ``LegacyServeEngine`` (mirroring ``repro.serve.legacy``) is
the frozen token-at-a-time baseline with host KV round-trips that the
engine is held to. ``ShardedFrontend`` and ``route_prefix`` (mirroring
``repro.serve.sharded``) put K engines behind one prefix-affinity router,
each a worker of one coordination bus."""
from .disk_pool import DiskBlockPool
from .engine import Request, ServeEngine, resolve_device
from .host_pool import HostBlockPool
from .kv_pool import KVBlockPool, chain_block_nbytes
from .legacy import LegacyServeEngine
from .prefix_store import Node, PrefixStore
from .reference import ReferencePrefixStore
from .scheduler import (BudgetedScheduler, DecodeFirstScheduler,
                        FCFSScheduler, QueueFull, Scheduler, StepCostModel,
                        TracedRequest, TraceReport, latency_stats,
                        make_scheduler, play_trace)
from .sharded import ShardedFrontend, route_prefix
from .tiered import TieredKVStore

__all__ = ["Request", "ServeEngine", "LegacyServeEngine", "resolve_device",
           "KVBlockPool", "chain_block_nbytes", "HostBlockPool", "DiskBlockPool", "Node",
           "PrefixStore", "ReferencePrefixStore", "ShardedFrontend",
           "TieredKVStore", "route_prefix",
           "BudgetedScheduler", "DecodeFirstScheduler", "FCFSScheduler",
           "QueueFull", "Scheduler", "StepCostModel", "TracedRequest",
           "TraceReport", "latency_stats", "make_scheduler", "play_trace"]
