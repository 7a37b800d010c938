"""repro_torch.serve — the port's continuous-batching engine over the
paged KV pool, with the DAG-aware radix prefix cache (own copy of
``repro.serve.prefix_store``) and the step schedulers (own copy of
``repro.serve.scheduler``) underneath, and ``ReferencePrefixStore``
(own copy of ``repro.serve.reference``), the store's brute-force
oracle."""
from .engine import Request, ServeEngine, resolve_device
from .kv_pool import KVBlockPool, chain_block_nbytes
from .prefix_store import Node, PrefixStore
from .reference import ReferencePrefixStore
from .scheduler import (BudgetedScheduler, DecodeFirstScheduler,
                        FCFSScheduler, QueueFull, Scheduler, StepCostModel,
                        TracedRequest, latency_stats, make_scheduler,
                        play_trace)

__all__ = ["Request", "ServeEngine", "resolve_device", "KVBlockPool",
           "chain_block_nbytes", "Node", "PrefixStore",
           "ReferencePrefixStore", "BudgetedScheduler",
           "DecodeFirstScheduler", "FCFSScheduler", "QueueFull", "Scheduler",
           "StepCostModel", "TracedRequest", "latency_stats",
           "make_scheduler", "play_trace"]
