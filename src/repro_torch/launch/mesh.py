"""Mesh construction; mirrors ``src/repro/launch/mesh.py`` for the serve
plane only. The production training meshes wait for mesh-sharded training
(ROADMAP.md §1, item 6)."""
from __future__ import annotations

from ..sharding import KVShardCtx, serve_tp_context


def make_serve_tp_context(tp: int, device=None) -> KVShardCtx:
    """The serve plane's tensor parallelism over ``tp`` ranks, one process
    each: this process's rank in the initialized group (at tp=1, a
    one-rank group of its own), sharding the paged KV pool's head
    dimension."""
    return serve_tp_context(tp, device)
