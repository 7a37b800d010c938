"""Mesh construction; mirrors ``src/repro/launch/mesh.py``.

Defined as FUNCTIONS (never module-level constants), as in the reference.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
initialized process group, one process a rank: NCCL on the card, gloo on
the CPU, or a fake group (``torch.testing._internal.distributed.fake_pg``)
for the dry run, where rank 0 stands in for a 256- or 512-rank mesh
without allocating. A mesh whose size differs from the group's raises.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sharding import KVShardCtx, MeshContext, serve_tp_context

# the mesh's device type a backend serves
_DEVICE_TYPES = {"nccl": "cuda", "gloo": "cpu", "fake": "cpu"}


def make_serve_tp_context(tp: int, device=None) -> KVShardCtx:
    """The serve plane's tensor parallelism over ``tp`` ranks, one process
    each: this process's rank in the initialized group (at tp=1, a
    one-rank group of its own), sharding the paged KV pool's head
    dimension."""
    return serve_tp_context(tp, device)


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized process group of "
            f"{math.prod(shape)} ranks (launch.ranks.init_rank, or a fake "
            "group for the dry run)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {math.prod(shape)} "
            f"ranks but the process group has {world}")
    backend = str(dist.get_backend()).lower()
    return init_device_mesh(_DEVICE_TYPES.get(backend, "cpu"), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """Single pod: 256 ranks as (data=16, model=16). Multi-pod: 2 pods,
    512 ranks as (pod=2, data=16, model=16) — the ``pod`` axis carries
    cross-pod data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_mesh_context(*, multi_pod: bool = False,
                      seq_shard: bool = True,
                      fsdp_params: bool = True) -> MeshContext:
    mesh = make_production_mesh(multi_pod=multi_pod)
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return MeshContext(mesh=mesh, data_axes=data_axes, model_axis="model",
                       seq_shard=seq_shard, fsdp_params=fsdp_params)


def make_debug_mesh_context(shape: Tuple[int, ...] = (2, 2),
                            axes: Tuple[str, ...] = ("data", "model"),
                            **kw) -> MeshContext:
    """A small mesh over the ranks of the initialized group (four gloo
    ranks on the CPU for (2, 2); one NCCL rank on one card for (1, 1))."""
    mesh = _mesh(tuple(shape), tuple(axes))
    data_axes = tuple(a for a in axes if a != "model")
    return MeshContext(mesh=mesh, data_axes=data_axes, model_axis="model",
                       **kw)
