"""Logical-axis partition rules and the serve plane's tensor parallelism;
mirrors ``src/repro/sharding/rules.py``.

Parameters carry logical axis names (``ParamSpec.axes``); ``MeshContext``
maps them onto the axes of a device mesh, as the reference's rule table
does:

* TP axes (``heads``, ``kv_heads``, ``ff``, ``vocab``, ``experts``,
  ``rnn``, ``rnn_blocks``) shard over ``model``.
* ``embed`` shards over the FSDP axes (``("pod","data")`` multi-pod,
  ``("data",)`` single-pod).
* ``layer`` (the stacked-layer axis) stays replicated.

Every assignment is divisibility-checked against the mesh and each mesh
axis is used at most once per tensor; dims that do not divide stay
replicated. The rules return a ``PartitionSpec`` of this module (a tuple:
one entry per dim, an axis name, a tuple of names, or None); for them the
"mesh" needs only its axis sizes (a ``.shape`` mapping of axis name to
size will do). The methods that lower a tensor onto a mesh
(``param_sharding``, ``constrain_tree``, ``batch_sharding``,
``constrain_dims``, ``gather_seq``, ``shard_activations``,
``cache_sharding``, ``replicated``) need a
``torch.distributed.device_mesh.DeviceMesh``, one process a rank: a
``PartitionSpec`` becomes DTensor placements (``MeshContext.placements``)
and a sharding constraint a ``redistribute``. This is SPMD, where the
reference is single-controller: each process holds its own shards.

``KVShardCtx`` is the serve plane's tensor parallelism on
``torch.distributed``: one process per rank, each running the same engine
on replicated weights and holding the KV heads ``[r·KV/tp, (r+1)·KV/tp)``
of every pool leaf. ``serve_tp_context`` gives the context of this
process's rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ..models.common import ModelConfig, ParamSpec, meta_dtensor, tree_map

# logical axis -> candidate physical axis group, in priority order
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "rnn": ("model",),
    "rnn_blocks": ("model",),
    "embed": ("fsdp",),
    "head_dim": (),
    "layer": (),
}

# how long a collective of a group made here waits for its peers
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass
class MeshContext:
    """The partition rules over a mesh's axis sizes (``mesh.shape``)."""

    mesh: Optional[Any]
    data_axes: Tuple[str, ...] = ("data",)     # batch / FSDP axes
    model_axis: str = "model"
    seq_shard: bool = True                     # SP: shard seq dim over model
    fsdp_params: bool = True                   # ZeRO-3 parameter sharding

    # ------------------------------------------------------------------ sizes
    def axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        names = getattr(self.mesh, "mesh_dim_names", None)
        if names is not None:               # a DeviceMesh
            return self.mesh.size(tuple(names).index(name))
        return self.mesh.shape[name]        # a mapping of axis sizes

    @property
    def dp_size(self) -> int:
        return int(np.prod([self.axis_size(a) for a in self.data_axes]))

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.model_axis)

    def _expand(self, group: str) -> Tuple[str, ...]:
        if group == "fsdp":
            return self.data_axes if self.fsdp_params else ()
        return (group,)

    # ------------------------------------------------------------- param spec
    def param_pspec(self, spec: ParamSpec,
                    fsdp: Optional[bool] = None) -> PartitionSpec:
        """PartitionSpec for one parameter from its logical axes.
        ``fsdp=False`` drops the FSDP axes (the *gathered* per-layer layout
        a weight takes while its layer executes)."""
        used: set = set()
        out = []
        fsdp_on = self.fsdp_params if fsdp is None else fsdp
        for dim, logical in zip(spec.shape, spec.axes):
            assigned: Any = None
            if logical is not None:
                for group in LOGICAL_RULES.get(logical, ()):
                    axes = (self.data_axes if fsdp_on else ()) \
                        if group == "fsdp" else (group,)
                    if not axes or any(a in used for a in axes):
                        continue
                    size = int(np.prod([self.axis_size(a) for a in axes]))
                    if size > 1 and dim % size == 0:
                        assigned = axes if len(axes) > 1 else axes[0]
                        used.update(axes)
                        break
            out.append(assigned)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    # -------------------------------------------------------------- batch dims
    def _dim_axes(self, dim: int, candidates: Sequence[str],
                  used: set) -> Any:
        """Largest prefix of ``candidates`` whose product divides ``dim``."""
        picked = []
        for a in candidates:
            if a in used:
                break
            nxt = picked + [a]
            size = int(np.prod([self.axis_size(x) for x in nxt]))
            if dim % size != 0:
                break
            picked = nxt
        if not picked:
            return None
        used.update(picked)
        return tuple(picked) if len(picked) > 1 else picked[0]

    def batch_pspec(self, shape: Tuple[int, ...]) -> PartitionSpec:
        """(B, S, ...) activations / tokens: B over data axes; S over model
        (sequence parallelism) when enabled and divisible."""
        used: set = set()
        b = self._dim_axes(shape[0], self.data_axes, used)
        rest: list = [None] * (len(shape) - 1)
        if len(shape) >= 2 and self.seq_shard:
            s = self._dim_axes(shape[1], (self.model_axis,), used)
            rest[0] = s
        return P(b, *rest)

    # ------------------------------------------------------------- cache spec
    def cache_pspec(self, path: Tuple[str, ...],
                    shape: Tuple[int, ...]) -> PartitionSpec:
        """Decode-cache leaves. Layout conventions (models/api):
        KV: (..., B, S, KV_heads, D); recurrent h: (..., B, W);
        rwkv S: (..., B, H, N, N); shifts/conv keep B only.
        Leading stacked ``layer`` dims are detected by path containing
        'stack' or encdec stacked caches (k/v/ck/cv with ndim 5).
        """
        name = path[-1]
        used: set = set()
        n_lead = 0
        if any(p == "stack" for p in path[:-1]):
            n_lead = 1
        elif name in ("k", "v", "ck", "cv") and len(shape) == 5:
            n_lead = 1  # encdec stacked (nL, B, S, KV, D)
        dims: list = [None] * len(shape)
        bdim = n_lead
        if name in ("k", "v", "ck", "cv"):
            b, s, kv = shape[bdim], shape[bdim + 1], shape[bdim + 2]
            dims[bdim] = self._dim_axes(b, self.data_axes, used)
            if dims[bdim] is None or (
                    isinstance(dims[bdim], str) and len(self.data_axes) > 1):
                # long-context small-batch: spread the sequence dim instead
                leftover = [a for a in self.data_axes if a not in used]
                dims[bdim + 1] = self._dim_axes(s, leftover, used)
            dims[bdim + 2] = self._dim_axes(kv, (self.model_axis,), used)
            if dims[bdim + 2] is None and dims[bdim + 1] is None:
                # few KV heads (MQA/whisper): spread sequence over model
                dims[bdim + 1] = self._dim_axes(s, (self.model_axis,), used)
        elif name == "h":                       # rg-lru state (..., B, W)
            dims[bdim] = self._dim_axes(shape[bdim], self.data_axes, used)
            dims[-1] = self._dim_axes(shape[-1], (self.model_axis,), used)
        elif name == "conv":                    # (..., B, K-1, W)
            dims[bdim] = self._dim_axes(shape[bdim], self.data_axes, used)
            dims[-1] = self._dim_axes(shape[-1], (self.model_axis,), used)
        elif name == "S":                       # rwkv (..., B, H, N, N)
            dims[bdim] = self._dim_axes(shape[bdim], self.data_axes, used)
            dims[bdim + 1] = self._dim_axes(shape[bdim + 1],
                                            (self.model_axis,), used)
        else:                                   # shifts: (..., B, d)
            dims[bdim] = self._dim_axes(shape[bdim], self.data_axes, used)
        while dims and dims[-1] is None:
            dims.pop()
        return P(*dims)

    # --------------------------------------------- lowering onto a mesh
    # Each method mirrors the reference's, with a DTensor placement where
    # the reference has a NamedSharding and ``redistribute`` where it has
    # ``with_sharding_constraint``: the collectives XLA's partitioner
    # would insert (the FSDP all-gather and its backward reduce-scatter,
    # the SP all-gather and reduce-scatter) are DTensor's. Without a mesh
    # each returns its input unchanged (or None), as the reference's do.

    def _mesh_dims(self) -> Tuple[str, ...]:
        """The mesh's dim names; a mesh that has only axis sizes (no
        ``DeviceMesh``) cannot lower a tensor, and raises."""
        names = getattr(self.mesh, "mesh_dim_names", None)
        if names is None:
            raise TypeError(
                "lowering onto a mesh needs a torch.distributed "
                "DeviceMesh; this context's mesh has only axis sizes (the "
                "rules, param_pspec, batch_pspec and cache_pspec, need no "
                "more)")
        return tuple(names)

    def placements(self, spec: Sequence) -> List[Placement]:
        """DTensor placements, one a mesh dim, of a ``PartitionSpec``: mesh
        dim ``i`` is ``Shard(t)`` when tensor dim ``t`` names its axis,
        alone or in a tuple, else ``Replicate()``. A tuple shards one
        tensor dim over several mesh dims, the first named the major one,
        as in JAX; DTensor splits a dim over its mesh dims in mesh order,
        so the tuple's axes must come in that order."""
        names = self._mesh_dims()
        out: List[Placement] = [Replicate()] * len(names)
        for t, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"{entry!r} shards one dim over mesh axes out of the "
                    f"mesh's order {names}: the major axis must come first")
            for i in idx:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"mesh axis {names[i]!r} used twice "
                                     f"in {spec!r}")
                out[i] = Shard(t)
        return out

    def meta(self, shape: Sequence[int], dtype: torch.dtype,
             placements: Sequence[Placement]) -> DTensor:
        """A DTensor of global ``shape`` laid out by ``placements`` whose
        local shard is a meta tensor of this rank's shape."""
        return meta_dtensor(shape, dtype, self.mesh, placements)

    def distribute(self, t: torch.Tensor,
                   placements: Sequence[Placement]) -> DTensor:
        """``t``, the same full tensor on every rank, as a DTensor: each
        rank keeps a view of its own shard (so ``t``'s storage stays, and
        nothing is copied where the shard is the whole), with no
        collective. A tensor dim sharded over several mesh dims splits
        over them in mesh order, as ``distribute_tensor`` splits it."""
        local = t
        coord = self.mesh.get_coordinate()
        for i, pl in enumerate(placements):
            if isinstance(pl, Shard):
                n = local.shape[pl.dim] // self.mesh.size(i)
                local = local.narrow(pl.dim, coord[i] * n, n)
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    def _redistribute(self, t, placements: Sequence[Placement]):
        if not isinstance(t, DTensor):
            raise TypeError(f"a tensor on a mesh must be a DTensor, got "
                            f"{type(t).__name__}")
        if tuple(t.placements) == tuple(placements):
            return t
        return t.redistribute(self.mesh, placements)

    def param_sharding(self, spec: ParamSpec) -> Optional[List[Placement]]:
        if self.mesh is None:
            return None
        return self.placements(self.param_pspec(spec))

    def constrain_tree(self, tree, spec_tree, fsdp: Optional[bool] = None):
        """Redistribute a (possibly per-layer-sliced) param tree to its
        rule-derived placements. Used per sublayer with ``fsdp=False``:
        the redistribution all-gathers each layer's weights over the FSDP
        axes in their stored dtype (bf16) right before use, and its
        backward reduce-scatters the weight gradients back, so they never
        materialize replicated."""
        if self.mesh is None:
            return tree
        self._mesh_dims()
        return tree_map(
            lambda t, s: self._redistribute(
                t, self.placements(self.param_pspec(s, fsdp=fsdp))),
            tree, spec_tree)

    def batch_sharding(self, shape, dtype=torch.int32):
        """A meta DTensor of ``shape`` laid out by ``batch_pspec`` (a meta
        tensor of ``shape`` without a mesh)."""
        if self.mesh is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        return self.meta(shape, dtype, self.placements(
            self.batch_pspec(tuple(shape))))

    def dims_pspec(self, shape: Sequence[int], dims) -> PartitionSpec:
        """``constrain_dims``'s spec: one axis-group candidate per dim;
        non-divisible dims fall back to replicated."""
        used: set = set()
        out = []
        for size, cand in zip(shape, dims):
            if cand is None:
                out.append(None)
                continue
            cands = cand if isinstance(cand, tuple) else (cand,)
            out.append(self._dim_axes(size, cands, used))
        return P(*out)

    def constrain_dims(self, x, dims):
        """Megatron-SP style explicit layout: ``dims`` is one axis-group
        candidate (axis name, tuple of names, or None) per tensor dim;
        non-divisible dims fall back to replicated. Examples:
          MLP intermediate (B,S,2,f): (data_axes, None, None, model)
          q after projection (B,S,H,D): (data_axes, None, model, None)
        """
        if self.mesh is None:
            return x
        return self._redistribute(
            x, self.placements(self.dims_pspec(x.shape, dims)))

    def gather_seq(self, x):
        """Enter a TP region: batch stays on the data axes, sequence (and
        everything else) gathered — the SP all-gather on layer entry."""
        if self.mesh is None:
            return x
        return self.constrain_dims(x, (self.data_axes,)
                                   + (None,) * (x.ndim - 1))

    def shard_activations(self, h):
        """Residual-stream layout: (B, S, d) -> batch over data axes, seq
        over model (SP). Non-divisible dims stay replicated. A partial sum
        (a row-parallel product's output) reduce-scatters into it."""
        if self.mesh is None:
            return h
        return self._redistribute(
            h, self.placements(self.batch_pspec(tuple(h.shape))))

    def cache_sharding(self, path, shape, dtype):
        """A meta DTensor of a decode-cache leaf laid out by
        ``cache_pspec`` (a meta tensor without a mesh)."""
        if self.mesh is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        self._mesh_dims()
        return self.meta(shape, dtype, self.placements(
            self.cache_pspec(tuple(path), tuple(shape))))

    def replicated(self) -> Optional[List[Placement]]:
        if self.mesh is None:
            return None
        return [Replicate()] * len(self._mesh_dims())

    # ------------------------------------------------ the model axis' group
    def model_dim(self) -> int:
        """The mesh dim of the model axis."""
        return tuple(self.mesh.mesh_dim_names).index(self.model_axis)

    def model_rank(self) -> int:
        """This rank's coordinate along the model axis."""
        return self.mesh.get_local_rank(self.model_axis)

    def model_group(self):
        """The process group of this rank's model axis."""
        return self.mesh.get_group(self.model_axis)


def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """The functional all-reduce of ``x`` over ``group`` (a new tensor),
    waited on."""
    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the sum over the group, the same on every rank. Backward:
    the identity, since every rank's consumer of the sum is the same (the
    Megatron ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity on a tensor every rank of the group holds
    whole. Backward: the sum of the ranks' gradients, each rank having
    used the tensor for its own share of the work (the Megatron ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), "sum", ctx.group), None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (an all-reduce; a no-op without a
    group), differentiable: the reference's ``psum`` inside ``shard_map``
    for an output every rank then uses whole."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as is, with its gradient summed over ``group`` (a no-op
    without a group): an input every rank of the group holds whole and
    uses for its own share of the work."""
    return x if group is None else _CopyToGroup.apply(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (not differentiable;
    ``x`` itself without a group)."""
    return x if group is None else _all_reduce(x, "max", group)


def local_context() -> MeshContext:
    """Single-device context: no mesh."""
    return MeshContext(mesh=None, data_axes=(), seq_shard=False)


# ---------------------------------------------------------------------------
# Serve-plane tensor parallelism
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KVShardCtx:
    """Tensor parallelism of the *paged serve plane* over a
    ``torch.distributed`` group of ``tp`` processes, one a rank.

    Every rank runs the same engine, store and scheduler on replicated
    weights and makes the same host-side decisions: block tables,
    refcounts and every store structure are rank-invariant, and a pool row
    index means the same block on every rank. Rank ``r`` holds KV heads
    ``kv_heads(KV)`` of each pool leaf and computes attention for the
    query heads ``heads(H)``; under GQA packing a contiguous H/tp query
    slice owns exactly its KV slice's head groups. The attention outputs
    are all-gathered over heads before the (replicated) output projection,
    so every rank computes ``wo`` in single-device order and the tokens
    are those of tp=1. ``device`` is the rank's device (a CUDA group is
    NCCL, a CPU group gloo).

    Deliberately not a ``MeshContext``: serving shards attention only,
    with replicated parameters."""

    group: Any
    tp: int
    rank: int
    device: torch.device

    def heads(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` heads."""
        per = n // self.tp
        return slice(self.rank * per, (self.rank + 1) * per)

    def validate(self, cfg: ModelConfig) -> None:
        if cfg.kv_heads % self.tp:
            raise ValueError(
                f"tensor parallelism tp={self.tp} needs the KV-head count "
                f"to divide evenly; {cfg.arch} has kv_heads={cfg.kv_heads}")

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, H/tp, D) on every rank -> (B, S, H, D), rank r's heads at
        ``r·H/tp``. The collective runs at tp=1 too."""
        B, S, h, D = x.shape
        out = x.new_empty((self.tp * B, S, h, D))
        _all_gather(out, x.contiguous(), self.group)
        return (out.view(self.tp, B, S, h, D).permute(1, 2, 0, 3, 4)
                .reshape(B, S, self.tp * h, D))

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the group (a copy, on ``t``'s
        device); exact, so every rank gets the same values."""
        buf = t.to(self.device, copy=True)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.to(t.device)

    def bind(self, spec):
        """``spec`` (a ``quant.QuantSpec`` or None) with its amax reduced
        over the group: a (row, layer) block's scale is then its scale at
        tp=1 on every rank."""
        if spec is None:
            return None
        return dataclasses.replace(spec, reduce_amax=self.all_max)


def _all_gather(out, x, group) -> None:
    """``all_gather_into_tensor`` under whichever name this torch has."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def rank_dir(path: Optional[str], tp: int) -> Optional[str]:
    """A directory of this rank's own under ``path`` (``rank{r}``) when
    ``tp > 1``: each rank's disk tier holds its own head slice."""
    if path is None or tp == 1:
        return path
    return os.path.join(path, f"rank{dist.get_rank()}")


def _rank_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def serve_tp_context(tp: int, device=None) -> KVShardCtx:
    """The context of this process's rank in a group of ``tp``: the
    initialized default group, which must have ``tp`` ranks; at tp=1 with
    no group, a one-rank group of its own over a ``FileStore`` (NCCL on
    CUDA, gloo on the CPU). ``device`` is the rank's device (default: the
    current CUDA device). One eager collective warms the group up, so
    that a step captured after it can hold the group's collectives."""
    dev = _rank_device(device)
    if dist.is_initialized():
        n = dist.get_world_size()
        if n != tp:
            raise ValueError(
                f"--tp {tp} needs {tp} ranks but the process group has "
                f"{n}")
    elif tp == 1:
        from ..launch.ranks import init_local_group
        init_local_group(dev.type, GROUP_TIMEOUT.total_seconds())
    else:
        raise ValueError(
            f"--tp {tp} needs {tp} ranks but no process group is "
            "initialized: run one process per rank (repro_torch.launch."
            f"serve --tp {tp} starts them; on CUDA one card a rank, on the "
            "CPU gloo)")
    ctx = KVShardCtx(group=dist.group.WORLD, tp=tp, rank=dist.get_rank(),
                     device=dev)
    ctx.all_max(torch.zeros(1, device=dev))
    return ctx
