"""Multi-pod dry run; mirrors ``src/repro/launch/dryrun.py``: every
(arch × shape) cell on the production meshes — 256 ranks single-pod
(data=16, model=16) and 512 ranks multi-pod (pod=2, data=16, model=16) —
with per-rank memory, FLOPs and collectives. No array is ever allocated.

The process joins a fake process group of 256 or 512 ranks as rank 0
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing), builds the cell's mesh over it, and runs the cell's
step once under a ``FakeTensorMode``: every tensor is a fake of rank 0's
shard, so shapes and dtypes are exact and nothing is stored. What it
reports, per rank:

* ``memory.argument_bytes`` / ``output_bytes`` — the bytes of the local
  shards of the cell's arguments and outputs (exact; what XLA reports);
* ``memory.peak_bytes`` — the peak of live fake storage over the step,
  arguments included, tracked by this module's dispatch mode
  (``_Tracker``: every storage an op creates counts until it is freed).
  It is the port's eager measure, not XLA's buffer assignment;
* ``temp_bytes``, ``alias_bytes``, ``cost.bytes_accessed``,
  ``cost.transcendentals`` — ``null``: they have no torch counterpart;
* ``cost.flops`` — ``torch.utils.flop_counter``'s count of the local ops
  (matrix products and attention only: elementwise work is not counted);
* ``collectives`` — ``CommDebugMode``'s counts by kind, and wire bytes by
  ``hlo_analysis``'s formulas applied to each collective's tensor sizes;
* ``hbm_frac`` — ``peak_bytes`` over one H100 80GB HBM3's memory.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --json out.json

A cell the port does not run on a mesh yet reports ``ok: false`` with the
reason, and the command exits 1, as the reference does on a failed cell.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional
from unittest import mock

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor import placement_types
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..train import OptConfig, TrainConfig
from .mesh import make_mesh_context
from .specs import build_cell, pos_value

# per-card memory of one NVIDIA H100 80GB HBM3 (power limit 700 W), as
# torch.cuda.get_device_properties(0).total_memory reads it
H100_HBM_BYTES = 85_017_493_504

# per-arch production training recipe, the reference's
PROD_OVERRIDES = {
    "llama4_maverick_400b_a17b": {"moments_dtype": "bfloat16"},
}

# the functional collectives DTensor issues, by kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def join_fake_group(world: int) -> None:
    """This process as rank 0 of a fake group of ``world`` ranks (a group
    of another size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local(t) -> Optional[torch.Tensor]:
    return t._local_tensor if isinstance(t, DTensor) else (
        t if isinstance(t, torch.Tensor) else None)


def _bytes(tree) -> int:
    """Bytes of the local shards of every tensor leaf of ``tree``."""
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_bytes(v) for v in tree)
    t = _local(tree)
    return 0 if t is None else t.numel() * t.element_size()


class _Tracker(FakeTensorMode):
    """A ``FakeTensorMode`` that also sees every local op (the ops on
    plain fake tensors, below DTensor's dispatch): it counts their FLOPs
    with ``FlopCounterMode``'s formulas and tracks the storages they
    create until each is freed, keeping the peak of the live bytes.
    DTensor derives each op's global output shape by running it on
    global-shape fakes in this same mode, entered once more: ops seen
    while the mode is entered more than once are that, and not counted."""

    def __init__(self):
        super().__init__()
        self.flops = FlopCounterMode(display=False)
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, Any] = {}
        self._depth = 0

    def __enter__(self):
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        return super().__exit__(*exc)

    def _freed(self, key, nbytes, _ref):
        self.live -= nbytes
        self._seen.pop(key, None)

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = weakref.ref(
            st, lambda r, k=key, n=n: self._freed(k, n, r))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or self._depth > 1:
            return out
        self.flops._count_flops(func._overloadpacket, out, args,
                                kwargs or {})
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                self.track(t)
        return out


def _real_index_math():
    """DTensor works out a strided shard's local indices with ``arange``
    and ``tolist``, which a fake tensor cannot answer: a patch that runs
    that method outside the fake mode (none where this torch has no such
    method)."""
    cls = getattr(placement_types, "_StridedShard", None)
    fn = getattr(cls, "local_shard_size_and_offset", None)
    if fn is None:
        return contextlib.nullcontext()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with unset_fake_temporarily():
            return fn(*args, **kwargs)
    return mock.patch.object(cls, "local_shard_size_and_offset", run)


def _materialize(tree, mode: _Tracker):
    """Fake CPU tensors (DTensors of fake shards) of ``tree``'s meta
    layouts, made under ``mode``."""
    if isinstance(tree, dict):
        return {k: _materialize(v, mode) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        loc = tree._local_tensor
        with mode:
            fake = torch.empty(loc.shape, dtype=loc.dtype, device="cpu")
        return DTensor.from_local(fake, tree.device_mesh, tree.placements,
                                  run_check=False, shape=tree.shape,
                                  stride=tree.stride())
    with mode:
        return torch.empty(tree.shape, dtype=tree.dtype, device="cpu")


def _collectives(comm: CommDebugMode, wire: Dict[str, float]) -> Dict:
    """``CommDebugMode``'s counts by kind, and the wire bytes by kind."""
    counts: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _KINDS.get(op.__name__.split(".")[-1], str(op))
        counts[kind] = counts.get(kind, 0) + n
    return {"total_bytes": sum(wire.values()), "per_kind_bytes": wire,
            "per_kind_count": counts}


class _Wire(torch.utils._python_dispatch.TorchDispatchMode):
    """Per-kind wire bytes of the functional collectives, by the
    ``hlo_analysis`` formulas (n = the group's size): all-gather out − in,
    reduce-scatter in − out, all-reduce 2·out·(n−1)/n, all-to-all
    out·(n−1)/n."""

    def __init__(self):
        super().__init__()
        self.wire: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None:
            # (input, [reduce_op,] [group_size,] group_name)
            n = dist.get_world_size(
                dist.distributed_c10d._resolve_process_group(args[-1]))
            in_b = args[0].numel() * args[0].element_size()
            out_b = out.numel() * out.element_size()
            if kind == "all-gather":
                w = max(out_b - in_b, 0)
            elif kind == "reduce-scatter":
                w = max(in_b - out_b, 0)
            elif kind == "all-reduce":
                w = 2.0 * out_b * (n - 1) / max(n, 1)
            else:
                w = out_b * (n - 1) / max(n, 1)
            self.wire[kind] = self.wire.get(kind, 0.0) + w
        return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             unroll: int = 1, cfg_override=None, seq_shard: bool = True,
             microbatches: int = 1, with_collectives: bool = True,
             exact_causal: Optional[bool] = None,
             moments_dtype: str = "float32",
             mb_unroll: bool = False, mesh_ctx=None) -> Dict:
    """One cell's per-rank report. ``mesh_ctx``: a context over the
    initialized (fake) group to use instead of the production mesh."""
    t0 = time.time()
    if mesh_ctx is None:
        join_fake_group(512 if multi_pod else 256)
        mesh_ctx = make_mesh_context(multi_pod=multi_pod,
                                     seq_shard=seq_shard)
    cfg = cfg_override if cfg_override is not None else configs.get(arch)
    if exact_causal is not None:
        cfg = cfg.replace(exact_causal=exact_causal)
    tc = TrainConfig(opt=OptConfig(moments_dtype=moments_dtype),
                     unroll=unroll, microbatches=microbatches,
                     mb_unroll=mb_unroll)
    fn, args, _ = build_cell(arch, shape_name, mesh_ctx, train_cfg=tc,
                             cfg_override=cfg, unroll=unroll)
    kind = configs.SHAPES[shape_name].kind
    arg_bytes = _bytes(args)
    mode = _Tracker()
    call = [_materialize(a, mode) for a in args]
    if kind == "decode":
        call[3] = pos_value(shape_name)
    comm, wire = CommDebugMode(), _Wire()
    ctx = [comm, wire] if with_collectives else []
    for c in ctx:
        c.__enter__()
    try:
        with mode, _real_index_math():
            out = fn(*call)
    finally:
        for c in reversed(ctx):
            c.__exit__(None, None, None)
    out_bytes = _bytes(out)
    mem = {"argument_bytes": float(arg_bytes),
           "output_bytes": float(out_bytes),
           "temp_bytes": None, "alias_bytes": None,
           "peak_bytes": float(mode.peak)}
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh_ctx.mesh.shape),
        "devices": mesh_ctx.mesh.size(),
        "ok": True,
        "memory": mem,
        "hbm_frac": mem["peak_bytes"] / H100_HBM_BYTES,
        "cost": {"flops": float(mode.flops.get_total_flops()),
                 "flops_counted": "matmul and attention only",
                 "bytes_accessed": None, "transcendentals": None},
        "collectives": (_collectives(comm, wire.wire) if with_collectives
                        else {}),
        "compile_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs)")
    ap.add_argument("--shape", choices=list(configs.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every cell on both meshes")
    ap.add_argument("--single-mesh", action="store_true",
                    help="with --all: only the mesh selected by --multi-pod")
    ap.add_argument("--unroll", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=8,
                    help="grad-accumulation steps for train cells "
                         "(production default 8; memory/compute trade)")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--json", help="write results to this file")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s, mp) for (a, s) in configs.cells()
                 for mp in ((args.multi_pod,) if args.single_mesh
                            else (False, True))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        cells = [(configs.canonical(args.arch), args.shape, args.multi_pod)]

    results, failures = [], 0
    for arch, shape, mp in cells:
        label = f"{arch:28s} {shape:12s} {'2x16x16' if mp else '16x16'}"
        over = PROD_OVERRIDES.get(arch, {})
        try:
            r = run_cell(arch, shape, multi_pod=mp, unroll=args.unroll,
                         microbatches=args.microbatches,
                         seq_shard=not args.no_seq_shard, **over)
            print(f"[ok]   {label}  peak/dev={r['memory']['peak_bytes']/2**30:7.2f} GiB"
                  f" ({100*r['hbm_frac']:5.1f}% HBM)"
                  f"  flops={r['cost']['flops']:.3e}"
                  f"  coll={r['collectives'].get('total_bytes', 0)/2**20:9.1f} MiB"
                  f"  {r['compile_s']:6.1f}s", flush=True)
        except Exception as e:
            failures += 1
            r = {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if mp else "16x16", "ok": False,
                 "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {label}  {type(e).__name__}: {e}", flush=True)
            traceback.print_exc(limit=3)
        results.append(r)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.json}")
    print(f"\n{len(results) - failures}/{len(results)} cells compiled")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
