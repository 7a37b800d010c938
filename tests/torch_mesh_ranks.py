"""The port's side of ``tests/test_torch_mesh.py``; imports no JAX.

* ``main(jobdir)`` — a rank of a (2, 2) mesh over four gloo ranks
  (``python -m repro_torch.launch.ranks torch_mesh_ranks:main JOBDIR``):
  for each case of ``JOBDIR/job.pkl`` (an arch's smoke config in f32, the
  reference's weights as numpy, a batch), the loss and the full gradients
  on the mesh, the assignments the EP MoE's capacity dropped (summed over
  the ranks) and, for the case marked ``adamw``, the parameters after one
  AdamW step on the mesh. Rank 0 writes ``JOBDIR/port_mesh.pkl``.
* ``python tests/torch_mesh_ranks.py JOBDIR shapes`` — the fake-group
  cases, in a process of their own: rank 0's local shape of every
  train-state leaf for every arch on both production meshes, rank r's
  shard of a pod-major tensor, a mesh larger than the group, the smoke
  decode cells whose cache shards the sequence (their reports); written to
  ``JOBDIR/port_fake_shapes.pkl``. ``... JOBDIR cells ARCH``: the
  argument and output bytes of ARCH's smoke cells on a (2, 2) mesh, to
  ``JOBDIR/port_fake_cells_ARCH.pkl``.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path


# the smoke cells whose bytes are held to the reference's compiled ones
# (qwen2's decode cache shards the sequence, gemma2's its heads)
BYTES_CELLS = [("qwen2_7b", "train_4k"), ("qwen2_7b", "prefill_32k"),
               ("qwen2_7b", "decode_32k"),
               ("gemma2_27b", "train_4k"), ("gemma2_27b", "prefill_32k"),
               ("gemma2_27b", "decode_32k"),
               ("moonshot_v1_16b_a3b", "train_4k"),
               ("moonshot_v1_16b_a3b", "prefill_32k")]
# AdamW of the step cases: eps=1e-3, as tests/test_torch_train.py runs it
ADAMW = dict(lr=3e-4, warmup_steps=1, total_steps=3, eps=1e-3)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def main(jobdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh_context
    from repro_torch.models import loss_fn, model_spec, params_from_numpy
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import tree_map, tree_paths, unflatten
    from repro_torch.train import (OptConfig, TrainConfig, adamw_init,
                                   build_train_step)

    job = pickle.loads(Path(jobdir, "job.pkl").read_bytes())
    mc = make_debug_mesh_context((2, 2))
    out = {}
    for case in job["cases"]:
        cfg = configs.get(case["arch"], smoke=True).replace(
            dtype=torch.float32)
        spec = model_spec(cfg)
        params = tree_map(lambda t, s: mc.distribute(t, mc.param_sharding(s)),
                          params_from_numpy(case["params"]), spec)
        batch = {k: mc.distribute(torch.from_numpy(v), mc.placements(
            mc.batch_pspec(v.shape))) for k, v in case["batch"].items()}
        moe_mod.DROP_LOG = []
        leaves = {p: t.detach().requires_grad_(True)
                  for p, t in tree_paths(params)}
        loss = loss_fn(cfg, mc.constrain_tree(unflatten(leaves), spec),
                       batch, mesh_ctx=mc)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        dropped = torch.zeros((), dtype=torch.long)
        for n in moe_mod.DROP_LOG:
            dropped += n
        moe_mod.DROP_LOG = None
        dist.all_reduce(dropped)
        res = {"loss": float(loss.full_tensor()),
               "dropped": int(dropped),
               "grads": {"/".join(p): g.full_tensor().numpy()
                         for p, g in zip(leaves, grads)}}
        if case.get("adamw"):
            oc = OptConfig(**ADAMW)
            state = {"params": params, "opt": adamw_init(params, oc)}
            step = build_train_step(cfg, TrainConfig(opt=oc), mc)
            state, metrics = step(state, batch)
            res["step_loss"] = float(metrics["loss"].full_tensor())
            res["new_params"] = {k: v.full_tensor().numpy() for k, v in
                                 _flat(state["params"]).items()}
        out[case["arch"]] = res
    if dist.get_rank() == 0:
        Path(jobdir, "port_mesh.pkl").write_bytes(pickle.dumps(out))


def fake_main(jobdir: str, part: str, arch: str = "") -> None:
    """``part`` "shapes": the train-state shapes, the pod-major shards,
    a mismatched mesh and the sequence-sharded decode cells; "cells":
    ``arch``'s cells' bytes."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (make_debug_mesh_context,
                                         make_mesh_context)
    from repro_torch.train import TrainConfig, abstract_train_state

    if part == "cells":
        dryrun.join_fake_group(4)
        mc = make_debug_mesh_context((2, 2))
        cells = {}
        for a, shape in BYTES_CELLS:
            if a == arch:
                cells[(a, shape)] = dryrun.run_cell(
                    a, shape, mesh_ctx=mc, microbatches=1,
                    cfg_override=configs.get(a, smoke=True))["memory"]
        Path(jobdir, f"port_fake_cells_{arch}.pkl").write_bytes(
            pickle.dumps(cells))
        return
    shapes = {}
    for multi_pod in (False, True):
        dryrun.join_fake_group(512 if multi_pod else 256)
        mc = make_mesh_context(multi_pod=multi_pod)
        for arch in configs.ARCH_IDS:
            state = abstract_train_state(configs.get(arch), TrainConfig(),
                                         mc)
            shapes[(arch, multi_pod)] = {
                k: tuple(v.to_local().shape) for k, v in _flat(state).items()}
    dryrun.join_fake_group(4)
    mc = make_debug_mesh_context((2, 2))
    seq_sharded = {}
    for arch in ("qwen2_7b", "moonshot_v1_16b_a3b"):
        cfg = configs.get(arch, smoke=True)
        r = dryrun.run_cell(arch, "decode_32k", mesh_ctx=mc,
                            cfg_override=cfg)
        shape = (configs.SHAPES["decode_32k"].global_batch,
                 configs.SHAPES["decode_32k"].seq_len, cfg.kv_heads,
                 cfg.d_head)
        r["kv_pspec"] = tuple(mc.cache_pspec(("stack", "0_G", "k"),
                                             (cfg.n_layers,) + shape))
        seq_sharded[arch] = r
    dryrun.join_fake_group(8)
    try:
        make_debug_mesh_context((2, 2))
        mismatch = ""
    except ValueError as e:
        mismatch = str(e)
    Path(jobdir, "port_fake_shapes.pkl").write_bytes(pickle.dumps(
        {"shapes": shapes, "seq_sharded": seq_sharded, "mismatch": mismatch,
         "pod_major": _pod_major()}))


def _pod_major():
    """Rank r's shard, r = 0..7, of an (8, 4) arange laid out
    P(("pod", "data"), "model") on a (pod=2, data=2, model=2) mesh: each
    rank in turn of a fake group of 8, its shard taken by DTensor with no
    collective."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.sharding import MeshContext

    out = []
    for r in range(8):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=8)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        mc = MeshContext(mesh=mesh, data_axes=("pod", "data"))
        x = torch.arange(32, dtype=torch.int32).reshape(8, 4)
        out.append(mc.distribute(x, mc.placements(
            (("pod", "data"), "model"))).to_local().numpy())
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    fake_main(*sys.argv[1:])
