"""Train-step builder: loss and gradients → (optional) microbatch
accumulation in fp32 → (optional) cross-pod gradient compression → AdamW;
mirrors ``src/repro/train/step.py``.

Where the reference jits a pure function of the state, the port's step
runs eagerly and updates the state's parameters and moments in place
(``optimizer.adamw_update``); it returns the same state dict. Gradients
come from ``torch.autograd.grad`` on detached leaves, so the parameters
carry no ``.grad``. With ``compress_pod_grads`` the state carries the
error-feedback residuals under ``"ef"`` and AdamW sees the int8 round
trip of each gradient (``compression.compress_grads``).

With a ``MeshContext`` over a ``DeviceMesh`` the state is DTensors laid
out by the rules (``shard_train_state``, or ``abstract_train_state``'s
meta shards for the dry run): the parameters are constrained to their
stored layout at the loss's entry, the gradients and the fp32
accumulator pinned to the parameter placements, and AdamW and the
compression run on the DTensors, each rank on its own shards (the global
norm and the compression's amax reduce over the mesh).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models import abstract_params, init_params, loss_fn, model_spec
from ..models.common import ModelConfig, tree_map, tree_paths, unflatten
from .compression import compress_grads, ef_init
from .optimizer import OptConfig, adamw_init, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    microbatches: int = 1           # gradient accumulation steps
    compress_pod_grads: bool = False
    # the reference's layer-scan and microbatch-scan unrolls (its roofline
    # extraction compiles each cell at two unrolls); the port runs
    # eagerly, so they are accepted and change no number
    unroll: int = 1
    mb_unroll: bool = False


def make_train_state(cfg: ModelConfig, tc: TrainConfig,
                     generator: torch.Generator,
                     device: torch.device | str) -> Dict[str, Any]:
    """Seeded parameters (``init_params`` from ``generator``, which lives
    on ``device``) in the model dtype, zero AdamW moments and, with
    ``compress_pod_grads``, zero error-feedback residuals."""
    params = init_params(model_spec(cfg), generator, device, dtype=cfg.dtype)
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    if tc.compress_pod_grads:
        state["ef"] = ef_init(params)
    return state


def abstract_train_state(cfg: ModelConfig, tc: TrainConfig,
                         mesh_ctx) -> Dict[str, Any]:
    """The train state as meta tensors (the reference's ShapeDtypeStruct
    tree): bf16 (model-dtype) params, fp32 or ``moments_dtype`` moments,
    an int32 step and, with ``compress_pod_grads``, fp32 residuals. With
    a mesh every leaf is a DTensor of meta shards laid out by the rules,
    the step replicated."""
    spec = model_spec(cfg)
    sharding_fn = None
    if mesh_ctx.mesh is not None:
        def sharding_fn(path, s):
            return mesh_ctx.mesh, mesh_ctx.param_sharding(s)
    params = abstract_params(spec, dtype=cfg.dtype, sharding_fn=sharding_fn)
    f32 = abstract_params(spec, dtype=torch.float32, sharding_fn=sharding_fn)
    mdt = getattr(torch, tc.opt.moments_dtype)
    mom = f32 if mdt == torch.float32 else abstract_params(
        spec, dtype=mdt, sharding_fn=sharding_fn)
    step = (torch.empty((), dtype=torch.int32, device="meta")
            if mesh_ctx.mesh is None
            else mesh_ctx.meta((), torch.int32, mesh_ctx.replicated()))
    state: Dict[str, Any] = {
        "params": params,
        "opt": {"m": mom, "v": mom, "step": step},
    }
    if tc.compress_pod_grads:
        state["ef"] = f32
    return state


def state_shardings(abstract_state):
    """The placements tree of a state of DTensors (None for a plain
    leaf)."""
    return tree_map(lambda t: tuple(t.placements)
                    if isinstance(t, DTensor) else None, abstract_state)


def shard_train_state(cfg: ModelConfig, state: Dict[str, Any],
                      mesh_ctx) -> Dict[str, Any]:
    """A train state that every rank holds whole (``make_train_state``
    from one seed) as DTensors on ``mesh_ctx``'s mesh: each rank keeps its
    own shards of the parameters, moments and residuals, laid out by the
    rules, with no collective; the step stays a plain tensor."""
    spec = model_spec(cfg)

    def shard(tree):
        return tree_map(lambda t, s: mesh_ctx.distribute(
            t, mesh_ctx.param_sharding(s)), tree, spec)
    out = {"params": shard(state["params"]),
           "opt": {"m": shard(state["opt"]["m"]),
                   "v": shard(state["opt"]["v"]),
                   "step": state["opt"]["step"]}}
    if "ef" in state:
        out["ef"] = shard(state["ef"])
    return out


def build_train_step(cfg: ModelConfig, tc: TrainConfig, mesh_ctx=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds (B, S) int tensors on the parameters' device, and metrics are
    0-d tensors {"loss", "grad_norm", "lr"}.

    With a mesh (``mesh_ctx``) the state and batch are DTensors
    (``shard_train_state``, ``MeshContext.distribute``), and the step
    mirrors the reference's constraints: the parameters are constrained to
    their stored (FSDP) layout at the loss's entry, and the gradients and
    the fp32 microbatch accumulator pinned to the parameter placements;
    microbatch ``i`` is rows ``[i·b/k, (i+1)·b/k)`` of each data rank's
    ``b`` rows (the same mean loss and gradient as the reference's
    contiguous split, with no collective)."""
    mesh = mesh_ctx is not None and mesh_ctx.mesh is not None
    spec_tree = model_spec(cfg)
    specs = dict(tree_paths(spec_tree))

    def pin(path, g):
        """``g`` in its parameter's placements."""
        return mesh_ctx.constrain_tree(g, specs[path]) if mesh else g

    def value_and_grad(params, batch):
        """(loss, {path: gradient}) of one (micro)batch; a leaf the loss
        does not use (the encoder-decoder's ``cross_q`` k/v projections)
        gets a zero gradient, as the reference's autodiff gives it."""
        leaves = {path: t.detach().requires_grad_(True)
                  for path, t in tree_paths(params)}
        tree = unflatten(leaves)
        if mesh:
            # constrain at entry: the gradients come back in the stored
            # (FSDP) layout
            tree = mesh_ctx.constrain_tree(tree, spec_tree)
        loss = loss_fn(cfg, tree, batch, mesh_ctx=mesh_ctx,
                       unroll=tc.unroll)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [pin(path, torch.zeros_like(t) if g is None else g)
                 for (path, t), g in zip(leaves.items(), grads)]
        return loss.detach(), dict(zip(leaves, grads))

    def microbatch(x, k, i):
        if isinstance(x, DTensor):
            local = x.to_local()
            local = local.reshape((k, local.shape[0] // k)
                                  + local.shape[1:])[i]
            return DTensor.from_local(
                local, x.device_mesh, x.placements, run_check=False,
                shape=torch.Size((x.shape[0] // k,) + x.shape[1:]),
                stride=local.stride())
        return x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]

    def compute_grads(params, batch):
        k = tc.microbatches
        if k <= 1:
            loss, grads = value_and_grad(params, batch)
            return loss, unflatten(grads)
        loss_sum, gsum = 0.0, {}
        for i in range(k):
            mb = {n: microbatch(x, k, i) for n, x in batch.items()}
            loss, grads = value_and_grad(params, mb)
            loss_sum = loss_sum + loss
            for path, g in grads.items():
                gsum[path] = pin(path, gsum[path] + g.float()
                                 if path in gsum else g.float())
        return loss_sum / k, unflatten({path: g / k
                                        for path, g in gsum.items()})

    def update(state, batch):
        loss, grads = compute_grads(state["params"], batch)
        if tc.compress_pod_grads:
            grads, state["ef"] = compress_grads(grads, state["ef"])
        params, opt, stats = adamw_update(tc.opt, state["params"], grads,
                                          state["opt"])
        state["params"], state["opt"] = params, opt
        return state, {"loss": loss, **stats}

    def train_step(state, batch):
        if not mesh:
            return update(state, batch)
        # the optimizer's plain scalars (the step, bias corrections) meet
        # DTensors as replicated values
        with implicit_replication():
            return update(state, batch)

    return train_step
