"""Step functions + abstract input specs for every (arch × shape) cell;
mirrors ``src/repro/launch/specs.py``.

``build_cell(arch, shape, mesh_ctx)`` returns ``(fn, args, out_shardings)``
for the dry run (``launch.dryrun``):

* ``train``   — the full train step (fwd + bwd + AdamW) on the sharded
                train state and token batch;
* ``prefill`` — forward over the full sequence, returning only the
                last-position logits (what a serving engine samples from);
* ``decode``  — one ``serve_step``: a single new token against a KV cache
                of ``seq_len``, returning (greedy token, updated cache).

``args`` are meta tensors — DTensors of meta shards on a mesh — so nothing
is allocated here; ``out_shardings`` are the outputs' placements. The dry
run runs ``fn`` on fake tensors of the same layouts.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import configs
from ..models import (abstract_params, batch_shapes, decode_cache_shapes,
                      decode_step, forward, model_spec)
from ..models.api import cache_leaf_dtype
from ..models.common import ModelConfig
from ..sharding import MeshContext
from ..train import (TrainConfig, abstract_train_state, build_train_step,
                     state_shardings)


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


def abstract_batch(cfg: ModelConfig, mesh_ctx: MeshContext,
                   global_batch: int, seq_len: int) -> Dict:
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, global_batch,
                                             seq_len).items():
        out[name] = mesh_ctx.batch_sharding(shape, dtype)
    return out


def abstract_cache(cfg: ModelConfig, mesh_ctx: MeshContext, batch: int,
                   max_seq: int, enc_len: int = 0):
    shapes = decode_cache_shapes(cfg, batch, max_seq, enc_len)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        name = path[-1] if path else ""
        return mesh_ctx.cache_sharding(path, tree,
                                       cache_leaf_dtype(cfg, name))

    return walk(shapes)


def cache_shardings_tree(abstract):
    return state_shardings(abstract)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, mesh_ctx: Optional[MeshContext],
                       unroll: int = 1):
    def prefill_step(params, batch):
        logits = forward(cfg, params, batch, mesh_ctx=mesh_ctx,
                         unroll=unroll, last_logit_only=True)
        return logits[:, -1, :]        # (B, vocab): next-token distribution
    return prefill_step


def build_serve_step(cfg: ModelConfig, mesh_ctx: Optional[MeshContext],
                     unroll: int = 1):
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = decode_step(cfg, params, cache, tokens, pos,
                                        mesh_ctx=mesh_ctx, unroll=unroll)
        last = logits[:, -1, :]
        if mesh_ctx is not None:
            # the argmax runs on each data rank's rows, vocab gathered
            last = mesh_ctx.gather_seq(last)
        next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache
    return serve_step


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def build_cell(arch: str, shape_name: str, mesh_ctx: MeshContext, *,
               train_cfg: Optional[TrainConfig] = None,
               cfg_override: Optional[ModelConfig] = None,
               unroll: int = 1):
    """(fn, args, out_shardings) for one dry-run cell. A decode cell's
    ``pos`` is a replicated int32 scalar, as the reference's is; the dry
    run hands ``fn`` its value (``pos_value``)."""
    cfg = cfg_override if cfg_override is not None else configs.get(arch)
    shape = configs.SHAPES[shape_name]
    tc = train_cfg or TrainConfig(unroll=unroll)

    if shape.kind == "train":
        state = abstract_train_state(cfg, tc, mesh_ctx)
        batch = abstract_batch(cfg, mesh_ctx, shape.global_batch,
                               shape.seq_len)
        fn = build_train_step(cfg, tc, mesh_ctx)
        out_sh = (state_shardings(state),
                  {"loss": mesh_ctx.replicated(),
                   "grad_norm": mesh_ctx.replicated(),
                   "lr": mesh_ctx.replicated()})
        return fn, (state, batch), out_sh

    sharding_fn = ((lambda path, s: (mesh_ctx.mesh,
                                     mesh_ctx.param_sharding(s)))
                   if mesh_ctx.mesh is not None else None)
    params = abstract_params(model_spec(cfg), dtype=cfg.dtype,
                             sharding_fn=sharding_fn)

    if shape.kind == "prefill":
        batch = abstract_batch(cfg, mesh_ctx, shape.global_batch,
                               shape.seq_len)
        batch.pop("targets")
        fn = build_prefill_step(cfg, mesh_ctx, unroll=unroll)
        # (B, vocab) — batch over data axes, vocab over model
        out_sh = tuple(mesh_ctx.batch_sharding(
            (shape.global_batch, cfg.vocab), cfg.dtype).placements)
        return fn, (params, batch), out_sh

    if shape.kind == "decode":
        B = shape.global_batch
        cache = abstract_cache(cfg, mesh_ctx, B, shape.seq_len,
                               enc_len=cfg.frontend_len)
        tokens = mesh_ctx.batch_sharding((B, 1), torch.int32)
        pos = (mesh_ctx.meta((), torch.int32, mesh_ctx.replicated())
               if mesh_ctx.mesh is not None
               else torch.empty((), dtype=torch.int32, device="meta"))
        fn = build_serve_step(cfg, mesh_ctx, unroll=unroll)
        out_sh = (tuple(mesh_ctx.batch_sharding((B, 1),
                                                torch.int32).placements),
                  cache_shardings_tree(cache))
        return fn, (params, cache, tokens, pos), out_sh

    raise ValueError(shape.kind)


def pos_value(shape_name: str) -> int:
    """The decode position the dry run steps at: the cache's last slot,
    so the step attends the whole cache."""
    return configs.SHAPES[shape_name].seq_len - 1
