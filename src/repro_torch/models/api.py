"""Model API over every architecture the port has; mirrors
``src/repro/models/api.py``. One entry point per lifecycle stage,
dispatching on ``cfg.family``:

* ``model_spec(cfg)``                 — ParamSpec tree
* ``forward(cfg, params, batch)``     — logits for training / prefill
* ``loss_fn(cfg, params, batch)``     — scalar LM loss (next-token CE)
* ``decode_cache_shapes`` / ``init_decode_cache`` / ``decode_step`` —
  the cache layout, the zero cache (leaves in ``cache_leaf_dtype``: the
  recurrent state ``S`` and ``h`` in fp32, the rest in the model dtype)
  and one decode step
* ``batch_shapes(cfg, batch, seq)``   — the shapes of a training batch

Batch dict keys: ``tokens``/``targets`` always (and an optional
``mask``); ``patches`` for vlm (precomputed patch embeddings, frontend
stub); ``frames`` for the encoder-decoder family (precomputed frame
embeddings, frontend stub)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import encdec as ED
from . import lm as LM
from .common import ModelConfig


def model_spec(cfg: ModelConfig) -> Dict:
    if cfg.family == "encdec":
        return ED.encdec_spec(cfg)
    return LM.lm_spec(cfg)


def forward(cfg: ModelConfig, params, batch: Dict, *, mesh_ctx=None,
            unroll: int = 1, last_logit_only: bool = False):
    """Logits of a batch. ``mesh_ctx`` (a ``sharding.MeshContext``):
    with a mesh, ``params`` and the batch are DTensors on it and the
    forward runs the mesh path (``lm.lm_forward`` or
    ``encdec.encdec_forward``). ``unroll`` is the
    reference's layer-scan unroll; the port loops eagerly, so it changes
    nothing."""
    if cfg.family == "encdec":
        return ED.encdec_forward(cfg, params, batch["tokens"],
                                 batch["frames"], mesh_ctx=mesh_ctx,
                                 last_logit_only=last_logit_only)
    return LM.lm_forward(cfg, params, batch["tokens"], mesh_ctx=mesh_ctx,
                         patches=batch.get("patches"),
                         last_logit_only=last_logit_only)


def loss_fn(cfg: ModelConfig, params, batch: Dict, *, mesh_ctx=None,
            unroll: int = 1):
    logits = forward(cfg, params, batch, mesh_ctx=mesh_ctx, unroll=unroll)
    targets = batch["targets"]
    if cfg.frontend == "patch_embed" and logits.shape[1] != targets.shape[1]:
        # drop the image-prefix positions: only text positions carry loss
        logits = logits[:, -targets.shape[1]:]
    return LM.lm_loss(cfg, logits, targets, batch.get("mask"),
                      mesh_ctx=mesh_ctx)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                        enc_len: int = 0) -> Dict:
    if cfg.family == "encdec":
        return ED.encdec_cache_shapes(cfg, batch, max_seq,
                                      enc_len or cfg.frontend_len)
    return LM.cache_shapes(cfg, batch, max_seq)


def cache_leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """Recurrent state ('S', 'h') is kept fp32 for long-horizon fidelity;
    KV and shift buffers store in model dtype."""
    return torch.float32 if name in ("S", "h") else cfg.dtype


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      enc_len: int = 0, *, device: torch.device | str):
    """The zero decode cache of ``batch`` slots of ``max_seq`` positions
    (and, for the encoder-decoder family, ``enc_len`` encoder positions),
    laid out as ``decode_cache_shapes``, each leaf in ``cache_leaf_dtype``,
    on ``device``."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return torch.zeros(tree, dtype=cache_leaf_dtype(cfg, name),
                           device=device)

    return walk(decode_cache_shapes(cfg, batch, max_seq, enc_len))


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                mesh_ctx=None, unroll: int = 1, seq_lens=None,
                paged_tables=None, kv_shard=None):
    """(logits (B,1,V), cache), the cache written in place. tokens: (B,S)
    — S=1 for plain decode, S>1 for chunked prefill (per-row start
    ``pos``, real lengths ``seq_lens``; G and M layers only). pos: one
    int shared by every row or (B,) per slot. ``paged_tables`` (B, NW):
    ``cache`` is the KV pool tree and decode runs straight out of the pool
    rows each row's block table names; ``kv_shard``
    (``sharding.KVShardCtx``): the pool leaves hold this rank's KV heads
    and each attention runs on the rank's head slice, its outputs
    all-gathered over heads. The encoder-decoder family decodes
    one token with one shared position from ``encdec_prefill_cache``'s
    cache, and raises on the rest, as the reference does. ``mesh_ctx``:
    with a mesh, params, cache and tokens are DTensors on it
    (``lm.lm_decode_step``, ``encdec.encdec_decode_step``); ``unroll``
    changes nothing here."""
    if cfg.family == "encdec":
        if seq_lens is not None or tokens.shape[1] != 1 \
                or paged_tables is not None or kv_shard is not None:
            raise NotImplementedError(
                "chunked/paged decode is decoder-LM only (encdec is S=1)")
        return ED.encdec_decode_step(cfg, params, cache, tokens, pos,
                                     mesh_ctx=mesh_ctx)
    return LM.lm_decode_step(cfg, params, cache, tokens, pos,
                             mesh_ctx=mesh_ctx, seq_lens=seq_lens,
                             paged_tables=paged_tables, kv_shard=kv_shard)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


def batch_shapes(cfg: ModelConfig, global_batch: int, seq_len: int
                 ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{name: (shape, dtype)} for one *training* batch."""
    out: Dict[str, Tuple[Tuple[int, ...], Any]] = {
        "tokens": ((global_batch, seq_len), torch.int32),
        "targets": ((global_batch, seq_len), torch.int32),
    }
    if cfg.frontend == "patch_embed":
        out["patches"] = ((global_batch, cfg.frontend_len, cfg.frontend_dim),
                          cfg.dtype)
    elif cfg.frontend == "audio_frames":
        out["frames"] = ((global_batch, cfg.frontend_len, cfg.d_model),
                         cfg.dtype)
    return out


def make_dummy_batch(cfg: ModelConfig, global_batch: int, seq_len: int,
                     generator: Optional[torch.Generator] = None,
                     device: torch.device | str = "cpu") -> Dict:
    """A concrete random batch for smoke runs, drawn from ``generator``
    (seeded 0 when None) on ``device``. Its shapes and dtypes are the
    reference's; its values cannot be (``jax.random``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    batch: Dict[str, Any] = {
        name: torch.randint(0, cfg.vocab, (global_batch, seq_len),
                            generator=generator, dtype=torch.int32,
                            device=device)
        for name in ("tokens", "targets")}
    if cfg.frontend in ("patch_embed", "audio_frames"):
        name = "patches" if cfg.frontend == "patch_embed" else "frames"
        shape, dtype = batch_shapes(cfg, global_batch, seq_len)[name]
        batch[name] = torch.randn(shape, generator=generator,
                                  dtype=torch.float32,
                                  device=device).to(dtype)
    return batch
