"""Model API over the architectures the port has; mirrors
``src/repro/models/api.py``: ``forward`` and ``loss_fn`` for training and
prefill of the decoder-only LM families, and decode: the cache layout
(``decode_cache_shapes``), its leaf dtypes (``cache_leaf_dtype``: the
recurrent state ``S`` and ``h`` in fp32, the rest in the model dtype), the
zero cache (``init_decode_cache``) and ``decode_step``. Batch dict keys:
``tokens`` and ``targets`` (and an optional ``mask``); the
encoder-decoder family and the image-patch frontend raise."""
from __future__ import annotations

from typing import Dict

import torch

from . import lm as LM
from .common import ModelConfig


def forward(cfg: ModelConfig, params, batch: Dict, *,
            last_logit_only: bool = False):
    if cfg.family == "encdec" or cfg.frontend is not None:
        raise NotImplementedError(
            "the encoder-decoder and image-prefix forwards are not ported")
    return LM.lm_forward(cfg, params, batch["tokens"],
                         last_logit_only=last_logit_only)


def loss_fn(cfg: ModelConfig, params, batch: Dict):
    logits = forward(cfg, params, batch)
    return LM.lm_loss(cfg, logits, batch["targets"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the encoder-decoder decode is not ported")


def decode_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    _decoder_only(cfg)
    return LM.cache_shapes(cfg, batch, max_seq)


def cache_leaf_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """Recurrent state ('S', 'h') is kept fp32 for long-horizon fidelity;
    KV and shift buffers store in model dtype."""
    return torch.float32 if name in ("S", "h") else cfg.dtype


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: torch.device | str):
    """The zero decode cache of ``batch`` slots of ``max_seq`` positions,
    laid out as ``decode_cache_shapes``, each leaf in ``cache_leaf_dtype``,
    on ``device``."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return torch.zeros(tree, dtype=cache_leaf_dtype(cfg, name),
                           device=device)

    return walk(decode_cache_shapes(cfg, batch, max_seq))


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                seq_lens=None, paged_tables=None):
    """(logits (B,1,V), cache), the cache written in place. tokens: (B,S)
    — S=1 for plain decode, S>1 for chunked prefill (per-row start
    ``pos``, real lengths ``seq_lens``; G and M layers only). pos: one
    int shared by every row or (B,) per slot. ``paged_tables`` (B, NW):
    ``cache`` is the KV pool tree and decode runs straight out of the pool
    rows each row's block table names."""
    _decoder_only(cfg)
    return LM.lm_decode_step(cfg, params, cache, tokens, pos,
                             seq_lens=seq_lens, paged_tables=paged_tables)
