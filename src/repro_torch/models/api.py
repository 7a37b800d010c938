"""Model API over the architectures the port has; mirrors
``src/repro/models/api.py``: ``forward`` and ``loss_fn`` for training and
prefill of the decoder-only LM families, and the decode cache (G and L
layers, whose caches are all KV leaves, stored in the model dtype).
Batch dict keys: ``tokens`` and ``targets`` (and an optional ``mask``);
the encoder-decoder family and the image-patch frontend raise."""
from __future__ import annotations

from typing import Dict

import torch

from . import lm as LM
from .common import ModelConfig, tree_map
from .lm import cache_shapes


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


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: torch.device | str):
    """The zero decode cache of ``batch`` slots of ``max_seq`` positions,
    laid out as ``lm.cache_shapes``, on ``device``."""
    return tree_map(lambda s: torch.zeros(s, dtype=cfg.dtype, device=device),
                    cache_shapes(cfg, batch, max_seq))
