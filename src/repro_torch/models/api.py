"""Decode-cache construction; mirrors ``init_decode_cache`` of
``src/repro/models/api.py`` for the layer kinds the port has (G and L,
whose caches are all KV leaves, stored in the model dtype)."""
from __future__ import annotations

import torch

from .common import ModelConfig, tree_map
from .lm import cache_shapes


def init_decode_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: torch.device | str):
    """The zero decode cache of ``batch`` slots of ``max_seq`` positions,
    laid out as ``lm.cache_shapes``, on ``device``."""
    return tree_map(lambda s: torch.zeros(s, dtype=cfg.dtype, device=device),
                    cache_shapes(cfg, batch, max_seq))
