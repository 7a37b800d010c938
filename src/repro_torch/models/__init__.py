"""repro_torch.models — the port's model code: config, parameter specs and
the weight bridge (``common``), layers, chunked attention, the RG-LRU
block and the RWKV6 mixers, the MoE layer, the LM training forward and
loss, the LM decode step on the paged and gather planes, and the model API
(``api``)."""
from .api import (cache_leaf_dtype, decode_cache_shapes, decode_step,
                  forward, init_decode_cache, loss_fn)
from .common import (ModelConfig, ParamSpec, init_params, params_from_numpy,
                     tree_paths)
from .lm import (cache_shapes, init_cache, lm_decode_step, lm_forward,
                 lm_loss, lm_spec, unit_pattern)

model_spec = lm_spec

__all__ = ["ModelConfig", "ParamSpec", "init_params", "params_from_numpy",
           "tree_paths", "cache_leaf_dtype", "cache_shapes",
           "decode_cache_shapes", "decode_step", "forward", "init_cache",
           "init_decode_cache", "lm_decode_step", "lm_forward", "lm_loss",
           "loss_fn", "lm_spec", "model_spec", "unit_pattern"]
