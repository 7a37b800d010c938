"""repro_torch.models — the port's model code: config, parameter specs and
the weight bridge (``common``), layers, the LM decode step on the paged and
gather planes, and the decode cache (``api``)."""
from .api import init_decode_cache
from .common import (ModelConfig, ParamSpec, init_params, params_from_numpy,
                     tree_paths)
from .lm import cache_shapes, lm_decode_step, lm_spec, unit_pattern

model_spec = lm_spec

__all__ = ["ModelConfig", "ParamSpec", "init_params", "params_from_numpy",
           "tree_paths", "cache_shapes", "init_decode_cache",
           "lm_decode_step", "lm_spec", "model_spec", "unit_pattern"]
