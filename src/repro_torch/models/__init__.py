"""repro_torch.models — the port's model code: config, parameter specs and
the weight bridge (``common``), layers, and the paged LM decode step."""
from .common import (ModelConfig, ParamSpec, init_params, params_from_numpy,
                     tree_paths)
from .lm import cache_shapes, lm_decode_step, lm_spec, unit_pattern

model_spec = lm_spec

__all__ = ["ModelConfig", "ParamSpec", "init_params", "params_from_numpy",
           "tree_paths", "cache_shapes", "lm_decode_step", "lm_spec",
           "model_spec", "unit_pattern"]
