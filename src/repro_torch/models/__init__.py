"""repro_torch.models — the port's model code: config, parameter specs and
the weight bridge (``common``), layers, chunked attention, the RG-LRU
block and the RWKV6 mixers, the MoE layer, the LM training forward (with
the image-patch prefix) and loss, the LM decode step on the paged and
gather planes and on the paged plane's packed rows, the encoder-decoder family (``encdec``), and the model API
(``api``)."""
from .api import (batch_shapes, cache_leaf_dtype, decode_cache_shapes,
                  decode_step, forward, init_decode_cache, loss_fn,
                  make_dummy_batch, model_spec)
from .common import (ModelConfig, ParamSpec, abstract_params, init_params,
                     param_count, params_from_numpy, tree_paths)
from .encdec import (decode_train, encdec_cache_shapes, encdec_decode_step,
                     encdec_forward, encdec_prefill_cache, encdec_spec,
                     encode)
from .layers import PackedRows
from .lm import (cache_shapes, init_cache, lm_decode_step, lm_forward,
                 lm_loss, lm_packed_step, lm_spec, unit_pattern)

__all__ = ["ModelConfig", "ParamSpec", "abstract_params", "init_params",
           "make_dummy_batch", "param_count", "params_from_numpy",
           "tree_paths", "batch_shapes", "cache_leaf_dtype", "cache_shapes",
           "decode_cache_shapes", "decode_step", "decode_train",
           "encdec_cache_shapes", "encdec_decode_step", "encdec_forward",
           "encdec_prefill_cache", "encdec_spec", "encode", "forward",
           "init_cache", "init_decode_cache", "lm_decode_step", "lm_forward",
           "lm_loss", "lm_packed_step", "loss_fn", "PackedRows", "lm_spec", "model_spec", "unit_pattern"]
