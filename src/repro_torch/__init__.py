"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``repro``'s layout and names (configs, core, obs, data, models,
kernels, serve, train, launch) and imports nothing of ``repro`` or JAX: every
module it needs keeps its own copy here. The JAX package is the reference
the tests hold this one against. Ported so far: serving under the LERC
prefix cache on the paged and gather planes (hand-written CUDA paged
attention and flash-decoding) with the compressed host and disk tiers
below the device pool, and training of G, L, R (RG-LRU) and W
(RWKV6) layer models (hand-written CUDA flash attention, RG-LRU scan and
RWKV6 WKV); ``kernels`` lists them.
"""
