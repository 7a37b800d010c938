"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

It mirrors ``repro``'s layout and names (configs, core, obs, models,
kernels, serve, launch) and imports nothing of ``repro`` or JAX: every
module it needs keeps its own copy here. The JAX package is the reference
the tests hold this one against. Ported so far: paged serving of a
global-attention model under the LERC prefix cache, with the hand-written
CUDA paged-attention kernel (``kernels.paged_attention``).
"""
