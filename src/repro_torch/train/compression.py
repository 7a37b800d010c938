"""Cross-pod gradient compression with error feedback; mirrors
``src/repro/train/compression.py``.

At 2+ pods the data-parallel gradient all-reduce crosses the (slow)
inter-pod links. Int8 compression with error feedback (1-bit-Adam-family,
Seide et al. 2014; Tang et al. arXiv:2102.02888) cuts those bytes 2x vs
bf16 / 4x vs fp32 while error feedback keeps convergence: the residual of
each quantization is carried and added to the next step's gradient, so the
*time-averaged* transmitted gradient is unbiased.

``compress_grads`` applies quantize→dequantize with a carried error buffer
— the optimizer sees exactly what a compressed wire transfer would deliver
(numerics are real). The wire format itself is not re-implemented: the
port trains on one device, and what the update sees is the
fidelity-relevant part.

The quantization math lives in the shared ``repro_torch.quant`` (the
serve tier demotes KV blocks through the same functions), so train and
serve report byte ratios from one formula.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .. import quant
from ..models.common import tree_map


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    return quant.quantize_tensor(x, quant.INT8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return quant.dequantize_tensor(q, scale)


def ef_init(params) -> Any:
    """Error-feedback residual buffers (fp32, one per parameter, on its
    device, laid out as it)."""
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)


def compress_grads(grads, ef_state):
    """Error-feedback int8 round trip.

    g_corrected = g + e ;  wire = Q(g_corrected) ;  e' = g_corrected - wire
    Returns (wire_grads, new_ef_state).
    """
    def one(g, e):
        gf = g.to(torch.float32) + e
        q, s = _quantize_int8(gf)
        wire = _dequantize(q, s)
        return wire, gf - wire

    pairs = tree_map(one, grads, ef_state)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def compression_ratio(dtype: Any = torch.float32,
                      numel: Optional[int] = None,
                      spec: quant.QuantSpec = quant.INT8) -> float:
    """Wire-byte ratio vs the uncompressed gradient dtype (torch or
    numpy).

    With ``numel`` the ratio is exact for one tensor of that size: it
    charges the f32 scale that rides with every quantized tensor (a
    64-element bf16 tensor compresses 128/(64+4) ≈ 1.88x, not 2x).
    Without ``numel`` it is the asymptotic per-element ratio (scale
    overhead amortized to zero). Either way the source dtype's real width
    is priced: bf16 gradients compress 2x into int8, not 4x."""
    if numel is None:
        return quant._itemsize(dtype) / spec.itemsize
    return quant.compression_ratio(numel, dtype, spec, n_scales=1)
