"""Recurrent sequence mixers; mirrors ``src/repro/models/recurrent.py``.

Ported so far: the RG-LRU (Griffin/RecurrentGemma) block's training and
prefill forward. The gate and projection products are plain PyTorch; the
recurrence itself goes through ``kernels.rglru_scan`` (the CUDA kernel on
CUDA tensors, its plain sequential version on CPU tensors). The one-step
decode (``rglru_step``) and RWKV6 raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import rglru_scan as _rglru_scan_kernel
from .common import ModelConfig, p

# ---------------------------------------------------------------------------
# RG-LRU  (Griffin, arXiv:2402.19427, adapted per RecurrentGemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_NB = 16  # block-diagonal gate blocks (recurrentgemma: per-head)


def rglru_block_spec(cfg: ModelConfig) -> Dict:
    d, W = cfg.d_model, cfg.lru_width
    bs = W // _NB
    return {
        "w_x": p((d, W), ("embed", "rnn"), init="scaled"),
        "w_y": p((d, W), ("embed", "rnn"), init="scaled"),
        "conv_w": p((cfg.conv_width, W), (None, "rnn"), init="scaled"),
        "conv_b": p((W,), ("rnn",), init="zeros"),
        "gate_a": p((_NB, bs, bs), ("rnn_blocks", None, None), init="scaled"),
        "gate_x": p((_NB, bs, bs), ("rnn_blocks", None, None), init="scaled"),
        "lam": p((W,), ("rnn",), init="normal", scale=0.5),
        "w_out": p((W, d), ("rnn", "embed"), init="scaled"),
    }


def _blockdiag(x, w):
    """x: (..., W) @ block-diagonal w: (NB, bs, bs) -> (..., W)."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (_NB, shape[-1] // _NB))
    yb = torch.einsum("...nb,nbc->...nc", xb, w)
    return yb.reshape(shape)


def _causal_conv(x, w, b):
    """Depthwise causal conv over time from a zero context. x: (B,S,W);
    w: (K,W). Returns (y, the trailing K-1 steps of context). The taps are
    summed in the reference's order, in x's dtype."""
    K = w.shape[0]
    pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[K - 1 - i] for i in range(K))
    return y + b, xp[:, -(K - 1):, :]


def _rglru_coeffs(params, x):
    """x: (B,S,W) fp32 -> (log_a, b_in) of the recurrence
    h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t)."""
    r = torch.sigmoid(_blockdiag(x, params["gate_a"].float()))
    i = torch.sigmoid(_blockdiag(x, params["gate_x"].float()))
    # a = sigmoid(lam)^(c*r)  ->  log a = -c * r * softplus(-lam)
    lam = params["lam"].float() + 2.0   # bias toward slow decay
    log_a = -_RGLRU_C * r * F.softplus(-lam)
    b_in = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i * x)
    return log_a, b_in


def rglru_scan(params, x):
    """Training/prefill path. x: (B,S,W) -> (B,S,W); returns (y, h_last).
    The coefficients in plain PyTorch, the recurrence through the kernel
    wrapper."""
    dt = x.dtype
    x = x.float()
    log_a, b_in = _rglru_coeffs(params, x)
    a = torch.exp(log_a)
    h, h_last = _rglru_scan_kernel(a.contiguous(), b_in.contiguous())
    return h.to(dt), h_last


def rglru_step(params, x, h_prev):
    raise NotImplementedError(
        "RG-LRU one-step decode (R-layer serving) is not ported yet")


def rglru_block(cfg: ModelConfig, params, x, *, state: Optional[Dict] = None):
    """The Griffin recurrent block: in-proj → causal conv → RG-LRU, gated.
    x: (B,S,d). Only the training/prefill form (``state=None``) is ported.
    Returns (out (B,S,d), {"conv": (B,K-1,W), "h": (B,W)}), the state a
    decode would continue from."""
    if state is not None:
        raise NotImplementedError(
            "the RG-LRU block's decode state is not ported yet")
    rec = torch.einsum("bsd,dw->bsw", x, params["w_x"])
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["w_y"]),
                  approximate="tanh")
    rec, new_conv = _causal_conv(rec, params["conv_w"], params["conv_b"])
    h, h_last = rglru_scan(params, rec)
    out = torch.einsum("bsw,wd->bsd", h * gate, params["w_out"])
    return out, {"conv": new_conv.to(x.dtype), "h": h_last}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): not ported yet
# ---------------------------------------------------------------------------


def _rwkv_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "RWKV6 (W layers) is not ported yet: it comes with its WKV kernel")


rwkv_time_mix_spec = rwkv_time_mix = _rwkv_not_ported
rwkv_channel_mix_spec = rwkv_channel_mix = _rwkv_not_ported
