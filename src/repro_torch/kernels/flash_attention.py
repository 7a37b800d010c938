"""Flash attention for the training and prefill forward: causal, windowed
and softcapped GQA self-attention with Sq == Skv; the port of
``src/repro/kernels/flash_attention.py`` (the Pallas ``_flash_kernel``).

Query token ``i`` of head ``h`` attends the keys ``j`` of KV head
``h // G`` with ``j <= i`` (causal) and ``j > i - window`` (with a window).
Scores are taken on ``q * scale`` in fp32 and softcapped (``c*tanh(s/c)``)
before the mask; the softmax is online in fp32, and a row that sees no key
gives 0, as the Pallas finalize does.

* ``flash_attention`` — the wrapper, a ``torch.autograd.Function``. Its
  forward launches the hand-written kernel ``csrc/flash_attention.cu``
  (built at first use) on CUDA tensors or raises, and runs
  ``flash_attention_plain`` on CPU tensors. The kernel's design follows
  the dtype (``flash_design``): bf16 runs its products on the tensor
  cores (``wgmma``), f32 on the fp32 SIMT units (so f32 products stay
  f32). Its backward is plain PyTorch, ``flash_attention_bwd_plain``, on
  both devices: the reference has no backward kernel (its gradient is
  XLA's autodiff of the dense or chunked attention), so the backward is
  not a kernel port.
* ``flash_attention_plain`` — the forward in plain PyTorch, a tiled online
  softmax that walks, for each query tile, only the key tiles it can see.
  It returns the output and the fp32 log-sum-exp the backward needs.
* ``flash_attention_bwd_plain`` — the gradient, recomputing the
  probabilities from the log-sum-exp one query tile at a time, so its
  memory stays bounded by a tile's (rows x visible keys) scores.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
# log-sum-exp of a row that sees no key: exp(s - EMPTY_LSE) is 0 for
# every score, so the backward gives such a row no probability mass
EMPTY_LSE = 1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _key_range(q0: int, q1: int, S: int, causal: bool,
               window: Optional[int]) -> Tuple[int, int]:
    """The keys [lo, hi) that query rows [q0, q1) can see."""
    lo = max(0, q0 - window + 1) if window is not None else 0
    hi = min(S, q1) if causal else S
    return lo, hi


def _mask(q0, q1, k0, k1, causal, window, device):
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    m = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, H, D); k, v: (B, S, KV, D), H % KV == 0. Returns (out (B,
    S, H, D) in q's dtype, lse (B, H, S) fp32), where lse is the
    log-sum-exp of each row's visible scores (``EMPTY_LSE`` for a row that
    sees none). Differentiable by autograd."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    outs, lses = [], []
    for q0 in range(0, S, block_q):
        q1 = min(S, q0 + block_q)
        n = q1 - q0
        qt = q[:, q0:q1].float().reshape(B, n, KV, G, D) * scale
        m = torch.full((B, KV, G, n), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, n), device=q.device)
        acc = torch.zeros((B, KV, G, n, D), device=q.device)
        lo, hi = _key_range(q0, q1, S, causal, window)
        for k0 in range(lo, hi, block_k):
            k1 = min(hi, k0 + block_k)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, k[:, k0:k1].float())
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            mask = _mask(q0, q1, k0, k1, causal, window, q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
            p = torch.where(mask, torch.exp(s - safe[..., None]), 0.0)
            alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - safe))
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v[:, k0:k1].float())
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]                # (B,KV,G,n,D)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, n, H, D))
        lses.append(torch.where(l > 0, m + torch.log(l), EMPTY_LSE)
                    .reshape(B, H, n))
    return torch.cat(outs, dim=1).to(q.dtype), torch.cat(lses, dim=2)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              block_q: int = 128):
    """The gradient of ``flash_attention_plain``'s output: (dq, dk, dv) in
    the dtypes of q, k and v, for ``dout`` (B, S, H, D) and the forward's
    ``out`` and ``lse``. Per query tile it recomputes the visible scores,
    the probabilities ``exp(s - lse)`` and, with a softcap, the factor
    ``1 - tanh^2`` of its derivative; dk and dv sum in fp32 over the
    tiles and over the G query heads of each KV head."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, KV, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, S, KV, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, block_q):
        q1 = min(S, q0 + block_q)
        n = q1 - q0
        lo, hi = _key_range(q0, q1, S, causal, window)
        qt = q[:, q0:q1].float().reshape(B, n, KV, G, D)
        dot = dout[:, q0:q1].float().reshape(B, n, KV, G, D)
        ot = out[:, q0:q1].float().reshape(B, n, KV, G, D)
        delta = (dot * ot).sum(dim=-1).permute(0, 2, 3, 1)     # (B,KV,G,n)
        kt, vt = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qt * scale, kt)
        if softcap:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _mask(q0, q1, lo, hi, causal, window, q.device)
        L = lse[:, :, q0:q1].reshape(B, KV, G, n)
        p = torch.where(mask, torch.exp(s - L[..., None]), 0.0)
        dv[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, dot)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dot, vt)
        ds = p * (dp - delta[..., None])
        if softcap:
            ds = ds * (1.0 - t * t)
        dq[:, q0:q1] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kt)
                        * scale).reshape(B, n, H, D)
        dk[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qt) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_design(dtype: torch.dtype) -> str:
    """The kernel's design for inputs of ``dtype``: "wgmma" (Hopper's
    warpgroup tensor-core products) for bf16, "simt" (fp32 SIMT units)
    for f32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(q, k, v, window) -> None:
    """Everything the kernel does not take raises here, before a pointer
    crosses into C."""
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"copies rows in 16-byte pieces)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must have q's dtype")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,S,H,D) and k, v (B,S,KV,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or H % k.shape[2]:
        raise ValueError(f"shapes do not match (self-attention, Sq == "
                         f"Skv): q {tuple(q.shape)}, k {tuple(k.shape)}")
    if D % 8 or D > 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, "
                         f"got {D}")
    if H > 65535 or B > 65535:
        raise ValueError(f"at most 65535 heads and rows, got H={H}, B={B}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(q, k, v, causal, window, softcap, design):
    """K3 in ``design`` on the current stream: (out, lse)."""
    _check_cuda_args(q, k, v, window)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], D, int(causal),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            float(softcap or 0.0), _DTYPE_CODES[q.dtype],
            int(design == "simt"),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out, lse


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """(out, lse) without autograd: the kernel on CUDA tensors (one launch
    counted in ``flash_attention.launches``), the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        for t in (k, v):
            if t.device.type != "cpu":
                raise ValueError(f"mixed devices: q on cpu, an input on "
                                 f"{t.device}")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    res = _launch(q, k, v, causal, window, softcap, flash_design(q.dtype))
    flash_attention.launches += 1
    return res


def flash_attention_simt(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None):
    """(out, lse) of the kernel's SIMT design on CUDA tensors of either
    dtype: for bf16 the kernel's earlier design, the yardstick
    ``chip_smoke.py`` times the wgmma design against. No path of the
    port calls it, and it counts no launch."""
    return _launch(q, k, v, causal, window, softcap, "simt")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal=causal, window=window,
            softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Flash attention of (B, S, H, D) queries against (B, S, KV, D) keys
    and values (the same positions), causal or not, with an optional
    sliding ``window`` and ``softcap``. Returns (B, S, H, D).

    CPU tensors take ``flash_attention_plain``. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count one
    launch in ``flash_attention.launches``; whatever the kernel does not
    take raises. The gradient is ``flash_attention_bwd_plain``."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)


flash_attention.launches = 0
