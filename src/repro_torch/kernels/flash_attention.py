"""Flash attention for the training and prefill forward: causal, windowed
and softcapped GQA self-attention, PaliGemma's prefix-LM mask, and
non-causal attention of Sq queries against Skv keys (an encoder's
self-attention, a decoder's cross-attention); the port of
``src/repro/kernels/flash_attention.py`` (the Pallas ``_flash_kernel``).

Query token ``i`` of head ``h`` attends the keys ``j < Skv`` of KV head
``h // G`` with ``j <= i`` (causal) and ``j > i - window`` (with a
window), or with ``j < prefix_len`` whatever the band says (the
reference's prefix-LM rule, ``src/repro/models/layers.py:370-379``).
Causal attention needs Sq == Skv, as the reference's kernel does, unless
a ``q_offset`` (0 included) places the queries at rows ``[q_offset,
q_offset + Sq)`` of the Skv positions (one model rank's query slice under the mesh path's
context parallelism: every mask then reads the query's absolute row); the
non-causal kernel masks the keys past Skv, as the Pallas kernel masks
those past ``kv_len``. Scores are taken on ``q * scale`` in fp32 and
softcapped (``c*tanh(s/c)``) before the mask; the softmax is online in
fp32, and a row that sees no key gives 0, as the Pallas finalize does.

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


def _key_range(q0: int, q1: int, Skv: int, causal: bool,
               window: Optional[int], prefix_len: int) -> Tuple[int, int]:
    """The keys [lo, hi) that query rows [q0, q1) (absolute rows: the
    callers add ``q_offset``) can see: the band, and with a prefix every
    key below ``prefix_len`` as well."""
    lo = max(0, q0 - window + 1) if window is not None else 0
    hi = min(Skv, q1) if causal else Skv
    if prefix_len:
        lo, hi = 0, max(hi, min(prefix_len, Skv))
    return lo, hi


def _mask(q0, q1, k0, k1, causal, window, prefix_len, device):
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    m = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    if prefix_len:
        m = m | (kpos < prefix_len)
    return m


def _check_shapes(q, k, v, causal: bool, prefix_len: int,
                  q_offset: Optional[int] = None) -> None:
    """What neither route takes raises here."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,Sq,H,D) and k, v (B,Skv,KV,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q_offset is not None and q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if causal and q_offset is None and k.shape[1] != Sq:
        raise ValueError(f"causal attention needs Sq == Skv (the "
                         f"reference's kernel takes no offset): q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if causal and (q_offset or 0) + Sq > k.shape[1]:
        raise ValueError(f"causal query rows [{q_offset}, {q_offset + Sq}) "
                         f"run past the {k.shape[1]} keys")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          prefix_len: int = 0,
                          q_offset: Optional[int] = None,
                          block_q: int = 128, block_k: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D), H % KV == 0 (Sq == Skv
    when causal, or the queries at rows ``[q_offset, q_offset + Sq)``).
    Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32), where
    lse is the log-sum-exp of each row's visible scores (``EMPTY_LSE``
    for a row that sees none). Differentiable by autograd."""
    _check_shapes(q, k, v, causal, prefix_len, q_offset)
    qo = q_offset or 0
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
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
        lo, hi = _key_range(qo + q0, qo + q1, Skv, causal, window,
                            prefix_len)
        for k0 in range(lo, hi, block_k):
            k1 = min(hi, k0 + block_k)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qt, k[:, k0:k1].float())
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            mask = _mask(qo + q0, qo + q1, k0, k1, causal, window,
                         prefix_len, q.device)
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
                              prefix_len: int = 0,
                              q_offset: Optional[int] = None,
                              block_q: int = 128):
    """The gradient of ``flash_attention_plain``'s output: (dq, dk, dv) in
    the dtypes of q, k and v, for ``dout`` (B, Sq, H, D) and the forward's
    ``out`` and ``lse``. Per query tile it recomputes the visible scores,
    the probabilities ``exp(s - lse)`` and, with a softcap, the factor
    ``1 - tanh^2`` of its derivative; dk and dv sum in fp32 over the
    tiles and over the G query heads of each KV head."""
    B, S, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    q_offset = q_offset or 0
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Skv, KV, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Skv, KV, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, block_q):
        q1 = min(S, q0 + block_q)
        n = q1 - q0
        lo, hi = _key_range(q_offset + q0, q_offset + q1, Skv, causal,
                            window, prefix_len)
        qt = q[:, q0:q1].float().reshape(B, n, KV, G, D)
        dot = dout[:, q0:q1].float().reshape(B, n, KV, G, D)
        ot = out[:, q0:q1].float().reshape(B, n, KV, G, D)
        delta = (dot * ot).sum(dim=-1).permute(0, 2, 3, 1)     # (B,KV,G,n)
        kt, vt = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qt * scale, kt)
        if softcap:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _mask(q_offset + q0, q_offset + q1, lo, hi, causal, window,
                     prefix_len, q.device)
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(q, k, v, causal, window, prefix_len,
                     q_offset=None) -> None:
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
    _check_shapes(q, k, v, causal, prefix_len, q_offset)
    B, _, H, D = q.shape
    if D % 8 or D > 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, "
                         f"got {D}")
    if H > 65535 or B > 65535:
        raise ValueError(f"at most 65535 heads and rows, got H={H}, B={B}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _launch(q, k, v, causal, window, softcap, prefix_len, q_offset=None):
    """K3 on the current stream, in ``flash_design(q.dtype)``: (out,
    lse)."""
    _check_cuda_args(q, k, v, causal, window, prefix_len, q_offset)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, k.shape[1], H, k.shape[2], D, int(causal),
            -1 if window is None else int(window), int(prefix_len),
            int(q_offset or 0), 1.0 / math.sqrt(D),
            float(softcap or 0.0), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out, lse


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            prefix_len: int = 0,
                            q_offset: Optional[int] = None):
    """(out, lse) without autograd: the kernel on CUDA tensors (one launch
    counted in ``flash_attention.launches``), the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        for t in (k, v):
            if t.device.type != "cpu":
                raise ValueError(f"mixed devices: q on cpu, an input on "
                                 f"{t.device}")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, prefix_len=prefix_len,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    res = _launch(q, k, v, causal, window, softcap, prefix_len, q_offset)
    flash_attention.launches += 1
    return res


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, prefix_len,
                q_offset):
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           prefix_len=prefix_len,
                                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        prefix_len=prefix_len, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                               **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    prefix_len: int = 0,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention of (B, Sq, H, D) queries against (B, Skv, KV, D)
    keys and values, causal (Sq == Skv, the same positions, or the
    queries at rows ``[q_offset, q_offset + Sq)`` of the keys) or not,
    with an optional sliding ``window``, ``softcap`` and a prefix of
    ``prefix_len`` keys every query sees. Returns (B, Sq, H, D).

    CPU tensors take ``flash_attention_plain``. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count one
    launch in ``flash_attention.launches``; whatever the kernel does not
    take raises. The gradient is ``flash_attention_bwd_plain``."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                 prefix_len, q_offset)


flash_attention.launches = 0
