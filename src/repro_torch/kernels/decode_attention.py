"""Flash-decoding: one query per sequence against a contiguous KV cache,
split over the key range; the port of ``src/repro/kernels/decode_attention.py``
(the Pallas ``_decode_kernel``).

Row ``b`` attends the cache slots ``kpos < valid_len[b]``, and with a
``window`` only those with ``kpos > valid_len[b] - 1 - window``. The ``G``
query heads of one KV head (head ``h = kv * G + g``) share every key they
read. Scores are taken on ``q * scale`` in fp32, optionally softcapped; the
softmax is fp32 and a row that sees no key gives 0. A valid length past the
cache's width counts the whole cache.

* ``decode_attention`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/decode_attention.cu`` (built at first use) or
  raises; on CPU tensors it runs the plain version.
* ``decode_attention_plain`` — the same function in plain PyTorch: dense
  fp32 masked softmax, probabilities kept in fp32 through PV. The CPU tests
  use it, and the kernel is held against it on the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the key range is split over blocks until the grid holds about this many
# blocks per SM, but no split walks fewer than _MIN_SPLIT_KEYS keys
_BLOCKS_PER_SM = 4
_MIN_SPLIT_KEYS = 256
_sm_counts: Dict[int, int] = {}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid_len: torch.Tensor,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, D) one query per row; k, v: (B, S, KV, D) cache;
    valid_len: (B,) filled slots per row. Returns (B, H, D) in q's dtype.

    The kernel's semantics, not the reference's ``_sdpa``: scores on
    ``q * scale`` in fp32, softcap, then the mask; probabilities stay fp32
    through PV (``_sdpa`` casts them to v's dtype); a row that sees no key
    is 0."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float())       # (B,KV,G,S)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S, device=q.device)[None, :]
    vl = valid_len.long()[:, None]
    mask = kpos < vl
    if window is not None:
        mask &= kpos > vl - 1 - window
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l
    return out.reshape(B, H, D).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(q, k, v, valid_len, window) -> None:
    """Everything the kernel does not take raises here, before a pointer
    crosses into C."""
    named = {"q": q, "k": k, "v": v, "valid_len": valid_len}
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"reads rows with 16-byte loads)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must have q's dtype")
    if valid_len.dtype != torch.int32:
        raise TypeError("valid_len must be int32")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,H,D) and k, v (B,S,KV,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] \
            or k.shape[1] < 1:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if D % 8 or D > 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, "
                         f"got {D}")
    if tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must be (B={B},), got "
                         f"{tuple(valid_len.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _n_splits(dev: torch.device, B: int, KV: int, G: int,
              n_keys: int) -> int:
    """Blocks over the key range of one (row, KV head): enough for about
    ``_BLOCKS_PER_SM`` blocks per SM in all, none shorter than
    ``_MIN_SPLIT_KEYS`` keys."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    base = B * KV * -(-G // 8)      # blocks of one split: up to 8 heads each
    want = -(-_BLOCKS_PER_SM * _sm_counts[idx] // base)
    return max(1, min(want, -(-n_keys // _MIN_SPLIT_KEYS)))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Flash-decoding of one (B, H, D) query per row against a (B, S, KV,
    D) cache with (B,) valid lengths, an optional sliding ``window`` and
    ``softcap``. Returns (B, H, D).

    CPU tensors take ``decode_attention_plain``. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count one launch
    in ``decode_attention.launches``; whatever the kernel does not take
    raises."""
    if q.device.type == "cpu":
        for t in (k, v, valid_len):
            if t.device.type != "cpu":
                raise ValueError(f"mixed devices: q on cpu, an input on "
                                 f"{t.device}")
        return decode_attention_plain(q, k, v, valid_len, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_cuda_args(q, k, v, valid_len, window)
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    n_keys = S if window is None else max(min(S, window), 1)
    n_splits = _n_splits(q.device, B, KV, H // KV, n_keys)
    keys_per_split = -(-n_keys // n_splits)
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if n_splits > 1:
        # per-split softmax state (m, l) and unnormalised accumulators,
        # merged by the kernel's second pass
        part_ml = torch.empty((B, H, n_splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B, H, n_splits, D), dtype=torch.float32,
                               device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(),
            0 if part_ml is None else part_ml.data_ptr(),
            0 if part_acc is None else part_acc.data_ptr(),
            B, S, H, KV, D, -1 if window is None else int(window),
            n_splits, keys_per_split,
            1.0 / math.sqrt(D), float(softcap or 0.0), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
