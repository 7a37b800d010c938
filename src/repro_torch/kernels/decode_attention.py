"""Flash-decoding: one query per sequence against a contiguous KV cache,
split over the key range; the port of ``src/repro/kernels/decode_attention.py``
(the Pallas ``_decode_kernel``).

Row ``b`` attends the cache slots ``kpos < valid_len[b]``, and with a
``window`` only those with ``kpos > valid_len[b] - 1 - window``. The ``G``
query heads of one KV head (head ``h = kv * G + g``) share every key they
read. Scores are taken on ``q * scale`` in fp32, optionally softcapped; the
softmax is fp32 and a row that sees no key gives 0. A valid length past the
cache's width counts the whole cache. With ``return_lse`` each row's fp32
log-sum-exp of its scaled scores comes back too (-inf for a row that sees
no key), so that attentions over disjoint key ranges merge exactly.

* ``decode_attention`` — the wrapper. On CUDA tensors it launches the
  hand-written kernel ``csrc/decode_attention.cu`` (built at first use) or
  raises; on CPU tensors it runs the plain version.
* ``decode_attention_plain`` — the same function in plain PyTorch: dense
  fp32 masked softmax, probabilities kept in fp32 through PV. The CPU tests
  use it, and the kernel is held against it on the card.
* ``merge_partials`` — partial attentions ``(out, lse)`` over disjoint key
  ranges merged into the attention over their union (a max and two sums,
  as the kernel merges its splits): stacked on the CPU or the card, or one
  a rank with the reductions over the ranks given.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# no split walks fewer than _MIN_SPLIT_KEYS keys: below that a split's
# fixed cost (its q loads, its merge) outweighs the parallelism it adds (on
# an H100 80GB HBM3 at 700 W and gemma2-27b's widths, 128 ragged keys took
# 0.0114 ms in one
# split and 0.0136 in two; chip_smoke.py prints the plan and the time)
_MIN_SPLIT_KEYS = 128
# half-warps a block of the kernel (8 warps)
_SUB_WARPS = 16
_sm_counts: Dict[int, int] = {}
_occupancy: Dict[Tuple[int, int, int, int, int], int] = {}
# per (device, stream): the merge's arrival counters, which the kernel
# leaves at 0 (a launch captured into a CUDA graph takes its own)
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
# per call signature: the launch's integer arguments, once its shapes,
# dtypes, devices and options have passed _check_cuda_args
_signatures: Dict[tuple, tuple] = {}


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, valid_len: torch.Tensor,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           return_lse: bool = False):
    """q: (B, H, D) one query per row; k, v: (B, S, KV, D) cache;
    valid_len: (B,) filled slots per row. Returns (B, H, D) in q's dtype,
    and with ``return_lse`` also the (B, H) fp32 log-sum-exp of the scaled
    scores (-inf for a row that sees no key).

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
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l.clamp_min(1e-30)
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(l), -math.inf)
    return out, lse.reshape(B, H)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, reduce_max=None,
                   reduce_sum=None):
    """The attention over the union of disjoint key ranges from each
    range's ``(out, lse)`` (``decode_attention``'s with ``return_lse``):
    ``M = max lse``, ``w = exp(lse - M)``, ``out = Σ w·out / Σ w``, ``lse =
    M + log Σ w``. A partial whose lse is -inf (its range held no key the
    row sees) weighs 0; a row no partial saw gives 0 and -inf, with no NaN.

    Without reducers ``out`` (n, B, H, D) and ``lse`` (n, B, H) hold the n
    partials stacked; with them, this rank's (B, H, D) and (B, H), and
    ``reduce_max`` / ``reduce_sum`` take the elementwise max / sum of a
    tensor over the ranks (all-reduces). Returns (out in out's dtype, lse
    fp32). Plain PyTorch arithmetic: no attention runs here."""
    if reduce_max is None:
        def reduce_max(t):
            return t.amax(dim=0)

        def reduce_sum(t):
            return t.sum(dim=0)
    m = reduce_max(lse)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse - m)
    total = reduce_sum(torch.cat([w[..., None], w[..., None] * out.float()],
                                 dim=-1))
    l = total[..., 0]
    merged = total[..., 1:] / l.clamp_min(1e-30)[..., None]
    return (merged.to(out.dtype),
            torch.where(l > 0, m + torch.log(l), -math.inf))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, its ctypes signatures set once."""
    lib = build.load("decode_attention")
    lib.decode_attention_occupancy.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lib.decode_attention_occupancy.restype = ctypes.c_int
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.decode_attention_launch.restype = ctypes.c_int
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


def _chunks_per_lane(D: int, itemsize: int) -> int:
    """16-byte chunks of a row each lane of a half-warp owns: 1, 2 or 4."""
    nbytes = D * itemsize
    return 1 if nbytes <= 256 else 2 if nbytes <= 512 else 4


def tile_keys(D: int, itemsize: int) -> int:
    """Keys a stage of the kernel's ring holds: 16 KB of K and V rows, and
    at least one key for each half-warp."""
    return max(_SUB_WARPS, 32 // _chunks_per_lane(D, itemsize))


def heads_per_block(G: int, D: int) -> int:
    """Query heads of one KV head a block takes (the kernel's GB): the next
    power of two of G, at most 8, at most 4 where D > 128."""
    for gb in (1, 2, 4):
        if G <= gb:
            return gb
    return 4 if D > 128 else 8


def split_plan(B: int, KV: int, G: int, D: int, itemsize: int, n_keys: int,
               blocks_per_sm: int, n_sm: int) -> Tuple[int, int]:
    """(n_splits, keys_per_split) over a key range of ``n_keys``: as many
    splits as one wave at ``blocks_per_sm`` has room for beside the B * KV *
    row groups' blocks of one split, none shorter than ``_MIN_SPLIT_KEYS``
    keys, each a whole number of the ring's tiles. One split where one
    split alone fills the wave."""
    tile = tile_keys(D, itemsize)
    base = B * KV * -(-G // heads_per_block(G, D))
    n = max(1, min(blocks_per_sm * n_sm // base,
                   -(-n_keys // _MIN_SPLIT_KEYS)))
    per = -(-n_keys // n)
    per = -(-per // tile) * tile
    return -(-n_keys // per), per


def _blocks_per_sm(device: int, H: int, KV: int, D: int, code: int) -> int:
    key = (device, H // KV, KV, D, code)
    if key not in _occupancy:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _lib().decode_attention_occupancy(H, KV, D, code,
                                                   ctypes.byref(n))
        if rc != 0 or n.value < 1:
            raise RuntimeError(f"decode attention occupancy query failed: "
                               f"CUDA error {rc}, {n.value} blocks")
        _occupancy[key] = n.value
    return _occupancy[key]


@functools.lru_cache(maxsize=None)
def _plan(B: int, S: int, H: int, KV: int, D: int, window: int,
          dtype: torch.dtype, device: int) -> Tuple[int, int]:
    """The launch's split plan from shapes alone (``window`` < 0: none),
    cached: it never reads ``valid_len`` back from the card."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    n_keys = S if window < 0 else max(min(S, window), 1)
    occ = _blocks_per_sm(device, H, KV, D, _DTYPE_CODES[dtype])
    return split_plan(B, KV, H // KV, D, dtype.itemsize, n_keys, occ,
                      _sm_counts[device])


def _counter_buffer(device: int, stream: int, n: int) -> torch.Tensor:
    """The merge's arrival counters for calls on ``stream``: zeroed once,
    and left at 0 by every launch."""
    buf = _counters.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = _counters[(device, stream)] = torch.zeros(
            n, dtype=torch.int32, device=device)
    return buf


def _signature_args(q, k, v, valid_len, window, softcap, key) -> tuple:
    """The checks and the plan of one call signature, done once."""
    _check_cuda_args(q, k, v, valid_len, window)
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    device = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    n_splits, per = _plan(B, S, H, KV, D,
                          -1 if window is None else int(window), q.dtype,
                          device)
    n_counters = B * KV * -(-(H // KV) // heads_per_block(H // KV, D))
    ints = (B, S, H, KV, D, -1 if window is None else int(window), n_splits,
            per, 1.0 / math.sqrt(D), float(softcap or 0.0),
            _DTYPE_CODES[q.dtype])
    _signatures[key] = (device, n_splits, n_counters, ints)
    return _signatures[key]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     return_lse: bool = False):
    """Flash-decoding of one (B, H, D) query per row against a (B, S, KV,
    D) cache with (B,) valid lengths, an optional sliding ``window`` and
    ``softcap``. Returns (B, H, D), and with ``return_lse`` also the (B, H)
    fp32 log-sum-exp, written by the same launch (without it the launch is
    the same, and writes none).

    CPU tensors take ``decode_attention_plain``. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count one launch
    in ``decode_attention.launches``; whatever the kernel does not take
    raises. Shapes, dtypes, devices and options are checked, and the split
    plan made, once per call signature; contiguity and alignment, which
    depend on the tensors themselves, on every call."""
    if q.device.type == "cpu":
        for t in (k, v, valid_len):
            if t.device.type != "cpu":
                raise ValueError(f"mixed devices: q on cpu, an input on "
                                 f"{t.device}")
        return decode_attention_plain(q, k, v, valid_len, window, softcap,
                                      return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    key = (q.shape, k.shape, v.shape, valid_len.shape, q.dtype, k.dtype,
           v.dtype, valid_len.dtype, q.device, k.device, v.device,
           valid_len.device, window, softcap)
    args = _signatures.get(key)
    if args is None:
        args = _signature_args(q, k, v, valid_len, window, softcap, key)
    for t in (q, k, v, valid_len):
        if t.data_ptr() % 16 or not t.is_contiguous():
            _check_cuda_args(q, k, v, valid_len, window)   # raises
    device, n_splits, n_counters, ints = args
    fn = _lib().decode_attention_launch
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
           if return_lse else None)
    if device == torch.cuda.current_device():
        rc = _launch(fn, q, k, v, valid_len, out, lse, device, n_splits,
                     n_counters, ints)
    else:
        with torch.cuda.device(device):
            rc = _launch(fn, q, k, v, valid_len, out, lse, device, n_splits,
                         n_counters, ints)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


def _launch(fn, q, k, v, valid_len, out, lse, device, n_splits, n_counters,
            ints) -> int:
    """One launch on the current device's current stream; with splits,
    their fp32 partials (torch.empty on that stream) and its counters."""
    stream = torch.cuda.current_stream().cuda_stream
    part = counters = None
    if n_splits > 1:
        B, H, D = q.shape
        part = torch.empty(B * H * n_splits * (D + 2), dtype=torch.float32,
                           device=q.device)
        if torch.cuda.is_current_stream_capturing():
            # a launch captured into a CUDA graph takes counters from the
            # graph's pool, zeroed by the graph itself at every replay: a
            # buffer kept for the capture stream would be allocated inside
            # the capture, zeroed only at that graph's first replay, and
            # baked into every later graph, whose replays would then rely
            # on it outliving the graph that zeroed it
            counters = torch.zeros(n_counters, dtype=torch.int32,
                                   device=q.device)
        else:
            counters = _counter_buffer(device, stream, n_counters)
    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
              out.data_ptr(), 0 if part is None else part.data_ptr(),
              0 if counters is None else counters.data_ptr(),
              0 if lse is None else lse.data_ptr(), *ints, stream)


decode_attention.launches = 0
