"""Paged attention straight out of the serving tier's KV block pool, indexed
by per-sequence block tables; the port of
``src/repro/kernels/paged_attention.py`` (the Pallas ``_paged_kernel``).

Per layer the pool holds ``(num_blocks, bt, KV, D)`` K and V pages whose
rows belong to prefix chains, not slots. Block ``i`` of ``tables[b]``
covers logical positions ``[i*bt, (i+1)*bt)`` whatever row backs it, and
query token ``(b, j)`` attends the positions ``kpos <= qpos[b, j]``: one
mask for valid lengths, causality inside a prefill chunk and right-padded
rows. ``S`` query tokens and the ``G`` query heads of one KV head form one
``(S*G, D)`` tile that shares the streamed pages.

* ``paged_decode_attention`` — the wrapper. On CUDA tensors it launches
  the hand-written kernel ``csrc/paged_attention.cu`` (built at first
  use) or raises; on CPU tensors it runs the plain version. The kernel
  has three designs, chosen from the dtype and the shapes alone
  (``paged_design``): tensor-core tiles for bf16 (16 rows for the decode
  steps, 64 for the prefill chunks), flash-decoding on the SIMT units for
  f32. Each splits the block table's key range over blocks and merges the
  splits in a second pass; the plan (``split_plan``) is fixed by the
  shapes and cached, so the host never reads ``qpos``.
* ``paged_attention_plain`` — the same function in plain PyTorch: gather
  the pages, dense fp32 masked softmax. The CPU tests use it, and the
  kernel is held against it on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DESIGN_CODES = {"simt": 0, "mma64": 1, "mma16": 2}
# rows a KV head (S*G) from which bf16 calls take 64-row tensor-core tiles
MMA64_MIN_ROWS = 17
# the table's key range is split over blocks until the grid holds about
# _BLOCKS_PER_SM blocks per SM. Per design: the rows a block takes (at most;
# the grid is this many times smaller than the rows a KV head), the fewest
# keys a split walks (two of the mma kernels' stages, so a block's copies
# overlap its products), and the step its length is a multiple of (the
# simt kernel's 8 half-warps x 4 keys; the mma kernels' stages)
_BLOCKS_PER_SM = 4
# a block looks up its keys' pool rows into shared memory: at most this many
_MAX_SPLIT_KEYS = 4096
_SPLIT_SHAPE = {"simt": (8, 64, 32), "mma64": (64, 128, 64),
                "mma16": (16, 128, 64)}


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, tables: torch.Tensor,
                          qpos: torch.Tensor,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k_pages, v_pages: (num_blocks, bt, KV, D); tables:
    (B, NW) int pool rows in chain order; qpos: (B, S) absolute position of
    each query token. Returns (B, S, H, D) in q's dtype.

    The kernel's semantics, not the reference's ``_sdpa``: scores on
    ``q * scale`` in fp32, softcap, then the mask; probabilities stay fp32
    through PV (``_sdpa`` casts them to v's dtype); a row that sees no key
    is 0."""
    B, S, H, D = q.shape
    bt, KV = k_pages.shape[1], k_pages.shape[2]
    NW = tables.shape[1]
    G = H // KV
    rows = tables.long()
    kc = k_pages[rows].reshape(B, NW * bt, KV, D).float()
    vc = v_pages[rows].reshape(B, NW * bt, KV, D).float()
    qg = q.reshape(B, S, KV, G, D).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)        # (B,KV,G,S,L)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(NW * bt, device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, vc) / l   # (B,KV,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def paged_design(S: int, G: int, dtype: torch.dtype) -> str:
    """The kernel's design for a call of S query tokens of G heads a KV
    head: for bf16, tensor-core tiles of 64 rows ("mma64", more than 16
    rows a KV head: the prefill chunks) or of 16 rows whose warps share
    the keys ("mma16": the decode steps); for f32 the SIMT units
    ("simt"), so f32 products stay f32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "mma64" if S * G >= MMA64_MIN_ROWS else "mma16"


def split_plan(design: str, B: int, S: int, G: int, KV: int, bt: int,
               NW: int, n_sm: int) -> Tuple[int, int]:
    """(n_splits, keys_per_split) for ``design``: ranges of keys_per_split
    keys that cover the table's [0, NW*bt) exactly (the last one may run
    past its end), enough of them for about ``_BLOCKS_PER_SM`` blocks per
    SM over the B x KV x row-group grid, none longer than
    ``_MAX_SPLIT_KEYS``. Integers in, integers out: no tensor value enters
    the plan."""
    rows, min_keys, step = _SPLIT_SHAPE[design]
    n_keys = NW * bt
    base = B * KV * -(-(S * G) // rows)
    want = -(-_BLOCKS_PER_SM * n_sm // base)
    n = max(1, min(want, -(-n_keys // min_keys)),
            -(-n_keys // _MAX_SPLIT_KEYS))
    per = -(-n_keys // n)
    per = -(-per // step) * step
    return -(-n_keys // per), per


@functools.lru_cache(maxsize=None)
def _plan(B: int, S: int, H: int, KV: int, bt: int, NW: int,
          dtype: torch.dtype, device: int) -> Tuple[int, int, int]:
    """(design code, n_splits, keys_per_split) for a call's shapes on a
    device, computed once per shape."""
    design = paged_design(S, H // KV, dtype)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return (_DESIGN_CODES[design],
            *split_plan(design, B, S, H // KV, KV, bt, NW, n_sm))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_args(q, k_pages, v_pages, tables, qpos) -> None:
    """Everything the kernel does not take raises here, before a pointer
    crosses into C."""
    named = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
             "tables": tables, "qpos": qpos}
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"stages pages with 16-byte copies)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("k_pages and v_pages must have q's dtype")
    if tables.dtype != torch.int32 or qpos.dtype != torch.int32:
        raise TypeError("tables and qpos must be int32")
    if q.ndim != 4 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"q (B,S,H,D) and pages (NB,bt,KV,D) expected, got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, S, H, D = q.shape
    KV = k_pages.shape[2]
    if k_pages.shape[3] != D or H % KV:
        raise ValueError(f"head dims do not match: q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    if D % 8 or D > 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, "
                         f"got {D}")
    if tables.ndim != 2 or tables.shape[0] != B or tables.shape[1] < 1:
        raise ValueError(f"tables must be (B={B}, NW>=1), got "
                         f"{tuple(tables.shape)}")
    if tuple(qpos.shape) != (B, S):
        raise ValueError(f"qpos must be (B={B}, S={S}), got "
                         f"{tuple(qpos.shape)}")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           qpos: torch.Tensor, *,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Paged attention of a (B, S, H, D) query chunk against pool pages
    (num_blocks, bt, KV, D) addressed by block tables (B, NW); query (b, j)
    attends logical positions <= qpos[b, j]. Returns (B, S, H, D).

    CPU tensors take ``paged_attention_plain``. CUDA tensors launch the
    kernel on the current stream (no synchronisation) and count one launch
    in ``paged_decode_attention.launches``; whatever the kernel does not
    take raises. Table entries are trusted to name rows of the pool."""
    if q.device.type == "cpu":
        for t in (k_pages, v_pages, tables, qpos):
            if t.device.type != "cpu":
                raise ValueError(f"mixed devices: q on cpu, an input on "
                                 f"{t.device}")
        return paged_attention_plain(q, k_pages, v_pages, tables, qpos,
                                     softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, "
                         f"got {q.device}")
    _check_cuda_args(q, k_pages, v_pages, tables, qpos)
    B, S, H, D = q.shape
    bt, KV, NW = k_pages.shape[1], k_pages.shape[2], tables.shape[1]
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    design, n_splits, per = _plan(B, S, H, KV, bt, NW, q.dtype, dev)
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if n_splits > 1:
        # per-split softmax state (m, l) and unnormalised accumulators of
        # each output row, merged by the kernel's second pass
        part_ml = torch.empty((B * S * H, n_splits, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B * S * H, n_splits, D),
                               dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
            0 if part_ml is None else part_ml.data_ptr(),
            0 if part_acc is None else part_acc.data_ptr(),
            B, S, H, KV, D, bt, NW, n_splits, per,
            1.0 / math.sqrt(D), float(softcap or 0.0), _DTYPE_CODES[q.dtype],
            design, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
