"""Shared per-block quantization — the transcode kernels behind KV-cache
tiering (``serve.TieredKVStore``); a port of ``src/repro/quant.py``.

One storage format = one ``QuantSpec``: symmetric scale-per-block
quantization into a 1-byte dtype (int8, or ``torch.float8_e4m3fn``). The
arithmetic is the reference's, exposed three ways:

* **batched torch functions over pool-row layouts** (any device) —
  stacked chain blocks shaped ``(n, *lead, bt, KV, D)`` quantize with one
  f32 scale per ``(row, *lead)`` sub-block: the amax reduction runs over
  the trailing ``(bt, KV, D)`` axes only. ``serve.kv_pool`` runs them on
  the device inside its row gather, so only the narrow bytes (+ tiny
  scales) cross to the host.
* **numpy twins** (``*_np``) for host↔disk transcodes, bit-identical to
  the reference's.
* **per-tensor helpers** (one scale per tensor).

**Host storage without bf16 or fp8 dtypes.** numpy has neither, so the
host holds those elements as integers of the same width: bf16 as
``uint16`` bit patterns, fp8 as ``uint8`` (``storage_dtype``);
``to_host``/``from_host`` convert between a torch tensor and its host
array without touching a bit, and every ``*_np`` function reads a
``uint16``/``uint8`` array as bf16/fp8. No other host array in the port
has those dtypes, so the reading is never ambiguous. Byte counts are
unchanged: ``QuantSpec.itemsize`` is 1 and a bf16 row prices 2 bytes an
element, as in the reference.

``compression_ratio`` is the single source of truth for stored-bytes
accounting: it includes the f32 scale-array overhead and prices the
*actual* source dtype (bf16 sources compress 2x into int8, not 4x).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .models.common import tree_map

# all-zero blocks quantize against this floor (q == 0 everywhere, and the
# dequantized block is exactly zero)
_EPS = 1e-12
SCALE_DTYPE = np.dtype(np.float32)
_AXES = (-3, -2, -1)

# torch dtypes numpy lacks -> the same-width integer the host stores
_STORAGE = {torch.bfloat16: np.dtype(np.uint16),
            torch.float8_e4m3fn: np.dtype(np.uint8)}
_LOGICAL = {v: k for k, v in _STORAGE.items()}
# the integer views that carry those bits between torch and numpy (torch's
# uint16 has no numpy bridge on every version, so bf16 passes as int16)
_VIEW = {torch.bfloat16: (torch.int16, np.dtype(np.int16)),
         torch.float8_e4m3fn: (torch.uint8, np.dtype(np.uint8))}


def storage_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype the host stores elements of torch ``dtype`` in."""
    if dtype in _STORAGE:
        return _STORAGE[dtype]
    return torch.empty((), dtype=dtype).numpy().dtype


def to_host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as its host array (shared memory, bits unchanged)."""
    if t.dtype in _STORAGE:
        return t.view(_VIEW[t.dtype][0]).numpy().view(_STORAGE[t.dtype])
    return t.numpy()


def from_host(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor of its logical dtype (shared memory,
    bits unchanged): ``uint16`` reads as bf16, ``uint8`` as fp8."""
    logical = _LOGICAL.get(a.dtype)
    if logical is None:
        return torch.from_numpy(a)
    return torch.from_numpy(a.view(_VIEW[logical][1])).view(logical)


def logical_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype whose elements host storage dtype ``dtype`` holds
    (``uint16`` -> bf16, ``uint8`` -> fp8, the rest their own)."""
    if dtype in _LOGICAL:
        return _LOGICAL[dtype]
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def as_storage(a, dtype: np.dtype) -> np.ndarray:
    """``a`` (a host array or a CPU tensor) in host storage dtype
    ``dtype``, values cast as their logical dtypes cast; an array already
    in ``dtype`` is returned as it is."""
    dtype = np.dtype(dtype)
    if not isinstance(a, torch.Tensor):
        if a.dtype == dtype:
            return a
        if a.dtype not in _LOGICAL and dtype not in _LOGICAL:
            return np.asarray(a, dtype=dtype)
        a = from_host(np.ascontiguousarray(a))
    return to_host(a.contiguous().to(logical_dtype(dtype)))


def _f32_np(x) -> np.ndarray:
    """``x`` (host array or tensor) widened to an f32 numpy array; exact
    for every source dtype the pools hold."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    if x.dtype in _LOGICAL:
        return from_host(np.ascontiguousarray(x)).to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@dataclass(frozen=True)
class QuantSpec:
    """One symmetric quantized storage format.

    ``qmax`` is the largest representable magnitude after scaling (127 for
    int8; 448, the float8_e4m3fn max, for fp8). ``rt_bound`` bounds the
    round-trip error: ``|x - dequant(quant(x))| <= rt_bound * amax(block)``
    element-wise. ``dtype`` is the torch dtype of the quantized elements,
    ``storage`` the numpy dtype the host keeps them in. ``reduce_amax``,
    when set, maps each block's amax to its max over the ranks of a
    tensor-parallel group (``sharding.KVShardCtx.bind``): a rank holding
    a head slice of the block then scales it as the whole block scales;
    it takes no part in equality. Frozen and hashable."""

    name: str
    qmax: float
    dtype: torch.dtype
    rt_bound: float
    reduce_amax: Optional[Callable[[torch.Tensor], torch.Tensor]] = field(
        default=None, compare=False, repr=False)

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def is_int(self) -> bool:
        return not self.dtype.is_floating_point

    @property
    def storage(self) -> np.dtype:
        return storage_dtype(self.dtype)


INT8 = QuantSpec("int8", 127.0, torch.int8, 1.0 / 254.0)
FP8 = QuantSpec("fp8", 448.0, torch.float8_e4m3fn, 16.0 / 448.0)

SPECS = {"int8": INT8, "fp8": FP8}


def get_spec(name: Union[str, QuantSpec, None]) -> Optional[QuantSpec]:
    """Resolve a CLI-style name to a spec; ``None``/``"none"`` -> None
    (lossless — every transcode path degrades to a plain copy)."""
    if name is None or isinstance(name, QuantSpec):
        return name
    key = name.lower()
    if key in ("none", ""):
        return None
    if key not in SPECS:
        raise ValueError(f"unknown quant format {name!r}; "
                         f"have {sorted(SPECS)} or 'none'")
    return SPECS[key]


# ---------------------------------------------------------------------------
# Batched block functions (torch, any device)
# ---------------------------------------------------------------------------

def _scale(amax: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """``max(amax, eps) / qmax`` as a true division. The divisor is a
    tensor: CUDA's division by a Python scalar multiplies by the scalar's
    reciprocal, which lands one ulp off the quotient for some amax (as
    XLA's lowering does, ``tests/test_torch_quant.py``)."""
    return amax.clamp_min(_EPS) / torch.full_like(amax, spec.qmax)


def _encode(y: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Scaled values -> storage dtype. |y| <= qmax by construction, so the
    fp8 cast never overflows and the int8 round (half to even) stays
    inside [-127, 127] up to the explicit clip."""
    if spec.is_int:
        return torch.round(y).clamp_(-spec.qmax, spec.qmax).to(spec.dtype)
    return y.to(spec.dtype)


def quantize_blocks(x: torch.Tensor, spec: QuantSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize stacked chain blocks ``(n, *mid, bt, KV, D)`` with one f32
    scale per ``(n, *mid)`` sub-block. Returns ``(q, scales)`` where ``q``
    has ``x``'s shape in ``spec.dtype`` and ``scales`` drops the trailing
    three axes. Both divides are true divisions, as the numpy twin's."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=_AXES, keepdim=True)
    if spec.reduce_amax is not None:
        amax = spec.reduce_amax(amax)
    scale = _scale(amax, spec)
    q = _encode(xf / scale, spec)
    return q, scale.reshape(scale.shape[:-3])


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, dtype: Any
                      ) -> torch.Tensor:
    """Invert ``quantize_blocks``: scales broadcast back over the trailing
    ``(bt, KV, D)`` axes."""
    return (q.to(torch.float32)
            * scales[..., None, None, None]).to(dtype)


# the reference's jitted entry points; the torch functions run as they are
quantize_rows = quantize_blocks
dequantize_rows = dequantize_blocks


# ---------------------------------------------------------------------------
# numpy twins (host <-> disk transcodes; no device in the loop)
# ---------------------------------------------------------------------------

def quantize_blocks_np(x, spec: QuantSpec) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's numpy quantize on a host array (bf16 as ``uint16``)
    or a tensor. Returns ``(q, scales)``: ``q`` in ``spec.storage`` (fp8
    as ``uint8`` bit patterns), bit-identical to the reference's."""
    xf = _f32_np(x)
    amax = np.max(np.abs(xf), axis=_AXES, keepdims=True)
    if spec.reduce_amax is not None:
        amax = spec.reduce_amax(torch.from_numpy(amax)).numpy()
    scale = np.maximum(amax, _EPS) / spec.qmax
    y = xf / scale
    if spec.is_int:
        q = np.clip(np.round(y), -spec.qmax, spec.qmax).astype(spec.storage)
    else:
        q = to_host(torch.from_numpy(y).to(spec.dtype))
    return q, np.squeeze(scale, _AXES).astype(SCALE_DTYPE)


def dequantize_blocks_np(q, scales, dtype: Any) -> np.ndarray:
    """Invert ``quantize_blocks_np``; ``dtype`` a numpy or torch dtype
    (bf16 comes back as ``uint16``)."""
    out = _f32_np(q) * np.asarray(scales, np.float32)[..., None, None, None]
    if isinstance(dtype, torch.dtype):
        return as_storage(out, storage_dtype(dtype))
    return out.astype(dtype)


def transcode_tree_np(blocks, scales, src_spec: Optional[QuantSpec],
                      dst_spec: Optional[QuantSpec]):
    """Re-encode a tree of stacked blocks from one storage format to
    another (host→disk demotion to a narrower dtype). ``scales`` is the
    matching scales tree (None when ``src_spec`` is None). Returns
    ``(blocks', scales')`` in ``dst_spec``'s format; same-format transcodes
    are the identity (no precision loss). For a quantized→lossless
    transcode the blocks dequantize to f32 and the destination pool's
    write cast lands them in its leaf dtype."""
    if src_spec == dst_spec:
        return blocks, scales
    if src_spec is not None:        # widen to f32 first
        blocks = tree_map(
            lambda q, s: dequantize_blocks_np(q, s, np.float32),
            blocks, scales)
        scales = None
    if dst_spec is None:
        return blocks, None
    return (tree_map(lambda b: quantize_blocks_np(b, dst_spec)[0], blocks),
            tree_map(lambda b: quantize_blocks_np(b, dst_spec)[1], blocks))


# ---------------------------------------------------------------------------
# Per-tensor helpers
# ---------------------------------------------------------------------------

def quantize_tensor(x: torch.Tensor, spec: QuantSpec = INT8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-tensor symmetric quantization (one scalar scale)."""
    xf = x.to(torch.float32)
    scale = _scale(xf.abs().amax(), spec)
    return _encode(xf / scale, spec), scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor,
                      dtype: Any = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------

def _itemsize(dtype: Any) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def compression_ratio(numel: int, src_dtype: Any,
                      spec: Optional[QuantSpec] = INT8,
                      n_scales: int = 1) -> float:
    """Stored-bytes ratio lossless/quantized for ``numel`` elements of
    ``src_dtype`` (torch or numpy) carried with ``n_scales`` f32 scales.
    It prices the actual source dtype (bf16 -> int8 is 2x, not 4x) and
    charges the scale array. ``spec=None`` (lossless) is ratio 1."""
    if spec is None:
        return 1.0
    src = _itemsize(src_dtype) * numel
    return src / (spec.itemsize * numel + SCALE_DTYPE.itemsize * n_scales)
