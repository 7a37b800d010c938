"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (h_{-1} = 0),
elementwise over the width W; the port of ``src/repro/kernels/rglru_scan.py``
(the Pallas ``_rglru_kernel``).

* ``rglru_scan`` — the wrapper, a ``torch.autograd.Function``. Its forward
  launches the hand-written kernel ``csrc/rglru_scan.cu`` on CUDA tensors
  or raises, and runs ``rglru_scan_plain`` on CPU tensors. Its backward
  runs the same kernel in reverse mode on CUDA (``rglru_scan_reverse``)
  and ``rglru_scan_bwd_plain`` on CPU.
* ``rglru_scan_plain`` — a sequential loop over T, as the reference's
  oracle ``kernels/ref.py:rglru_ref``, differentiable by autograd.
* ``rglru_scan_bwd_plain`` — the adjoint recurrence
  ``c_t = g_t + a_{t+1} * c_{t+1}``, with ``db_t = c_t`` and
  ``da_t = c_t * h_{t-1}``, over the saved outputs.
* ``rglru_plan`` — the kernel's launch plan (stripe width, steps a stage,
  ring depth, blocks) from the shapes and the card's SM count; the wrapper
  caches it per device and shape, and checks each call signature once.

Kernel and plain versions take every product and sum in the same order,
each rounded on its own (no fused multiply-add), so on the card they agree
bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from . import build


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, T, W) fp32. Returns (y (B, T, W), h_last (B, W))."""
    h = torch.zeros_like(a[:, 0])
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1)
    return y, y[:, -1]


def rglru_scan_bwd_plain(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``y = rglru_scan_plain(a, b)[0]`` for ``dy``: (da,
    db), each (B, T, W) fp32."""
    T = a.shape[1]
    c = torch.zeros_like(dy[:, 0])
    da, db = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        c = dy[:, t] + a[:, t + 1] * c if t + 1 < T else dy[:, t].clone()
        db[t] = c
        da[t] = c * y[:, t - 1] if t > 0 else torch.zeros_like(c)
    return torch.stack(da, dim=1), torch.stack(db, dim=1)


# floats of one array a stage of the kernel's ring holds (csrc kStageFloats)
_STAGE_FLOATS = 512
# the ring's depth for each mode (the kernel takes 2 to 8): the fastest at
# B=2 and B=1, T=4096, W=4096 on an H100 80GB HBM3 at 700 W, where the
# reverse mode (three reads and two writes a step) ran best with 2 stages
# in flight and the forward (two reads, one write) with 5; chip_smoke.py's
# K5 line prints the plan beside the times of the others
_STAGES = {False: 6, True: 3}
_sm_counts: Dict[int, int] = {}
# per call signature: (device, plan), once its shapes, dtypes and devices
# have passed _check_cuda_args
_signatures: Dict[tuple, Tuple[int, "RGLRUPlan"]] = {}


class RGLRUPlan(NamedTuple):
    channels: int   # the stripe a block walks: neighbouring channels of a row
    steps: int      # steps of the stripe a stage of the ring holds
    stages: int     # stages of the ring
    blocks: int     # blocks of the launch: B * ceil(W / channels)


def rglru_plan(B: int, T: int, W: int, sm_count: int,
               reverse: bool = False) -> RGLRUPlan:
    """The kernel's launch plan from shapes alone: stripes of 32 channels
    (128-byte rows) where they give every SM a block, else of 16; each
    stage holds ``_STAGE_FLOATS`` floats of every input (16 steps of 32
    channels or 32 of 16), and the ring is ``_STAGES[reverse]`` stages
    deep, or one more than the walk's stages where T is short."""
    channels = 32 if B * -(-W // 32) >= sm_count else 16
    steps = _STAGE_FLOATS // channels
    stages = max(2, min(_STAGES[reverse], -(-T // steps) + 1))
    return RGLRUPlan(channels, steps, stages, B * -(-W // channels))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, its ctypes signature set once."""
    lib = build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.rglru_scan_launch.restype = ctypes.c_int
    return lib


def _check_cuda_args(**named) -> None:
    """Everything the kernel does not take raises here, before a pointer
    crosses into C."""
    first = next(iter(named.values()))
    for name, t in named.items():
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, the first input on "
                             f"{first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the RG-LRU scan kernel takes float32, {name} "
                            f"is {t.dtype}")
        if t.ndim != 3 or t.shape != first.shape:
            raise ValueError(f"(B, T, W) inputs of one shape expected, "
                             f"{name} is {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, T, W = first.shape
    if B > 65535 or T < 1:
        raise ValueError(f"at most 65535 rows and at least one step, got "
                         f"B={B}, T={T}")


def _device(*ts) -> str:
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"the RG-LRU scan runs on cuda or cpu tensors, all on "
                     f"one device; got {sorted(kinds)}")


@functools.lru_cache(maxsize=None)
def _plan(B: int, T: int, W: int, reverse: bool, device: int) -> RGLRUPlan:
    """``rglru_plan`` on the device's SM count (asked once a device),
    cached: it never reads a tensor."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return rglru_plan(B, T, W, _sm_counts[device], reverse)


def _signature(**named) -> Tuple[int, RGLRUPlan]:
    """(device, plan) of the call, forward with two inputs and reverse
    with three: the checks and the plan once per call signature;
    contiguity, which depends on the tensors themselves, on every call."""
    key = tuple((t.shape, t.dtype, t.device) for t in named.values())
    sig = _signatures.get(key)
    if sig is None:
        _check_cuda_args(**named)
        first = next(iter(named.values()))
        device = first.device.index
        sig = _signatures[key] = (device, _plan(*first.shape,
                                                len(named) == 3, device))
    for t in named.values():
        if not t.is_contiguous():
            _check_cuda_args(**named)   # raises
    return sig


def _launch(a, u, y, da, db, device: int, plan: RGLRUPlan) -> None:
    """K5 on the device's current stream. Forward (``da`` None): reads a
    and u = b, writes y. Reverse: reads a, u = dL/dy and y, writes da and
    db."""
    B, T, W = a.shape
    args = (a.data_ptr(), u.data_ptr(), y.data_ptr(),
            0 if da is None else da.data_ptr(),
            0 if db is None else db.data_ptr(), B, T, W, int(da is not None),
            plan.channels, plan.stages)
    fn = _lib().rglru_scan_launch
    if device == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RG-LRU scan kernel launch failed: CUDA error "
                           f"{rc}")


def rglru_scan_forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y without autograd: the kernel on CUDA tensors (one launch counted
    in ``rglru_scan.launches``), the plain version on CPU tensors, and on
    fake tensors (the dry run) the kernel's output, shape and dtype only,
    as the kernel allocates it (the plain version's loop over time would
    take the dry run hours)."""
    if is_fake(a):
        return torch.empty_like(a)
    if _device(a, b) == "cpu":
        return rglru_scan_plain(a, b)[0]
    device, plan = _signature(a=a, b=b)
    y = torch.empty_like(a)
    _launch(a, b, y, None, None, device, plan)
    rglru_scan.launches += 1
    return y


def rglru_scan_reverse(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of the recurrence for ``dy``: the kernel's reverse mode on
    CUDA tensors (one launch counted in ``rglru_scan_reverse.launches``),
    ``rglru_scan_bwd_plain`` on CPU tensors; on fake tensors the kernel's
    outputs, shapes and dtypes only."""
    if is_fake(a):
        return torch.empty_like(a), torch.empty_like(a)
    if _device(a, y, dy) == "cpu":
        return rglru_scan_bwd_plain(a, y, dy)
    device, plan = _signature(a=a, y=y, dy=dy)
    da, db = torch.empty_like(a), torch.empty_like(a)
    _launch(a, dy, y, da, db, device, plan)
    rglru_scan_reverse.launches += 1
    return da, db


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        y = rglru_scan_forward(a, b)
        ctx.save_for_backward(a, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        a, y = ctx.saved_tensors
        return rglru_scan_reverse(a, y, dy.contiguous())


def rglru_scan(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over (B, T, W) fp32 ``a`` and ``b``: (y (B, T, W),
    h_last (B, W) = y[:, -1]), differentiable. CPU tensors take the plain
    versions; CUDA tensors launch the kernel (forward and reverse mode) or
    raise on what it does not take."""
    y = _RGLRUScan.apply(a, b)
    return y, y[:, -1]


rglru_scan.launches = 0
rglru_scan_reverse.launches = 0
