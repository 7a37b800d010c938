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

Kernel and plain versions take every product and sum in the same order,
each rounded on its own (no fused multiply-add), so on the card they agree
bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

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


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
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


def _launch(a, u, y, da, db, reverse: bool) -> None:
    """K5 on the current stream. Forward: reads a and u = b, writes y.
    Reverse: reads a, u = dL/dy and y, writes da and db."""
    B, T, W = a.shape
    with torch.cuda.device(a.device):
        rc = _lib().rglru_scan_launch(
            a.data_ptr(), u.data_ptr(), y.data_ptr(),
            0 if da is None else da.data_ptr(),
            0 if db is None else db.data_ptr(), B, T, W, int(reverse),
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RG-LRU scan kernel launch failed: CUDA error "
                           f"{rc}")


def rglru_scan_forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y without autograd: the kernel on CUDA tensors (one launch counted
    in ``rglru_scan.launches``), the plain version on CPU tensors."""
    if _device(a, b) == "cpu":
        return rglru_scan_plain(a, b)[0]
    _check_cuda_args(a=a, b=b)
    y = torch.empty_like(a)
    _launch(a, b, y, None, None, reverse=False)
    rglru_scan.launches += 1
    return y


def rglru_scan_reverse(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of the recurrence for ``dy``: the kernel's reverse mode on
    CUDA tensors (one launch counted in ``rglru_scan_reverse.launches``),
    ``rglru_scan_bwd_plain`` on CPU tensors."""
    if _device(a, y, dy) == "cpu":
        return rglru_scan_bwd_plain(a, y, dy)
    _check_cuda_args(a=a, y=y, dy=dy)
    da, db = torch.empty_like(a), torch.empty_like(a)
    _launch(a, dy, y, da, db, reverse=True)
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
