"""RWKV6 (Finch) WKV: for each row b and head h, with a data-dependent
per-channel decay ``w_t = exp(logw_t)`` and bonus ``u``,

    out_t = r_t (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

from S_{-1} = 0, over (B, T, H, N) inputs; the port of
``src/repro/kernels/rwkv6_scan.py`` (the Pallas ``_rwkv_kernel``).

* ``rwkv6_wkv`` — the wrapper, a ``torch.autograd.Function``. Its forward
  launches the hand-written kernel ``csrc/rwkv6_scan.cu`` on CUDA tensors
  or raises, and runs ``rwkv6_wkv_plain`` on CPU tensors. Its backward
  recomputes ``rwkv6_wkv_chunked`` under autograd from the saved inputs on
  either device: the reference has no backward kernel (XLA differentiates
  the model's chunk-parallel form), so the backward is not a kernel port.
* ``rwkv6_wkv_plain`` — the forward in plain PyTorch, a loop over chunks
  of C tokens carrying the (N, N) fp32 state, as the Pallas kernel walks
  its sequential chunk axis.
* ``rwkv6_wkv_chunked`` — the reference model's chunk-parallel form
  (``src/repro/models/recurrent.py:238-283``): every chunk's products at
  once, then the state carried across chunks.

No ``exp`` here overflows for logw in [-5, -1e-6]. The plain version
takes every decay factor as the exponent of a difference of cumulative
log decays that is <= 0, so it takes any chunk. The chunked form and the
kernel factor the intra-chunk decay as the reference does,
``exp(lce_t - a0) * exp(a0 - lc_j)``, whose larger exponent reaches
5 * (C - 1); they take chunks of at most ``MAX_CHUNK`` = 16 tokens (75,
under fp32's 88.7). The Pallas kernel's default chunk of 32 (up to 155)
overflows there.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from . import build

MAX_CHUNK = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_chunk(chunk: int) -> None:
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}] (the factored "
                         f"intra-chunk decay overflows fp32 beyond), got "
                         f"{chunk}")


def _pad_time(ts, T_p):
    """Zero-pad (B, T, H, N) tensors to T_p steps: k = 0 adds nothing to
    the state and logw = 0 decays nothing, so the state is unchanged."""
    T = ts[0].shape[1]
    if T_p == T:
        return ts
    return [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, T_p - T)) for t in ts]


def rwkv6_wkv_plain(r, k, v, logw, u, *, chunk: int = 16
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, T, H, N); u: (H, N). Returns (out (B, T, H, N)
    fp32, S_last (B, H, N, N) fp32, the state after the last token). A
    chunk of C = min(chunk, T) tokens at a time; T is padded to a multiple
    of C as the Pallas wrapper pads it."""
    B, T, H, N = r.shape
    C = min(chunk, T)
    nc = -(-T // C)
    rf, kf, vf, lw = _pad_time([t.float() for t in (r, k, v, logw)], nc * C)
    uf = u.float()
    strict = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    S = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(nc):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, lwc = rf[:, sl], kf[:, sl], vf[:, sl], lw[:, sl]
        lc = torch.cumsum(lwc, dim=1)                   # inclusive log decay
        lce = lc - lwc                                  # exclusive
        # intra-chunk, j < t: r_t . (k_j * exp(lce_t - lc_j)), exponent <= 0
        diff = lce[:, :, None] - lc[:, None, :]         # (B, t, j, H, N)
        decay = torch.exp(diff.masked_fill(~strict[None, :, :, None, None],
                                           float("-inf")))
        scores = (rc[:, :, None] * kc[:, None] * decay).sum(-1)
        out = torch.einsum("btjh,bjhm->bthm", scores, vc)
        bonus = (rc * uf * kc).sum(-1)                  # (B, C, H)
        out = out + bonus[..., None] * vc
        # the carried state, decayed to each token
        out = out + torch.einsum("bthn,bhnm->bthm", rc * torch.exp(lce), S)
        outs.append(out)
        last = lc[:, -1]                                # (B, H, N)
        k_out = kc * torch.exp(last[:, None] - lc)
        S = (torch.exp(last)[..., None] * S
             + torch.einsum("bthn,bthm->bhnm", k_out, vc))
    return torch.cat(outs, dim=1)[:, :T], S


def _carry(D, M):
    """The state entering each chunk, for S_c = D_c[..., None] * S_{c-1} +
    M_c from S_{-1} = 0 over axis 1 of D (B, nc, H, N) and M (B, nc, H, N,
    N). Returns (S_prev (B, nc, H, N, N), S_last (B, H, N, N)).

    Two loops of about sqrt(nc) steps each instead of one of nc: a scan
    inside groups of L chunks, all groups at once, from a zero state; the
    carry from group to group; then each group's entering state, decayed,
    added to its scan. Every product is of decays <= 1. At rwkv6-3b's
    training shape (256 chunks) on an H100, the WKV backward takes 21.9
    ms with it and 26.0 ms with a loop over the chunks, and the 1.83 s
    training step 49 ms less (``chip_smoke.py`` times both)."""
    B, nc, H, N = D.shape
    L = math.isqrt(nc - 1) + 1 if nc > 1 else 1
    G = -(-nc // L)
    if G * L != nc:                    # identity chunks at the end
        D = torch.cat([D, D.new_ones((B, G * L - nc, H, N))], dim=1)
        M = torch.cat([M, M.new_zeros((B, G * L - nc, H, N, N))], dim=1)
    Dg, Mg = D.reshape(B, G, L, H, N), M.reshape(B, G, L, H, N, N)
    s = M.new_zeros((B, G, H, N, N))
    d = D.new_ones((B, G, H, N))
    s_prev, d_prev = [], []
    for di, mi in zip(Dg.unbind(2), Mg.unbind(2)):
        s_prev.append(s)
        d_prev.append(d)
        s = di[..., None] * s + mi
        d = d * di
    S = M.new_zeros((B, H, N, N))
    enter = []
    for dg, sg in zip(d.unbind(1), s.unbind(1)):
        enter.append(S)
        S = dg[..., None] * S + sg
    S_prev = (torch.stack(s_prev, dim=2) + torch.stack(d_prev, dim=2)[
        ..., None] * torch.stack(enter, dim=1)[:, :, None])
    return S_prev.reshape(B, G * L, H, N, N)[:, :nc], S


def rwkv6_wkv_chunked(r, k, v, logw, u, *, chunk: int = 16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference model's chunk-parallel WKV (``rwkv_time_mix``'s
    training path): the same (out, S_last) as ``rwkv6_wkv_plain``, with
    every chunk's intra-chunk products taken at once and the state
    carried by ``_carry``. Differentiable by autograd; chunk <= 16."""
    _check_chunk(chunk)
    B, T, H, N = r.shape
    C = chunk
    nc = -(-T // C)
    rf, kf, vf, lw = (t.reshape(B, nc, C, H, N) for t in _pad_time(
        [t.float() for t in (r, k, v, logw)], nc * C))
    uf = u.float()
    lc = torch.cumsum(lw, dim=2)                        # inclusive
    lce = lc - lw                                       # exclusive
    a0 = lc[:, :, :1]                                   # per-chunk shift
    q_in = rf * torch.exp(lce - a0)
    k_in = kf * torch.exp(a0 - lc)
    scores = torch.einsum("bcthn,bcjhn->bchtj", q_in, k_in)
    strict = torch.ones((C, C), dtype=torch.bool, device=r.device).tril(-1)
    scores = torch.where(strict, scores, 0.0)
    out = torch.einsum("bchtj,bcjhn->bcthn", scores, vf)
    bonus = torch.einsum("bcthn,bcthn->bcth", rf, uf * kf)
    out = out + bonus[..., None] * vf
    last = lc[:, :, -1:]                                # (B, nc, 1, H, N)
    Dc = torch.exp(last[:, :, 0])
    k_out = kf * torch.exp(last - lc)
    Mc = torch.einsum("bcthn,bcthm->bchnm", k_out, vf)
    S_prev, S_last = _carry(Dc, Mc)
    out = out + torch.einsum("bcthn,bchnm->bcthm", q_in * torch.exp(a0),
                             S_prev)
    return out.reshape(B, nc * C, H, N)[:, :T], S_last


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, its ctypes signatures set once."""
    lib = build.load("rwkv6_scan")
    fn = lib.rwkv6_wkv_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.rwkv6_wkv_scratch_floats
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return lib


def _check_cuda_args(r, k, v, logw, u, chunk) -> None:
    """Everything the kernel does not take raises here, before a pointer
    crosses into C."""
    _check_chunk(chunk)
    named = {"r": r, "k": k, "v": v, "logw": logw, "u": u}
    for name, t in named.items():
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if r.dtype not in _DTYPE_CODES:
        raise TypeError(f"the RWKV6 WKV kernel takes float32 or bfloat16 "
                        f"r, k, v, got {r.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("k and v must have r's dtype")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"logw and u must be float32, got {logw.dtype} "
                        f"and {u.dtype}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        shapes = [tuple(t.shape) for t in (r, k, v, logw)]
        raise ValueError(f"r, k, v, logw of one (B, T, H, N) shape "
                         f"expected, got {shapes}")
    B, T, H, N = r.shape
    if u.shape != (H, N):
        raise ValueError(f"u must be (H, N) = {(H, N)}, got "
                         f"{tuple(u.shape)}")
    if T < 1 or N > 256 or B * H * -(-T // min(chunk, T)) > 2 ** 31 - 1:
        raise ValueError(f"T >= 1, N <= 256 and B * H * chunks < 2^31 "
                         f"expected, got B={B}, T={T}, H={H}, N={N}")


def _launch(r, k, v, logw, u, chunk):
    """K4 on the current stream: (out, S_last). Counts one launch."""
    _check_cuda_args(r, k, v, logw, u, chunk)
    B, T, H, N = r.shape
    C = min(chunk, T)
    out = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    s_last = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    # the chunk pass's rows for the state pass: r e^lce and k e^(lc_last -
    # lc) of every token, e^lc_last of every chunk, fp32
    lib = _lib()
    scratch = torch.empty(lib.rwkv6_wkv_scratch_floats(B, T, H, N, C),
                          dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), out.data_ptr(), s_last.data_ptr(),
            scratch.data_ptr(), B, T, H, N, C, _DTYPE_CODES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"RWKV6 WKV kernel launch failed: CUDA error "
                           f"{rc}")
    rwkv6_wkv.launches += 1
    return out, s_last


def rwkv6_wkv_forward(r, k, v, logw, u, *, chunk: int = 16
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, S_last) without autograd: the kernel on CUDA tensors, the
    plain version on CPU tensors, and on fake tensors (the dry run) the
    kernel's outputs, shapes and dtypes only, as the kernel allocates them
    (the plain version's loop over the chunks would take the dry run
    hours)."""
    if is_fake(r):
        B, T, H, N = r.shape
        return (r.new_empty((B, T, H, N), dtype=torch.float32),
                r.new_empty((B, H, N, N), dtype=torch.float32))
    kinds = {t.device.type for t in (r, k, v, logw, u)}
    if kinds == {"cpu"}:
        _check_chunk(chunk)
        return rwkv6_wkv_plain(r, k, v, logw, u, chunk=chunk)
    if kinds != {"cuda"}:
        raise ValueError(f"the RWKV6 WKV runs on cuda or cpu tensors, all "
                         f"on one device; got {sorted(kinds)}")
    return _launch(r, k, v, logw, u, chunk)


class _RWKV6WKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk):
        out, s_last = rwkv6_wkv_forward(r, k, v, logw, u, chunk=chunk)
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(s_last)
        return out, s_last

    @staticmethod
    def backward(ctx, dout, _ds_last):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            out, _ = rwkv6_wkv_chunked(*leaves, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], dout))
        return (*(next(grads) if n else None for n in need), None)


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, *, chunk: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV of (B, T, H, N) ``r``, ``k``, ``v`` (float32 or bfloat16)
    and fp32 ``logw`` with the fp32 (H, N) bonus ``u``: (out (B, T, H, N)
    fp32, S_last (B, H, N, N) fp32, not differentiable). chunk <= 16.

    CPU tensors take ``rwkv6_wkv_plain``. CUDA tensors launch the kernel
    on the current stream (no synchronisation) and count one launch in
    ``rwkv6_wkv.launches``; whatever the kernel does not take raises. The
    gradient is autograd's of ``rwkv6_wkv_chunked``, recomputed."""
    _check_chunk(chunk)
    return _RWKV6WKV.apply(r, k, v, logw, u, chunk)


rwkv6_wkv.launches = 0
