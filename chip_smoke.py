"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper GPU: the quickest proof that the port still starts there.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line; any failure raises and the process
exits non-zero:

1. device  — CUDA must be available; the card's name and power limit.
2. build   — compile every kernel of the main paths from the sources in
             the checkout (one nvcc per source, started together).
3. kernel  — hold each kernel against its plain PyTorch version on the
             card (f32 on the reference test's cases, bf16 at the main
             paths' shapes) and time both, the library yardstick and the
             least time the card could take. K1 is the paged-attention
             kernel (its designs, tensor-core tiles in bf16 and SIMT in
             f32, each split over the block table), K2 the flash-decoding
             kernel (the reference test's cases, then the gather path's
             widths on ragged, empty, full and wrapped rows in f32 and
             bf16), K3 the flash-attention kernel of the training forward
             (forward and, through its autograd Function, backward, in
             f32 and bf16; recurrentgemma's L layer and gemma2's G layer
             at S=4096), K5 the RG-LRU
             scan (forward, reverse and gradients, bit-equal, on ragged
             cases; timed at B=1 and B=2, T=4096, W=4096), K4
             the RWKV6 WKV
             (f32 on the reference test's cases and at logw = -5, then
             bf16 r, k, v at rwkv6-3b's training shape B=2, T=4096,
             H=16, N=160; the gradients through its Function against
             autograd of its plain version; the backward's state carry
             against a plain loop over the chunks).
4. parity  — the serve engine on the card (kernels, captured steps)
             against the same engine on the CPU (plain versions, eager),
             smoke configs in f32: the paged plane on qwen2, the gather
             plane on gemma2 and qwen2.
5. serve   — the paged path: full-width qwen2-7b (28 layers, seeded
             random weights, bf16) served through ``ServeEngine(paged=
             True)`` under a LERC prefix cache with byte pressure, each
             step a replayed CUDA graph once its signature has been seen
             twice; every attention launch is counted: K1's wrapper in
             the eager steps and at each capture, and a replay's K1
             launches from its graph's kernel nodes (a replay calls no
             wrapper), 28 a step in all. The same run with
             ``cuda_graphs=False`` (eager) must give the same tokens,
             eviction log and metrics; both print wall, tokens/s, host ms
             a step, steps replayed, captures and launches. Then one
             S=64 decode step through the plain attention and one
             through K1 on the same inputs (each layer's K1 output held
             to its plain version, the logits at 4 layers within
             ``LOGITS_RTOL``, beside the plain version summed in another
             order at 2 to 28 layers); ``steady_decode``: 8 slots all
             decoding, ms a step and device busy and idle share, K1's
             launches, and its runs and device ms in the trace, captured
             beside eager; and a short
             captured run under
             torch.profiler: device busy and idle share, K1's and the
             GEMMs' device time.
6. serve   — the gather path: full-width, full-depth gemma2-27b (46 layers
             alternating rolling-window and global attention, softcaps,
             bf16, seeded random weights) through ``ServeEngine(paged=
             False)`` under a LERC store smaller than the working set;
             every attention is a K2 launch, inside the step's graph.
             Captured beside eager as for qwen2-7b (46 K2 launches a
             step); then one decode step
             through the plain attention and one through K2 with the
             rolling window wrapped, ``steady_decode``, and a short
             profiled run.
7. train   — parity first: the four smoke configs in f32 trained 3
             steps on the card (K3, K5, K4) and on the CPU (plain routes)
             from the same weights and batches. Then the training path at full
             width: recurrentgemma-9b cut to 5 layers (one RRL unit and
             the RR tail), bf16, seeded random weights, 4 AdamW steps at
             batch 2 x 4096 tokens through ``build_train_step``, every
             K3 and K5 launch counted; each layer's K3 and K5 outputs
             held to their plain versions at a step's inputs; a profiled
             step.
8. train   — rwkv6-3b at full width and full depth (32 W layers, bf16,
             seeded random weights), 4 AdamW steps at batch 2 x 4096,
             every K4 launch counted (64 a step: 32 forward and 32
             checkpoint recomputes); each layer's K4 output held to its
             plain version; a profiled step; four more steps, the
             backward's state carry two ways (A B B A).
9. train_resume — rwkv6-3b at full width cut to 4 layers (bf16, seeded
             random weights, batch 2 x 4096) fed by the port's LERC
             ``Executor`` (token and label blocks zipped into peer pairs,
             a cache of 6 token blocks spilling to disk): 6 steps twice
             from fresh states (the determinism control, equal bit for
             bit), then 3 steps, an ``AsyncCheckpointer`` save, the state
             dropped and loaded back, 3 more steps, equal to the
             uninterrupted run bit for bit; 8 K4 launches a step; the
             checkpoint's bytes, snapshot ms, write and load seconds, each
             step's ms and the pipeline's counters printed. Then the
             launcher on the rwkv6 smoke config with ``--ckpt-dir``: run
             through, and preempted by SIGTERM at step 3 and resumed with
             ``--resume``; the two step-6 checkpoints equal byte for byte.
10. the kernels line, the card line, and the result line.

Each path runs with every launch count set to 0 just before it and read
just after; a path whose kernel was never launched fails. In the kernels
line, ``launches`` is a wrapper's count in its path's run (on the serve
paths, the eager steps' launches and one recorded into each graph at its
capture), and K1's and K2's ``device_launches`` those eager launches plus
the launches of the replayed graphs, read from each graph's kernel nodes
(``StepProgram.replayed_kernels``).

It imports only the port, torch and numpy, and needs no network.
"""
from __future__ import annotations

import dataclasses
import filecmp
import gc
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import (Executor, LoaderConfig,  # noqa: E402
                              Pipeline, TrainLoader)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_design  # noqa: E402
from repro_torch.kernels.paged_attention import paged_design  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv6_scan_mod  # noqa: E402
# the modules, which the package's functions of the same names shadow
decode_attention_mod = sys.modules[  # noqa: E402
    "repro_torch.kernels.decode_attention"]
rglru_scan_mod = sys.modules["repro_torch.kernels.rglru_scan"]  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain, flash_attention,
                                 flash_attention_bwd_plain,
                                 flash_attention_forward,
                                 flash_attention_plain,
                                 paged_attention_plain,
                                 paged_decode_attention, rglru_scan,
                                 rglru_scan_bwd_plain, rglru_scan_plain,
                                 rglru_scan_reverse, rwkv6_wkv,
                                 rwkv6_wkv_chunked, rwkv6_wkv_forward,
                                 rwkv6_wkv_plain)
from repro_torch.models import (init_decode_cache,  # noqa: E402
                                init_params, lm_decode_step, loss_fn,
                                model_spec, tree_paths)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import recurrent as model_recurrent  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402
from repro_torch.train import (AsyncCheckpointer, OptConfig,  # noqa: E402
                               TrainConfig, adamw_init, build_train_step,
                               latest, load, make_train_state)

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12             # dense tensor-core tf32
KERNELS = ["paged_attention", "decode_attention", "flash_attention",
           "rglru_scan", "rwkv6_scan"]
COUNTED = (paged_decode_attention, decode_attention, flash_attention,
           rglru_scan, rglru_scan_reverse, rwkv6_wkv)
PAGED_CASES = [
    # (B, S, H, KV, D, bt, NW, softcap), the reference test's cases
    (2, 1, 4, 2, 64, 8, 8, None),
    (3, 4, 4, 1, 64, 8, 6, None),
    (1, 8, 8, 2, 32, 4, 16, 50.0),
    (2, 3, 2, 2, 128, 16, 4, None),
]
# K1's designs (B, S, H, KV, D, bt, NW, softcap), in f32 and bf16 on
# ragged positions (a row ending at the table's last key, one starting at
# 0, an idle slot and a row that sees no key): a long table (NW*bt = 4096,
# split over many blocks), qwen2's G=7 at D=8 and D=128, D=256 both ways,
# G=1, softcaps both ways, a bf16 chunk whose S*G = 140 is no multiple of
# the 64-row tile, S*G = 16 and 17 on either side of the switch from
# 16-row to 64-row tensor-core tiles, and D=64 over 4096 keys, whose
# plans hold more splits (32, 64) than the merge pass has lanes on D
PAGED_DESIGN_CASES = [
    (8, 1, 28, 4, 128, 16, 256, None),
    (3, 1, 7, 1, 8, 8, 12, None),
    (4, 2, 28, 4, 128, 16, 32, None),
    (2, 1, 16, 2, 256, 16, 20, None),
    (2, 9, 4, 2, 256, 16, 5, None),
    (4, 1, 4, 4, 64, 8, 16, None),
    (2, 1, 28, 4, 128, 16, 40, 30.0),
    (2, 8, 8, 2, 64, 16, 16, 50.0),
    (4, 20, 28, 4, 128, 16, 24, None),
    (3, 16, 4, 4, 64, 16, 8, None),
    (3, 17, 4, 4, 64, 16, 8, None),
    (2, 1, 8, 1, 64, 16, 256, None),
]
DECODE_CASES = [
    # (B, S, H, KV, D, window, softcap), the reference test's cases (valid
    # lengths S - 7i), then rows that see nothing, one slot and all slots
    (2, 128, 4, 2, 64, None, None),
    (1, 200, 8, 1, 64, None, 50.0),
    (3, 256, 4, 4, 64, 64, None),
    (2, 96, 8, 2, 128, None, None),
    (3, 40, 4, 2, 32, None, 50.0),
]
# K2 at the gather path's widths, (B, S, H, KV, D, window, softcap, valid
# lengths), in f32 and bf16 (as in tests/test_torch_cuda.py): the serve
# cell's ragged S=128, S=4096 under a window of its width with valid
# lengths past S, every row seeing nothing, every row at S, and G=8
# filling the 8-head block over a split cache
DECODE_EDGE_CASES = [
    (8, 128, 32, 16, 128, None, 50.0, [80, 128, 1, 96, 33, 64, 127, 5]),
    (8, 4096, 32, 16, 128, 4096, 50.0,
     [4500, 5000, 4097, 8191, 4096, 6000, 4200, 9000]),
    (8, 4096, 32, 16, 128, None, 50.0, [0] * 8),
    (8, 4096, 32, 16, 128, None, 50.0, [4096] * 8),
    (4, 2048, 32, 4, 128, None, 30.0, [2048, 1000, 1, 0]),
]
# f32: kernel and plain version both sum in fp32, in different orders
F32_ATOL = 1e-4
# bf16: both round an fp32 result below 2 in magnitude to bf16 (one ulp
# there is at most 2^-7 = 7.8e-3) after summing in different orders
BF16_ATOL = 2e-2
# full-model logits, plain vs kernel attention in bf16: the one-ulp
# differences of every layer's attention outputs travel through the
# residual stream, so the bar is relative to the logits' own scale
LOGITS_RTOL = 5e-2
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
# K3's f32 reference cases, (B, S, H, KV, D, window, softcap): the
# reference test's, and the smoke configs' heads
FLASH_CASES = [
    (1, 128, 2, 2, 64, None, None),
    (2, 256, 4, 1, 64, None, None),
    (1, 256, 8, 2, 64, None, 50.0),
    (1, 320, 4, 4, 64, 128, None),
    (1, 100, 2, 1, 64, 32, 30.0),
    (2, 40, 7, 1, 8, None, None),
    (2, 37, 4, 2, 16, 8, 50.0),
    (2, 64, 2, 1, 32, 16, None),
]
# K3 at the training path's shapes: recurrentgemma-9b's L layer and
# gemma2-27b's G layer, S=4096 (the repo's train_4k length)
FLASH_SHAPES = {
    "recurrentgemma_L": dict(B=2, S=4096, H=16, KV=1, D=256, window=2048,
                             softcap=None),
    "gemma2_G": dict(B=2, S=4096, H=32, KV=16, D=128, window=None,
                     softcap=50.0),
}
# gradients through K3's Function against the plain backward from the
# plain forward: the two differ only by the forward's out and lse, so in
# f32 by fp32 summation order; in bf16 by one ulp of out, carried through
# dout . out (relative to each gradient's largest magnitude). K4's
# Function against autograd of its plain version: both in fp32 from the
# same inputs, by different formulations; bf16 r, k, v get their
# gradients rounded to bf16, one ulp apart at most
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# K4's f32 reference cases, (B, T, H, N): the reference test's
# (tests/test_kernels.py:111-112), run at chunk 16, the largest the kernel
# takes; then the smoke model's heads (N=4) on a ragged T
RWKV_CASES = [(1, 64, 2, 32), (2, 96, 4, 64), (1, 50, 2, 16),
              (1, 128, 2, 128), (2, 40, 16, 4)]
RWKV_SHAPE = dict(B=2, T=4096, H=16, N=160, C=16)   # rwkv6-3b's train cell
# K4 against its plain version, max error over the output's largest
# magnitude: the reference test's bar (both sum in fp32, the kernel with
# factored decays, the plain version with differences of log decays)
RWKV_RTOL = 1e-4
# the training-path kernels per layer at full width, bf16: K3 within one
# bf16 ulp (2^-7) of the layer output's scale; K5 runs in fp32 and
# rounds as its plain version does; K4 sums in fp32 from the same bf16
# inputs, held to its kernel bar
LAYER_RTOL = {"flash_attention": 2 ** -7, "rglru_scan": 1e-6,
              "rwkv6_wkv": RWKV_RTOL}
TRAIN_LOSS_RTOL = 1e-4


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- kernel


def paged_inputs(B, S, H, KV, D, bt, NW, dtype, dev, seed, inactive=False,
                 edges=False):
    """Seeded pool pages, disjoint shuffled tables, ragged positions; with
    ``inactive`` the last row is an idle slot (all-zero table, lens 0);
    with ``edges`` row 0 ends at the table's last key, row 1 starts at 0
    and, with B >= 4, row 2 sees no key (qpos -1)."""
    rng = np.random.default_rng(seed)
    NB = B * NW + 3
    q = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((NB, bt, KV, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((NB, bt, KV, D), np.float32))
    tables = rng.permutation(NB)[:B * NW].reshape(B, NW).astype(np.int32)
    pos0 = np.array([(7 * b + 5) % (NW * bt - S) for b in range(B)])
    if B > 2:      # ragged: some rows near the table's end, some early
        pos0[::3] = NW * bt - S - np.arange(len(pos0[::3]))
    qpos = (pos0[:, None] + np.arange(S)[None, :]).astype(np.int32)
    if inactive:
        tables[-1] = 0
        qpos[-1] = np.arange(S)
    if edges:
        qpos[0] = NW * bt - S + np.arange(S)
        qpos[1] = np.arange(S)
        if B >= 4:
            qpos[2] = -1
    t = [x.to(dev, dtype) for x in (q, kp, vp)]
    return t + [torch.from_numpy(a).to(dev) for a in (tables, qpos)]


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed alone by
    CUDA events with a cold L2 (a 64 MiB write before it). A 1 ms device
    sleep ahead of each call lets the host enqueue the events and the
    call's launches before the card reaches them, so the time between the
    events is the card's, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)        # ~1 ms at the H100's clock
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time of one call of ``fn`` (its launch overhead), with
    the card kept busy so no call waits on the device."""
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return dt


def bound(q, kp, tables, qpos):
    """Least time for this call: the larger of the bytes it must move
    (q and the output once, the K/V pages its rows can see once, tables
    and positions) over HBM bandwidth and its multiply-adds (QK^T and PV
    over the visible (row, key) pairs) over the peak for the dtype."""
    B, S, H, D = q.shape
    bt, KV = kp.shape[1], kp.shape[2]
    qp = qpos.cpu().numpy()
    tb = tables.cpu().numpy()
    pages = set()
    for b in range(B):
        n = min(-(-(int(qp[b].max()) + 1) // bt), tb.shape[1])
        pages.update(int(r) for r in tb[b, :n])
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * len(pages) * bt * KV * D * isz
              + tables.numel() * 4 + qpos.numel() * 4)
    ops = 4 * D * H * int((qp + 1).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def sdpa_call(q, kp, vp, tables, qpos):
    """The library yardstick: one ``scaled_dot_product_attention`` over
    the pages gathered beforehand (the gather is not timed). Timed only;
    the port never calls it."""
    B, S, H, D = q.shape
    NW, bt, KV = tables.shape[1], kp.shape[1], kp.shape[2]
    kc = kp[tables.long()].reshape(B, NW * bt, KV, D).transpose(1, 2)
    vc = vp[tables.long()].reshape(B, NW * bt, KV, D).transpose(1, 2)
    kc, vc = kc.contiguous(), vc.contiguous()
    qh = q.transpose(1, 2).contiguous()
    mask = (torch.arange(NW * bt, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kc, vc, attn_mask=mask, enable_gqa=True)


def kernel_phase(dev) -> dict:
    """K1 against its plain version: f32 on the reference test's cases,
    every design in f32 and bf16 on ``PAGED_DESIGN_CASES``; then times at
    the paged path's shapes."""
    errs = {}
    for i, case in enumerate(PAGED_CASES):
        *shape, softcap = case
        args = paged_inputs(*shape, torch.float32, dev, seed=i)
        got = paged_decode_attention(*args, softcap=softcap)
        want = paged_attention_plain(*args, softcap=softcap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= F32_ATOL, (case, err)
        errs[f"f32_case{i}"] = err
    designs = {}
    for i, case in enumerate(PAGED_DESIGN_CASES):
        *shape, softcap = case
        B, S, H, KV = shape[:4]
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            args = paged_inputs(*shape, dtype, dev, seed=100 + i,
                                inactive=True, edges=True)
            got = paged_decode_attention(*args, softcap=softcap)
            want = paged_attention_plain(*args, softcap=softcap)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= atol, (case, dtype, err)
            if B >= 4:
                assert not got[2].any(), case
            tag = f"{str(dtype).split('.')[-1]}_design_case{i}"
            errs[tag] = err
            designs[tag] = paged_design(S, H // KV, dtype)
    assert set(designs.values()) == {"simt", "mma16", "mma64"}, designs
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for S in (1, 64):
        args = paged_inputs(8, S, 28, 4, 128, 16, 64, torch.bfloat16, dev,
                            seed=S, inactive=True)
        got = paged_decode_attention(*args)
        want = paged_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_ATOL, (S, err)
        errs[f"bf16_S{S}"] = err
        bound_ms, bound_by = bound(args[0], args[1], args[3], args[4])
        timings[S] = {
            "design": paged_design(S, 7, torch.bfloat16),
            "kernel_ms": time_ms(lambda: paged_decode_attention(*args), 50,
                                 flush),
            "plain_ms": time_ms(lambda: paged_attention_plain(*args), 10,
                                flush),
            "library_ms": time_ms(sdpa_call(*args), 50, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_host_ms": host_ms(lambda: paged_decode_attention(*args),
                                      50),
        }
        emit("kernel", name="paged_attention", dtype="bfloat16",
             shape={"B": 8, "S": S, "H": 28, "KV": 4, "D": 128, "bt": 16,
                    "NW": 64}, max_abs_err=err, atol=BF16_ATOL,
             **timings[S])
    emit("kernel_check", name="paged_attention", max_abs_err=errs,
         designs=designs, f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    return {"max_abs_err": max(errs.values()), **timings[1],
            "S64": timings[64]}


def decode_inputs(B, S, H, KV, D, valid, dtype, dev, seed):
    """Seeded query and cache, and the given valid lengths."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(dev, dtype) for s in
               [(B, H, D), (B, S, KV, D), (B, S, KV, D)])
    return [q, k, v, torch.tensor(valid, dtype=torch.int32, device=dev)]


def decode_bound(q, k, valid):
    """Least time for a flash-decoding call: the larger of the bytes it
    must move (q and the output once, the K and V rows of each row's
    visible keys once, the valid lengths) over HBM bandwidth and its
    multiply-adds (QK^T and PV over the visible (head, key) pairs) over
    the peak for the dtype."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    seen = int(np.clip(valid.cpu().numpy(), 0, S).sum())
    isz = q.element_size()
    nbytes = 2 * q.numel() * isz + 2 * seen * KV * D * isz + 4 * B
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * H * seen / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def sdpa_decode_call(q, k, v, valid):
    """The library yardstick for K2: one ``scaled_dot_product_attention``
    with ``enable_gqa`` over the same cache, transposed beforehand (not
    timed), with the valid lengths as a mask (it has no softcap). Timed
    only; the port never calls it."""
    S = k.shape[1]
    qh = q[:, :, None]                                  # (B, H, 1, D)
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device=q.device)[None, :]
            < valid[:, None].long())[:, None, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


def decode_kernel_phase(dev) -> dict:
    """K2 against its plain version: f32 on the reference test's cases
    and on rows that see nothing, one slot or all, f32 and bf16 on
    ``DECODE_EDGE_CASES``, then bf16 at the gather path's shapes
    (gemma2-27b: B=8, H=32, KV=16, D=128, softcap 50) with ragged valid
    lengths at S=128 and the wrapped rolling window at S=4096, timed with
    the wrapper's host time and the split plan."""
    errs = {}
    for i, (B, S, H, KV, D, window, softcap) in enumerate(DECODE_CASES):
        valid = ([0, 1, S] if i == len(DECODE_CASES) - 1
                 else [S - 7 * b for b in range(B)])
        args = decode_inputs(B, S, H, KV, D, valid, torch.float32, dev,
                             seed=i)
        got = decode_attention(*args, window=window, softcap=softcap)
        want = decode_attention_plain(*args, window, softcap)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        assert err <= F32_ATOL, (i, err)
        errs[f"f32_case{i}"] = err
    for i, (B, S, H, KV, D, window, softcap, valid) in enumerate(
            DECODE_EDGE_CASES):
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            args = decode_inputs(B, S, H, KV, D, valid, dtype, dev,
                                 seed=200 + i)
            got = decode_attention(*args, window=window, softcap=softcap)
            want = decode_attention_plain(*args, window, softcap)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= atol, (i, dtype, err)
            assert all(not got[b].any() for b, vl in enumerate(valid)
                       if vl == 0), i
            errs[f"{str(dtype).split('.')[-1]}_edge_case{i}"] = err
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for S, valid in ((128, [80, 128, 1, 96, 33, 64, 127, 5]),
                     (4096, [4096] * 8)):
        args = decode_inputs(8, S, 32, 16, 128, valid, torch.bfloat16, dev,
                             seed=S)
        got = decode_attention(*args, softcap=50.0)
        want = decode_attention_plain(*args, None, 50.0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_ATOL, (S, err)
        errs[f"bf16_S{S}"] = err
        bound_ms, bound_by = decode_bound(args[0], args[1], args[3])
        timings[S] = {
            "kernel_ms": time_ms(lambda: decode_attention(*args,
                                                          softcap=50.0),
                                 50, flush),
            "plain_ms": time_ms(lambda: decode_attention_plain(
                *args, None, 50.0), 10, flush),
            "library_ms": time_ms(sdpa_decode_call(*args), 50, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_host_ms": host_ms(lambda: decode_attention(
                *args, softcap=50.0), 50),
            "split_plan": decode_attention_mod._plan(
                8, S, 32, 16, 128, -1, torch.bfloat16, dev.index or 0),
        }
        emit("kernel", name="decode_attention", dtype="bfloat16",
             shape={"B": 8, "S": S, "H": 32, "KV": 16, "D": 128,
                    "softcap": 50.0}, valid_len=valid, max_abs_err=err,
             atol=BF16_ATOL, **timings[S])
    emit("kernel_check", name="decode_attention", max_abs_err=errs,
         f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    return {"max_abs_err": max(errs.values()), **timings[128],
            "S4096": timings[4096]}


def flash_bound(q, k, window):
    """Least time for K3's forward: the larger of the bytes it must move
    (q, k, v read once, the output and the fp32 lse written once) over
    HBM bandwidth and its operations (2 per multiply-add of QK^T and PV,
    4*D per visible (query, key) pair) over the peak for the dtype."""
    B, S, H, D = q.shape
    i = np.arange(S, dtype=np.int64)
    seen = np.minimum(i + 1, window) if window else i + 1
    pairs = int(seen.sum()) * B * H
    isz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * isz + B * H * S * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * pairs / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), pairs


def flash_inputs(B, S, H, KV, D, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(dev, dtype) for s in
            [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)]]


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max().item()
            / max(want.float().abs().max().item(), 1e-30))


def flash_grads_check(q, k, v, kw) -> dict:
    """Gradients through K3's autograd Function (K3 forward, plain
    backward) against the plain backward fed the plain forward's out and
    lse, for one seeded dout. Returns each gradient's error relative to
    its largest magnitude."""
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=q.device).manual_seed(7), device=q.device).to(q.dtype)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves, **kw), leaves, dout)
    out, lse = flash_attention_plain(q, k, v, **kw)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    return {n: rel_err(g, w) for n, g, w in zip("qkv", got, want)}


def sdpa_flash_call(q, k, v, window):
    """The library yardstick for K3 on a layer without softcap: one
    ``scaled_dot_product_attention`` with ``enable_gqa`` and an explicit
    band mask, inputs transposed beforehand (not timed). Timed only; the
    port never calls it."""
    S = q.shape[1]
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


def flash_kernel_phase(dev) -> dict:
    """K3 against its plain version: f32 on the reference test's cases
    and the smoke heads, then f32 and bf16 at the training shapes,
    forward (out and lse) and backward through the Function, each timed
    (K3, plain, SDPA where one call computes the same function); the
    bf16 times go to the kernels line."""
    errs = {}
    for i, (B, S, H, KV, D, window, softcap) in enumerate(FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(B, S, H, KV, D, dtype, dev, seed=i)
            kw = dict(causal=True, window=window, softcap=softcap)
            got, glse = flash_attention_forward(q, k, v, **kw)
            want, wlse = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            lse_err = (glse - wlse).abs().max().item()
            if dtype == torch.float32:
                assert max(err, lse_err) <= F32_ATOL, (i, err, lse_err)
            else:
                assert err <= BF16_ATOL and lse_err <= 1e-3, (i, err,
                                                              lse_err)
            tag = str(dtype).split(".")[-1]
            errs[f"{tag}_case{i}"] = max(err, lse_err)
            g = flash_grads_check(q, k, v, kw)
            assert max(g.values()) <= GRAD_RTOL[dtype], (i, dtype, g)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for name, shp in FLASH_SHAPES.items():
        kw = dict(causal=True, window=shp["window"],
                  softcap=shp["softcap"])
        dims = [shp[x] for x in ("B", "S", "H", "KV", "D")]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(*dims, dtype, dev, seed=1)
            got, glse = flash_attention_forward(q, k, v, **kw)
            want, wlse = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            atol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
            err = (got.float() - want.float()).abs().max().item()
            lse_err = (glse - wlse).abs().max().item()
            assert err <= atol and lse_err <= 1e-3, (name, dtype, err,
                                                    lse_err)
            grads = flash_grads_check(q, k, v, kw)
            assert max(grads.values()) <= GRAD_RTOL[dtype], (name, grads)
            tag = str(dtype).split(".")[-1]
            errs[f"{tag}_{name}"] = err
            bound_ms, bound_by, pairs = flash_bound(q, k, shp["window"])
            t = {"kernel_ms": time_ms(lambda: flash_attention_forward(
                     q, k, v, **kw), 5, flush),
                 "plain_ms": time_ms(lambda: flash_attention_plain(
                     q, k, v, **kw), 2, flush),
                 "design": flash_design(dtype),
                 "library_ms": (time_ms(sdpa_flash_call(
                     q, k, v, shp["window"]), 5, flush)
                     if shp["softcap"] is None else None),
                 "bound_ms": bound_ms, "bound_by": bound_by}
            emit("kernel", name="flash_attention", dtype=tag, shape=shp,
                 visible_pairs=pairs, max_abs_err=err, lse_max_abs_err=
                 lse_err, atol=atol, grad_rel_err=grads,
                 grad_rtol=GRAD_RTOL[dtype], **t)
            if dtype == torch.bfloat16:
                timings[name] = {**t, "max_abs_err": err}
            del q, k, v, got, want, glse, wlse
    emit("kernel_check", name="flash_attention", max_abs_err=errs,
         f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    main = timings["recurrentgemma_L"]
    return {**main, "max_abs_err": max(errs.values()),
            "gemma2_G": timings["gemma2_G"]}


# (B, T, W) of K5's checks: the reference test's cases, W past a multiple
# of the stripe (100, 4100) on 16- and 32-channel stripes, W % 4 != 0 (66,
# 2110: 4-byte copies), T=1 and T=2, then the timed shapes (T longer than
# the ring): one 4096-token sequence and the training cell
RGLRU_CASES = [(1, 64, 128), (2, 200, 256), (3, 33, 128), (2, 7, 100),
               (1, 33, 4100), (2, 9, 4100), (2, 5, 66), (2, 17, 2110),
               (1, 1, 66), (3, 2, 100), (1, 4096, 4096), (2, 4096, 4096)]


def rglru_plan_sweep(B, W):
    """Every stripe width and a range of ring depths the kernel takes, to
    time beside the plan's choice (forward and reverse ms a pair)."""
    return [rglru_scan_mod.RGLRUPlan(c, rglru_scan_mod._STAGE_FLOATS // c,
                                     st, B * -(-W // c))
            for c in (16, 32) for st in (2, 3, 4, 5, 6, 8)]


def rglru_kernel_phase(dev) -> dict:
    """K5 against its plain version, forward and reverse mode and, on the
    small cases, the gradients through its autograd Function: kernel and
    plain round alike, so every output must be bit-equal (torch.equal).
    Then B=1 and the training shape B=2 at T=4096, W=4096 (fp32), timed
    with the plan, host ms a call, and a ``torch.add`` over the forward's
    bytes (a and b read, y written) as what an elementwise pass gets;
    beside them the kernel under other plans (``rglru_plan_sweep``),
    launched directly and so not counted."""
    errs = {}
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timed = {}
    for B, T, W in RGLRU_CASES:
        a = torch.sigmoid(torch.randn((B, T, W), generator=g, device=dev))
        b = torch.randn((B, T, W), generator=g, device=dev)
        dy = torch.randn((B, T, W), generator=g, device=dev)
        y, h = rglru_scan(a, b)
        wy, wh = rglru_scan_plain(a, b)
        da, db = rglru_scan_reverse(a, y, dy)
        wda, wdb = rglru_scan_bwd_plain(a, wy, dy)
        torch.cuda.synchronize()
        err = max((y - wy).abs().max().item(), (h - wh).abs().max().item())
        rev_err = max((da - wda).abs().max().item(),
                      (db - wdb).abs().max().item())
        assert torch.equal(y, wy) and torch.equal(h, wh), (B, T, W, err)
        assert torch.equal(da, wda) and torch.equal(db, wdb), (B, T, W,
                                                               rev_err)
        if T < 4096:
            leaves = [a.clone().requires_grad_(True),
                      b.clone().requires_grad_(True)]
            grads = torch.autograd.grad(rglru_scan(*leaves)[0], leaves, dy)
            assert torch.equal(grads[0], wda) and torch.equal(grads[1],
                                                              wdb), (B, T, W)
        errs[f"B{B}T{T}W{W}"] = [err, rev_err]
        if T < 4096:
            continue
        fwd_plan = rglru_scan_mod._plan(B, T, W, False, a.device.index)
        rev_plan = rglru_scan_mod._plan(B, T, W, True, a.device.index)
        out = torch.empty_like(a)
        sweep = {}
        for plan in rglru_plan_sweep(B, W):
            sweep[f"{plan.channels}x{plan.stages}"] = [
                time_ms(lambda: rglru_scan_mod._launch(
                    a, b, out, None, None, a.device.index, plan), 10, flush),
                time_ms(lambda: rglru_scan_mod._launch(
                    a, dy, y, da, db, a.device.index, plan), 10, flush)]
        timed[f"B{B}"] = {
            "kernel_ms": time_ms(lambda: rglru_scan(a, b), 20, flush),
            "plain_ms": time_ms(lambda: rglru_scan_plain(a, b), 2, flush),
            "reverse_kernel_ms": time_ms(
                lambda: rglru_scan_reverse(a, y, dy), 20, flush),
            "reverse_plain_ms": time_ms(
                lambda: rglru_scan_bwd_plain(a, y, dy), 2, flush),
            "kernel_host_ms": host_ms(lambda: rglru_scan(a, b), 200),
            "add_same_bytes_ms": time_ms(lambda: torch.add(a, b, out=out),
                                         20, flush),
            "plan": fwd_plan._asdict(),
            "reverse_plan": rev_plan._asdict(),
            "plan_sweep_ms": sweep,
            # bytes bound both ways, each array moved once: a, b read and
            # y written; reverse: a, dy, y read and da, db written
            "bound_ms": 3 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            "reverse_bound_ms": 5 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3}
        del a, b, dy, y, h, wy, wh, da, db, wda, wdb, out
    t = {**timed["B2"], "library_ms": None, "library": "none: no single "
         "PyTorch call computes a linear recurrence", "bound_by": "bytes",
         "B1": timed["B1"]}
    emit("kernel", name="rglru_scan", dtype="float32",
         shape={"B": 2, "T": 4096, "W": 4096}, max_abs_err=errs, **t)
    return {**t, "max_abs_err": max(max(e) for e in errs.values())}


def rwkv_inputs(B, T, H, N, dtype, dev, seed, logw=None):
    """Seeded r, k, v in ``dtype``; fp32 logw = -exp(a unit normal) in the
    model's clip range [-5, -1e-6] (about a fifth of it at -5, as in the
    random rwkv6-3b), or the constant ``logw``; fp32 u."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((B, T, H, N), generator=g, device=dev)
               for _ in range(3))
    lw = torch.clamp(-torch.exp(torch.randn((B, T, H, N), generator=g,
                                            device=dev)), -5.0, -1e-6)
    if logw is not None:
        lw.fill_(logw)
    u = 0.5 * torch.randn((H, N), generator=g, device=dev)
    return [t.to(dtype) for t in (r, k, v)] + [lw, u]


def rwkv_bound(B, T, H, N, C, isz):
    """Least time for K4: the larger of its operations over the card's peak
    for the route they take and its bytes (r, k, v read in their dtype,
    logw and u read and out and the last state written in fp32, once each)
    over HBM bandwidth. Operations, for each row and head: 4N for each
    visible (token t, key j <= t) pair of a chunk (the score's dot product
    and its product with v; the diagonal's score is r . (u k), N more a
    token), on the fp32 SIMT units; 2N^2 a token for the state update and
    2N^2 a token past the first chunk for the carried state's product (the
    state is zero before), on the tensor cores in 3xTF32, three tf32
    products each. Chunks of C tokens, the last one ragged, as the kernel
    walks them. Returns (bound ms, what bounds it, operations, bytes, the
    operations' time with all of them on the fp32 SIMT units)."""
    nc = -(-T // C)
    tail = T - (nc - 1) * C
    pairs = (nc - 1) * C * (C + 1) // 2 + tail * (tail + 1) // 2
    simt_ops = B * H * (4 * N * pairs + N * T)
    state_ops = B * H * (2 * N * N * T + 2 * N * N * (T - min(C, T)))
    nbytes = B * T * H * N * (3 * isz + 4 + 4) + H * N * 4 + B * H * N * N * 4
    t_ops = (simt_ops / PEAK_OPS_PER_S[torch.float32]
             + 3 * state_ops / TF32_OPS_PER_S) * 1e3
    t_simt = (simt_ops + state_ops) / PEAK_OPS_PER_S[torch.float32] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else
            "operations", simt_ops + state_ops, nbytes, t_simt)


def carry_loop(D, M):
    """``_carry``'s result by a plain loop over the chunks, S_c = D_c S_{c-1}
    + M_c: the yardstick for its two-level scan."""
    S = M.new_zeros(M[:, 0].shape)
    prev = []
    for d, m in zip(D.unbind(1), M.unbind(1)):
        prev.append(S)
        S = d[..., None] * S + m
    return torch.stack(prev, dim=1), S


def rwkv_grads_check(xs, chunk) -> dict:
    """Gradients for r, k, v, logw and u through K4's Function (kernel
    forward, chunk-parallel form recomputed for the backward) against
    autograd of the plain version (the loop over chunks with decays from
    differences of log decays, an independent formulation) on the same
    inputs, for one seeded dout; each relative to the gradient's largest
    magnitude."""
    dout = torch.randn(xs[0].shape, generator=torch.Generator(
        device=xs[0].device).manual_seed(7), device=xs[0].device)
    grads = []
    for fn in (rwkv6_wkv, rwkv6_wkv_plain):
        leaves = [t.detach().requires_grad_(True) for t in xs]
        grads.append(torch.autograd.grad(fn(*leaves, chunk=chunk)[0],
                                         leaves, dout))
    return {n: rel_err(g, w) for n, g, w in zip(
        ("r", "k", "v", "logw", "u"), *grads)}


def carry_timings(xs, C, flush) -> dict:
    """``_carry`` (two loops of about sqrt(chunks) steps) against
    ``carry_loop`` (one step a chunk) at the cell's shape: their results,
    and each one's forward plus backward alone, then the Function's whole
    backward with each, by CUDA events (device time, host gaps included)
    and on the host's clock (launch overhead with the card kept busy)."""
    B, T, H, N = xs[0].shape
    lw = xs[3].reshape(B, T // C, C, H, N)
    D = torch.exp(lw.sum(2))
    M = 0.1 * torch.randn((B, T // C, H, N, N), device=D.device,
                          generator=torch.Generator(
                              device=D.device).manual_seed(3))
    gp, gl = torch.ones_like(M), torch.ones_like(M[:, 0])
    got, want = rwkv6_scan_mod._carry(D, M), carry_loop(D, M)
    err = max(rel_err(got[0], want[0]), rel_err(got[1], want[1]))
    assert err <= RWKV_RTOL, err
    del got, want
    leaves = [t.detach().requires_grad_(True) for t in xs]
    out = rwkv6_wkv(*leaves, chunk=C)[0]
    dout = torch.ones_like(out)
    t = {"carry_rel_err": err}
    for name, carry in (("two_level", rwkv6_scan_mod._carry),
                        ("loop", carry_loop)):
        def fwd_bwd():
            d, m = D.detach().requires_grad_(), M.detach().requires_grad_()
            return torch.autograd.grad(carry(d, m), (d, m), (gp, gl))

        def backward():
            return torch.autograd.grad(out, leaves, dout, retain_graph=True)

        with mock.patch.object(rwkv6_scan_mod, "_carry", carry):
            t[f"carry_{name}_ms"] = time_ms(fwd_bwd, 3, flush)
            t[f"carry_{name}_host_ms"] = host_ms(fwd_bwd, 2)
            t[f"backward_{name}_ms"] = time_ms(backward, 3, flush)
            t[f"backward_{name}_host_ms"] = host_ms(backward, 2)
    return t


def rwkv_kernel_phase(dev) -> dict:
    """K4 against its plain version: f32 on the reference test's cases
    and the smoke heads at chunk 16, f32 at logw = -5 throughout (finite,
    and the plain version's result), then at the training cell's shape
    with bf16 r, k, v: output and last state, timed (K4, plain, the
    chunk-parallel form, the state carry two ways). The gradients through
    the Function are held to autograd of the plain version on every f32
    case, at 64 chunks with the cell's heads, and at the cell."""
    errs, rel, grads = {}, {}, {}

    def check(tag, xs, chunk):
        out, s_last = rwkv6_wkv_forward(*xs, chunk=chunk)
        want, want_s = rwkv6_wkv_plain(*xs, chunk=chunk)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(s_last).all()
        rel[tag] = max(rel_err(out, want), rel_err(s_last, want_s))
        errs[tag] = max((out - want).abs().max().item(),
                        (s_last - want_s).abs().max().item())
        assert rel[tag] <= RWKV_RTOL, (tag, rel[tag])

    def check_grads(tag, xs, chunk, dtype):
        grads[tag] = rwkv_grads_check(xs, chunk)
        assert max(grads[tag].values()) <= GRAD_RTOL[dtype], (tag, grads)

    for i, shape in enumerate(RWKV_CASES):
        xs = rwkv_inputs(*shape, torch.float32, dev, seed=i)
        check(f"f32_case{i}", xs, 16)
        check_grads(f"f32_case{i}", xs, 16, torch.float32)
    check_grads("f32_64_chunks", rwkv_inputs(1, 1024, 4, 160, torch.float32,
                                             dev, seed=8), 16, torch.float32)
    check("f32_logw_-5", rwkv_inputs(2, 256, 4, 64, torch.float32, dev,
                                     seed=9, logw=-5.0), 16)
    B, T, H, N, C = (RWKV_SHAPE[x] for x in "BTHNC")
    xs = rwkv_inputs(B, T, H, N, torch.bfloat16, dev, seed=1)
    check("bf16_cell", xs, C)
    check_grads("bf16_cell", xs, C, torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bound_ms, bound_by, ops, nbytes, simt_ms = rwkv_bound(B, T, H, N, C, 2)
    t = {"kernel_ms": time_ms(lambda: rwkv6_wkv_forward(*xs, chunk=C), 20,
                              flush),
         "plain_ms": time_ms(lambda: rwkv6_wkv_plain(*xs, chunk=C), 2,
                             flush),
         "chunked_ms": time_ms(lambda: rwkv6_wkv_chunked(*xs, chunk=C), 5,
                               flush),
         # the Function's backward (the chunk-parallel form recomputed
         # under autograd, then its gradients; plain PyTorch, no kernel),
         # with the state carry of rwkv6_scan.py and with a plain loop
         **carry_timings(xs, C, flush),
         "library_ms": None, "library": "none: no single PyTorch call "
         "computes the WKV recurrence",
         "bound_ms": bound_ms, "bound_by": bound_by, "bound_flop": ops,
         "bound_bytes": nbytes, "bound_all_simt_ms": simt_ms}
    emit("kernel", name="rwkv6_wkv", dtype="bfloat16 r, k, v; float32 "
         "logw, u, out, state", shape=RWKV_SHAPE, max_abs_err=errs,
         max_rel_err=rel, rtol=RWKV_RTOL, grad_rel_err=grads,
         grad_rtol={"f32": GRAD_RTOL[torch.float32],
                    "bf16": GRAD_RTOL[torch.bfloat16]}, **t)
    return {**t, "max_abs_err": max(errs.values()),
            "max_rel_err": max(rel.values())}


# --------------------------------------------------------------- serve


def shared_prefix_prompts(vocab, n, families, prefix, unique, seed):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, prefix)) for _ in range(families)]
    return [prefixes[i % families] + list(rng.integers(0, vocab, unique))
            for i in range(n)]


def run_engine(cfg, params, dev, prompts, *, cap_blocks, bt, slots, max_seq,
               chunk, max_new, paged, cuda_graphs=None):
    probe = ServeEngine(cfg, params, max_slots=1, max_seq=bt,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=bt),
                        pool_blocks=1, prefill_chunk=chunk, paged=paged,
                        device=dev, cuda_graphs=False)
    store = PrefixStore(cap_blocks * probe._block_nbytes(), "lerc",
                        block_tokens=bt)
    del probe
    eng = ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                      store=store, prefill_chunk=chunk, paged=paged,
                      device=dev, cuda_graphs=cuda_graphs)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    return eng, store, reqs


# the device kernel that each serve wrapper launches once a call, by the
# names a graph's nodes and a trace record (K1's split merge, a second
# kernel of some calls, is left out)
KERNEL_NAMES = {"paged_decode_attention": ("paged_mma_kernel",
                                           "paged_simt_kernel"),
                "decode_attention": ("decode_attention_kernel",)}


def named(kernel, by_name) -> int:
    """The entries of ``by_name`` ({kernel name: n}) that are ``kernel``'s
    device kernel, summed."""
    return sum(n for name, n in by_name.items()
               if any(k in name for k in KERNEL_NAMES[kernel]))


def traced_kernel(prof, kernel) -> tuple:
    """(runs, device ms) of ``kernel``'s device kernel in a finished
    torch.profiler run, CUDA activity (a graph's kernels are recorded as
    kernels)."""
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (named(kernel, {e.key: e.count for e in events}),
            named(kernel, {e.key: e.self_device_time_total / 1e3
                           for e in events}))


def timed_serve(cfg, params, dev, prompts, kernel, cuda_graphs, **kw):
    """One serve run with every launch counted: captured (the card's
    default, ``cuda_graphs=None``) or eager (False). A wrapper counts its
    launches on the host: the eager steps', and the one it records into a
    graph at each capture; a replay launches its graph's kernel nodes,
    which the program reads from each graph at its capture. Returns
    ((engine, store, requests), the run's summary). Fails unless each
    capture recorded ``n_layers`` launches of ``kernel``, the card ran it
    ``n_layers`` times a step, eager or replayed, and, captured, most
    steps replayed."""
    t0 = time.time()
    (eng, store, reqs), counts = counted(lambda: run_engine(
        cfg, params, dev, prompts, cuda_graphs=cuda_graphs, **kw))
    wall = time.time() - t0
    prog = eng.step_program
    assert prog.capture == (cuda_graphs is None)
    recorded = named(kernel, prog.captured_kernels)
    replayed = named(kernel, prog.replayed_kernels)
    eager = counts[kernel] - recorded
    assert recorded == cfg.n_layers * prog.captures, (recorded, prog.captures)
    assert eager == cfg.n_layers * (eng.steps - prog.replays), \
        (counts, eng.steps, prog.replays)
    assert eager + replayed == cfg.n_layers * eng.steps, \
        (eager, replayed, eng.steps)
    if prog.capture:
        assert prog.captures > 0 and prog.replays > eng.steps // 2, \
            (prog.captures, prog.replays, eng.steps)
    tokens = sum(len(r.generated) for r in reqs)
    return (eng, store, reqs), {
        "cuda_graphs": prog.capture, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "host_ms_per_step": wall * 1e3 / eng.steps, "engine_steps": eng.steps,
        "steps_replayed": prog.replays, "captures": prog.captures,
        "kernel_launches": counts, "graph_nodes": recorded,
        "replayed_launches": replayed, "device_launches": eager + replayed}


def assert_same_run(a, b) -> None:
    """Two runs of one workload: identical tokens, eviction logs and
    metrics."""
    (ea, sa, ra), (eb, sb, rb) = a, b
    assert [r.generated for r in ra] == [r.generated for r in rb]
    assert sa.eviction_log == sb.eviction_log
    assert ea.metrics() == eb.metrics()


def steady_decode(cfg, params, dev, *, paged, chunk, prompt, max_seq,
                  steps=32) -> None:
    """8 slots all decoding, captured beside eager: ms a step by host
    clock over ``steps`` steps once the decode signature has been captured
    (the captured engine's first sight and capture of it come before),
    then device busy and idle share of ``steps`` more under
    torch.profiler, CUDA activity (a graph's kernels are recorded as
    kernels), with the attention kernel's launches in those steps
    (``n_layers`` a step: the wrapper's eagerly, the graph's nodes
    captured), and its runs and device ms in the trace. Both engines must
    have generated the same tokens."""
    prompts = shared_prefix_prompts(cfg.vocab, 8, 8, prompt, 0, seed=3)
    kernel = "paged_decode_attention" if paged else "decode_attention"
    out, tokens = {}, []
    for cuda_graphs in (None, False):
        eng = ServeEngine(cfg, params, max_slots=8, max_seq=max_seq,
                          prefill_chunk=chunk, paged=paged, device=dev,
                          cuda_graphs=cuda_graphs)
        reqs = [eng.submit(p, max_new=2 * steps + 8) for p in prompts]
        while not all(r.n_generated for r in reqs):
            eng.step()
        for _ in range(2):          # the decode signature: seen, captured
            eng.step()
        prog = eng.step_program
        replays = prog.replays
        wrapper = paged_decode_attention if paged else decode_attention
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        calls, nodes = wrapper.launches, named(kernel, prog.replayed_kernels)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        calls = wrapper.launches - calls
        nodes = named(kernel, prog.replayed_kernels) - nodes
        # the profiled steps' launches: the wrapper's eagerly, the
        # graph's nodes captured, where no wrapper is called
        assert calls + nodes == cfg.n_layers * steps, (kernel, calls, nodes)
        assert (calls if prog.capture else nodes) == 0, (calls, nodes)
        by_name = device_ms_by_kernel(prof)
        busy = sum(by_name.values())
        # the trace's own count, below the launches where it lost
        # records: 0 < runs <= launches
        runs, kernel_ms = traced_kernel(prof, kernel)
        assert 0 < runs <= cfg.n_layers * steps, (kernel, runs)
        assert all(r.n_generated < r.max_new for r in reqs)
        tokens.append([eng.drain(r) for r in reqs])
        out["captured" if prog.capture else "eager"] = {
            "ms_per_step": ms, "steps_replayed": prog.replays - replays,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_ms_per_step": busy / steps,
            "device_idle_share": (1 - busy / wall_ms if busy else
                                  "not measured: the profiler recorded no "
                                  "device activity"),
            f"{kernel}_launches": calls + nodes,
            f"{kernel}_runs_in_trace": runs, f"{kernel}_ms": kernel_ms,
            "gemm_ms": sum(t for n, t in by_name.items()
                           if any(g in n.lower() for g in GEMM_NAMES)),
            "top_kernels": [[n[:80], t] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:5]]}
        del eng, reqs
    assert out["captured"]["steps_replayed"] == 2 * steps
    assert tokens[0] == tokens[1]
    emit("steady_decode", config=cfg.arch, paged=paged, slots=8,
         prompt_tokens=prompt, steps=steps, **out)


def counted(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before and
    read just after. Returns (fn's result, {kernel: launches})."""
    for k in COUNTED:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in COUNTED}


def parity_phase(dev) -> None:
    """Smoke configs in f32: the engine on the card (kernels) gives the CPU
    engine's (plain versions') tokens, eviction log and metrics — the
    paged plane on qwen2, the gather plane on gemma2 (rolling-window
    layers, chunk 1) and on qwen2 (chunk 8)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, paged, chunk, kernel in (
            ("qwen2_7b", True, 8, paged_decode_attention),
            ("gemma2_27b", False, 1, decode_attention),
            ("qwen2_7b", False, 8, decode_attention)):
        cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
        params = init_params(model_spec(cfg),
                             torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
        prompts = shared_prefix_prompts(cfg.vocab, 9, 3, 24, 8, seed=7)
        kw = dict(cap_blocks=10, bt=8, slots=2, max_seq=64, chunk=chunk,
                  max_new=4, paged=paged)
        ce, cs, cr = run_engine(cfg, params, "cpu", prompts, **kw)
        (ge, gs, gr), launches = counted(
            lambda: run_engine(cfg, params, dev, prompts, **kw))
        assert launches[kernel.__name__] > 0, launches
        assert cs.evictions > 0
        assert [r.generated for r in gr] == [r.generated for r in cr]
        assert gs.eviction_log == cs.eviction_log
        assert ge.metrics() == ce.metrics()
        emit("parity", config=f"{arch} smoke f32", paged=paged,
             prefill_chunk=chunk, requests=len(prompts),
             tokens_identical=True, evictions=cs.evictions,
             effective_hits=cs.metrics()["effective_hits"],
             prefill_tokens_skipped=ce.prefill_tokens_skipped,
             kernel_launches=launches)


def serve_phase(dev) -> tuple:
    """The paged path at full width. Returns K1's launches in its run:
    the wrapper's count and the trace's."""
    cfg = configs.get("qwen2_7b")                  # full width, bf16
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_spec(cfg), gen, dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    kw = dict(bt=16, slots=8, max_seq=640, chunk=64, max_new=32, paged=True)
    # warm-up (cuBLAS handles, allocator), not counted
    run_engine(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 2, 1, 64, 16, seed=1), cap_blocks=96,
        **{**kw, "max_new": 2})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = shared_prefix_prompts(cfg.vocab, 16, 4, 512, 64, seed=0)

    # the main path: every step signature captured at its second sighting
    # and replayed after, K1 inside the graphs
    (eng, store, reqs), run = timed_serve(
        cfg, params, dev, prompts, "paged_decode_attention", None,
        cap_blocks=96, **kw)
    counts = run["kernel_launches"]
    launches = counts["paged_decode_attention"]
    wall = run["wall_s"]
    peak = torch.cuda.max_memory_allocated(dev)
    # the yardstick: the same engine run eagerly, the same results
    eager, eager_run = timed_serve(
        cfg, params, dev, prompts, "paged_decode_attention", False,
        cap_blocks=96, **kw)
    assert_same_run((eng, store, reqs), eager)
    del eager

    m = eng.metrics()
    resident = sum(1 for n in store._nodes.values() if n.resident)
    tokens = [t for r in reqs for t in r.generated]
    assert m["evictions"] > 0 and m["effective_hits"] > 0, m
    assert eng.pool.blocks_in_use == resident + 1
    assert len(tokens) == 16 * kw["max_new"]
    assert all(0 <= t < cfg.vocab for t in tokens)
    emit("serve", config="qwen2_7b full width, 28 layers, bf16, random "
         "weights (seed 0), paged plane", requests=len(prompts),
         engine_steps=eng.steps, kernel_launches=counts,
         generated_tokens=len(tokens),
         tokens_per_s=len(tokens) / wall, wall_s=wall, init_s=init_s,
         evictions=m["evictions"], effective_hits=m["effective_hits"],
         hits=m["hits"], accesses=m["accesses"],
         prefill_tokens=m["prefill_tokens"],
         prefill_tokens_skipped=m["prefill_tokens_skipped"],
         pool_blocks=m["pool_blocks"],
         pool_blocks_in_use=m["pool_blocks_in_use"],
         max_memory_allocated=peak, captured=run, eager=eager_run,
         eager_identical=True)

    paged_decode_step(cfg, eng, dev)
    del eng, store, reqs
    steady_decode(cfg, params, dev, paged=True, chunk=64, prompt=64,
                  max_seq=kw["max_seq"])
    profile_serve(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 8, 4, 512, 64, seed=2), {**kw, "max_new": 8},
        "8 requests x (512 shared + 64 unique) prompt tokens, 8 new "
        "tokens, 8 slots, chunk 64", "paged_attention", match="paged_")
    return launches, run["device_launches"]


def reordered_plain(q, kp, vp, tables, qpos, softcap=None):
    """``paged_attention_plain`` with its fp32 sums taken in another order:
    the head dim of q.k and the keys of the softmax sum and of P.V
    reversed. The same function, rounded otherwise: the control for a
    kernel that sums its exact products in its own order."""
    B, S, H, D = q.shape
    bt, KV = kp.shape[1], kp.shape[2]
    L, G = tables.shape[1] * bt, H // KV
    rows = tables.long()
    rev = torch.arange(L - 1, -1, -1, device=q.device)
    kc = kp[rows].reshape(B, L, KV, D)[:, rev].flip(-1).float()
    vc = vp[rows].reshape(B, L, KV, D)[:, rev].float()
    qg = q.reshape(B, S, KV, G, D).flip(-1).float() * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = (rev[None, None, :] <= qpos[:, :, None])[:, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(m <= -5e29, 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, vc) / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def paged_decode_step(cfg, eng, dev) -> None:
    """One qwen2-7b decode step of S=64 (K1's tensor-core tiles) over the
    pool the serve run left, plain version vs K1, bf16: 7 live rows at
    ragged positions and lengths, and an idle slot.

    A random 28-layer qwen2 is chaotic, as gemma2 is (``gather_decode_step``):
    a few one-ulp differences in a layer's attention outputs grow through
    the residual stream as the depth grows. So the step is checked as
    gemma2's is: (1) every layer's K1 output against its plain version on
    the same inputs (the kernel's output carried on), within one bf16 ulp
    of the layer's scale; (2) the step cut to its first 4 layers, kernel
    vs plain logits within ``LOGITS_RTOL`` of their scale; (3) at 2, 4, 8,
    14 and all 28 layers, the distance of K1's logits from the plain
    version's beside two controls': the plain version with its fp32 sums
    in another order (``reordered_plain``, which rounds about as many
    outputs a layer to the neighbouring bf16 value as K1 does) and one
    nudged ulp in the first layer; the full step's logits finite."""
    rng = np.random.default_rng(1)
    B, S, NW = 8, 64, eng.table_width
    rows = 1 + rng.permutation(eng.pool.num_blocks - 1)[:B * NW]
    tables = torch.from_numpy(rows.reshape(B, NW).astype(np.int32)).to(dev)
    tables[-1] = 0                                   # an idle slot
    pos = torch.tensor([0, 64, 128, 200, 300, 400, 570, 0], dtype=torch.int32,
                       device=dev)
    lens = torch.tensor([64, 64, 17, 64, 1, 40, 64, 0], dtype=torch.int32,
                        device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(dev)

    def step(n, attend):
        """Live rows' logits of the step cut to its first ``n`` layers,
        over fresh copies of the pool; ``attend`` stands in for K1's
        wrapper inside the layers."""
        pool = {"stack": tree_map(torch.clone,
                                  _slice(eng.pool.buffers["stack"], n))}
        params = {**eng.params, "stack": _slice(eng.params["stack"], n)}
        wrapper = model_layers.paged_decode_attention
        model_layers.paged_decode_attention = attend
        try:
            out, _ = lm_decode_step(
                cfg.replace(decode_kernel="flash", n_layers=n), params, pool,
                toks, pos, seq_lens=lens, paged_tables=tables)
        finally:
            model_layers.paged_decode_attention = wrapper
        torch.cuda.synchronize()
        return out[:-1, 0].float()

    def against_plain(fn, errs):
        """``fn`` in the layers, each call's distance from the plain
        version on the same inputs kept in ``errs``."""
        def attend(q, kp, vp, tb, qp, softcap=None):
            got = fn(q, kp, vp, tb, qp, softcap=softcap)
            want = paged_attention_plain(q, kp, vp, tb, qp, softcap)
            diff = got.float() - want.float()
            errs.append((diff.abs().max().item(),
                         want.float().abs().max().item(),
                         int((diff != 0).sum().item())))
            return got
        return attend

    def nudged():
        """The plain version, its first call's first output one ulp up."""
        calls = []

        def attend(q, kp, vp, tb, qp, softcap=None):
            out = paged_attention_plain(q, kp, vp, tb, qp, softcap)
            if not calls:
                out[0, 0, 0, 0] = (out[0, 0, 0, 0].float()
                                   * (1 + 2 ** -7)).to(out.dtype)
            calls.append(1)
            return out
        return attend

    layer_errs = {"kernel": [], "reordered": []}
    full = cfg.n_layers
    logits = {"plain": step(full, paged_attention_plain),
              "kernel": step(full, against_plain(paged_decode_attention,
                                                 layer_errs["kernel"])),
              "reordered": step(full, against_plain(reordered_plain,
                                                    layer_errs["reordered"]))}
    worst = {}
    for route, errs in layer_errs.items():
        assert len(errs) == full, (route, errs)
        worst[route] = max(e / s for e, s, _ in errs)
        assert worst[route] <= 2 ** -7, (route, errs)     # one bf16 ulp
    assert all(torch.isfinite(x).all() for x in logits.values())

    compare_logits(f"qwen2-7b lm_decode_step, first 4 of {full} layers, "
                   "plain version vs K1, bf16, S=64, 7 live rows + 1 idle",
                   {"xla": step(4, paged_attention_plain),
                    "flash": step(4, paged_decode_attention)})

    by_depth = {}
    for n in (2, 4, 8, 14, full):
        if n == full:
            got = dict(logits, one_ulp=step(n, nudged()))
        else:
            got = {"plain": step(n, paged_attention_plain),
                   "kernel": step(n, paged_decode_attention),
                   "reordered": step(n, reordered_plain),
                   "one_ulp": step(n, nudged())}
        plain = got.pop("plain")
        scale = plain.abs().max().item()
        by_depth[n] = {r: (x - plain).abs().max().item() / scale
                       for r, x in got.items()}
    plain, kern = logits["plain"], logits["kernel"]
    emit("decode_step", what=f"qwen2-7b lm_decode_step, {full} layers, "
         "plain version vs K1 and vs the plain version summed in another "
         "order, bf16, S=64, 7 live rows + 1 idle",
         max_abs_err=(kern - plain).abs().max().item(),
         logits_scale=plain.abs().max().item(),
         argmax_agreement=(kern.argmax(-1) == plain.argmax(-1))
         .float().mean().item(),
         reordered_argmax_agreement=(logits["reordered"].argmax(-1)
                                     == plain.argmax(-1)).float().mean()
         .item(),
         logits_err_over_scale_by_depth=by_depth, rtol=LOGITS_RTOL,
         per_layer_max_err_over_scale=worst,
         per_layer_errs_scales_ndiff=layer_errs,
         elements_per_layer=B * S * cfg.n_heads * cfg.d_head)


def compare_logits(what, logits) -> None:
    """Plain ("xla") vs kernel ("flash") logits: finite, within
    ``LOGITS_RTOL`` of the logits' scale; prints argmax agreement."""
    torch.cuda.synchronize()
    ref, got = logits["xla"], logits["flash"]
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert err <= LOGITS_RTOL * scale, (err, scale)
    emit("decode_step", what=what, max_abs_err=err, logits_scale=scale,
         rtol=LOGITS_RTOL, argmax_agreement=agree)


def gather_serve_phase(dev) -> tuple:
    """The gather path at full width and depth: gemma2-27b, 46 layers, every
    attention a K2 launch. Returns K2's launches in its run: the wrapper's
    count and the trace's."""
    cfg = configs.get("gemma2_27b")                # full width, bf16
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_spec(cfg), gen, dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_paths(params))
    init_peak = torch.cuda.max_memory_allocated(dev)
    kw = dict(bt=16, slots=8, max_seq=128, chunk=1, max_new=16, paged=False)
    # warm-up (cuBLAS handles, allocator), not counted
    run_engine(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 2, 1, 16, 4, seed=1), cap_blocks=24,
        **{**kw, "max_new": 2})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = shared_prefix_prompts(cfg.vocab, 16, 4, 64, 16, seed=0)

    # the main path, captured (K2 inside the graph), then the yardstick:
    # the same engine run eagerly, the same results
    (eng, store, reqs), run = timed_serve(
        cfg, params, dev, prompts, "decode_attention", None, cap_blocks=24,
        **kw)
    counts = run["kernel_launches"]
    launches = counts["decode_attention"]
    wall = run["wall_s"]
    peak = torch.cuda.max_memory_allocated(dev)
    eager, eager_run = timed_serve(
        cfg, params, dev, prompts, "decode_attention", False, cap_blocks=24,
        **kw)
    assert_same_run((eng, store, reqs), eager)
    del eager

    m = eng.metrics()
    tokens = [t for r in reqs for t in r.generated]
    assert counts["paged_decode_attention"] == 0, counts
    assert m["evictions"] > 0 and m["hits"] > 0, m
    assert len(tokens) == 16 * kw["max_new"]
    assert all(0 <= t < cfg.vocab for t in tokens)
    emit("serve", config="gemma2_27b full width and depth, 46 layers (LG), "
         "bf16, random weights (seed 0), gather plane",
         requests=len(prompts), engine_steps=eng.steps,
         kernel_launches=counts, generated_tokens=len(tokens),
         tokens_per_s=len(tokens) / wall, wall_s=wall, init_s=init_s,
         param_bytes=param_bytes, init_peak_memory=init_peak,
         block_nbytes=eng.pool.block_nbytes, store_capacity=store.capacity,
         evictions=m["evictions"], hits=m["hits"],
         effective_hits=m["effective_hits"], accesses=m["accesses"],
         prefill_tokens=m["prefill_tokens"],
         prefill_tokens_skipped=m["prefill_tokens_skipped"],
         kv_transfer_dispatches=m["kv_transfer_dispatches"],
         device_kv_bytes=m["device_kv_bytes"],
         max_memory_allocated=peak, captured=run, eager=eager_run,
         eager_identical=True)
    del eng, store, reqs

    gather_decode_step(cfg, params, dev)
    steady_decode(cfg, params, dev, paged=False, chunk=1, prompt=16,
                  max_seq=kw["max_seq"])
    profile_serve(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 8, 4, 64, 16, seed=2), {**kw, "max_new": 4},
        "8 requests x (64 shared + 16 unique) prompt tokens, 4 new tokens, "
        "8 slots, chunk 1", "decode_attention", cap_blocks=24)
    return launches, run["device_launches"]


def gather_decode_step(cfg, params, dev) -> None:
    """One gemma2-27b decode step with the rolling window wrapped, plain
    version vs K2, bf16, on seeded caches: row 0 at 4500 (L layers write
    slot 404 and see all 4096; the G layers are 4224 wide, so their write
    is dropped and all 4224 are seen), row 1 at 300.

    A random 46-layer gemma2 is chaotic: one bf16 ulp of one attention
    output in its first layer moves the logits by a sizeable share of
    their scale. So the step is checked three ways: (1) every layer's K2
    output against its plain version on the same inputs, the plain
    output carried on, within one bf16 ulp of the layer's scale; (2) the
    step cut to its first 8 layers (4 L and 4 G, the wrap included),
    kernel vs plain logits within ``LOGITS_RTOL`` of their scale; (3) the
    full step, kernel vs plain: finite logits, with their distance, the
    argmax agreement and, beside them, the distance one nudged ulp in the
    first layer makes."""
    B, max_seq = 2, 4224
    cache = init_decode_cache(cfg, B, max_seq, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for _, t in tree_paths(cache):
        t.normal_(generator=g)
    pos = torch.tensor([4500, 300], dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev,
                         dtype=torch.int32)
    lens = torch.ones(B, dtype=torch.int32, device=dev)

    def step(impl, n_rep=None, attend=None):
        """Logits of one decode step over fresh copies of the caches, with
        the first ``n_rep`` LG units (all by default); ``attend`` stands
        in for the kernel's wrapper inside the layers."""
        n_rep = n_rep or cfg.n_layers // 2
        c = tree_map(torch.clone, _slice(cache["stack"], n_rep))
        p = {**params, "stack": _slice(params["stack"], n_rep)}
        wrapper = model_layers.decode_attention
        if attend is not None:
            model_layers.decode_attention = attend
        try:
            out, _ = lm_decode_step(
                cfg.replace(decode_kernel=impl, n_layers=2 * n_rep), p,
                {"stack": c}, toks, pos, seq_lens=lens)
        finally:
            model_layers.decode_attention = wrapper
        torch.cuda.synchronize()
        return out[:, 0].float()

    layer_errs = []

    def kernel_and_plain(q, k, v, valid, softcap=None):
        want = decode_attention_plain(q, k, v, valid, None, softcap)
        got = decode_attention(q, k, v, valid, softcap=softcap)
        scale = want.float().abs().max().item()
        layer_errs.append(((got.float() - want.float()).abs().max().item(),
                           scale))
        return want

    step("flash", attend=kernel_and_plain)
    assert len(layer_errs) == cfg.n_layers
    worst = max(e / s for e, s in layer_errs)
    assert worst <= 2 ** -7, layer_errs            # one bf16 ulp

    compare_logits("gemma2-27b lm_decode_step, first 8 layers, plain "
                   "version vs K2, bf16, B=2, rows at pos 4500 (window "
                   "wrapped) and 300", {"xla": step("xla", 4),
                                        "flash": step("flash", 4)})

    nudged = []

    def nudge_first(q, k, v, valid, softcap=None):
        out = decode_attention_plain(q, k, v, valid, None, softcap)
        if not nudged:
            out[0, 0, 0] = (out[0, 0, 0].float() * (1 + 2 ** -7)).to(
                out.dtype)
        nudged.append(1)
        return out

    plain = step("xla")
    kern = step("flash")
    ulp = step("flash", attend=nudge_first)
    del cache
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    scale = plain.abs().max().item()
    emit("decode_step", what=f"gemma2-27b lm_decode_step, {cfg.n_layers} "
         "layers, plain version vs K2, bf16, B=2, rows at pos 4500 (window "
         "wrapped) and 300", max_abs_err=(kern - plain).abs().max().item(),
         logits_scale=scale,
         argmax_agreement=(kern.argmax(-1) == plain.argmax(-1))
         .float().mean().item(),
         one_ulp_in_layer0_max_abs_err=(ulp - plain).abs().max().item(),
         per_layer_max_err_over_scale=worst,
         per_layer_errs=[[e, s] for e, s in layer_errs])


def _slice(tree, n):
    """The first ``n`` entries of every leaf's leading (layer) axis."""
    return {k: _slice(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def device_ms_by_kernel(prof) -> dict:
    """{kernel name: device ms} of a finished torch.profiler run."""
    by_name = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    return by_name


def profile_serve(cfg, params, dev, prompts, kw, run, kernel,
                  cap_blocks=96, match=None) -> None:
    """Where a serve step's time goes: a short run of a path's shape under
    torch.profiler, CUDA activity only. Device busy share = summed kernel
    time / wall time. ``kernel``'s device time sums the kernels whose
    names hold ``match`` (``kernel`` itself by default)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng, _, _ = run_engine(cfg, params, dev, prompts,
                               cap_blocks=cap_blocks, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        emit("profile", config=cfg.arch, device_time="not measured: the "
             "profiler recorded no device activity", wall_ms=wall_ms,
             engine_steps=eng.steps)
        return

    def total(pred):
        return sum(t for n, t in by_name.items() if pred(n.lower()))
    kernel_ms = total(lambda n: (match or kernel) in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", config=cfg.arch, run=run, engine_steps=eng.steps,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms,
         **{f"{kernel}_ms": kernel_ms,
            f"{kernel}_share": kernel_ms / busy_ms},
         gemm_ms=total(lambda n: any(g in n for g in GEMM_NAMES)),
         top_kernels=[[n[:80], t] for n, t in top])


# --------------------------------------------------------------- train


def smoke_train(cfg, params, dev, batches, oc):
    """Losses of ``len(batches)`` train steps from a copy of ``params``
    on ``dev``."""
    params = tree_map(lambda t: t.to(dev).clone(), params)
    state = {"params": params, "opt": adamw_init(params)}
    step = build_train_step(cfg, TrainConfig(opt=oc))
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in b.items()})
        losses.append(m["loss"].item())
    return losses


def train_parity_phase(dev) -> None:
    """The smoke configs in f32, 3 steps from the same weights and the
    loader's batches: the card (K3 for every attention, K5 for every R
    layer, K4 for every W layer) against the CPU (the reference's routes,
    plain versions); losses within ``TRAIN_LOSS_RTOL`` relative."""
    oc = OptConfig(total_steps=3, warmup_steps=1)
    for arch in ("qwen2_7b", "gemma2_27b", "recurrentgemma_9b", "rwkv6_3b"):
        cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
        params = init_params(model_spec(cfg),
                             torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
        loader = TrainLoader(LoaderConfig(global_batch=2, seq_len=64,
                                          vocab=cfg.vocab, seed=0))
        batches = [loader.build_batch(i) for i in range(3)]
        cpu = smoke_train(cfg, params, "cpu", batches, oc)
        card, launches = counted(
            lambda: smoke_train(cfg, params, dev, batches, oc))
        if set(cfg.layer_pattern) & {"G", "L"}:
            assert launches["flash_attention"] > 0, launches
        if "W" in cfg.layer_pattern:
            assert launches["rwkv6_wkv"] > 0, launches
        if "R" in cfg.layer_pattern:
            assert launches["rglru_scan"] > 0, launches
            assert launches["rglru_scan_reverse"] > 0, launches
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        assert rel <= TRAIN_LOSS_RTOL, (arch, card, cpu)
        emit("train_parity", config=f"{arch} smoke f32", steps=3,
             seq_len=64, batch=2, losses_card=card, losses_cpu=cpu,
             max_rel_diff=rel, rtol=TRAIN_LOSS_RTOL,
             kernel_launches=launches)


def train_steps(cfg, dev, expect, config):
    """4 AdamW steps of ``cfg`` (bf16, seeded random weights) at batch
    2 x 4096 from ``TrainLoader`` through ``build_train_step``, every
    launch counted; ``expect`` holds each kernel's launches a step by the
    layout. Returns (step_fn, state, a fifth batch, the run's launches)."""
    tc = TrainConfig(opt=OptConfig(total_steps=4, warmup_steps=1))
    n_steps, B, S = 4, 2, 4096
    t0 = time.time()
    state = make_train_state(cfg, tc, torch.Generator(
        device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for _, t in tree_paths(state["params"]))
    loader = TrainLoader(LoaderConfig(global_batch=B, seq_len=S,
                                      vocab=cfg.vocab, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in loader.build_batch(i).items()}
               for i in range(n_steps + 1)]
    step_fn = build_train_step(cfg, tc)
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []

    def run():
        nonlocal state
        for i in range(n_steps):
            before = {k.__name__: k.launches for k in COUNTED}
            t = time.time()
            state, m = step_fn(state, batches[i])
            torch.cuda.synchronize()
            ms = (time.time() - t) * 1e3
            steps.append({
                "step": i, "loss": m["loss"].item(),
                "grad_norm": m["grad_norm"].item(), "lr": m["lr"].item(),
                "ms": ms, "tokens_per_s": B * S / ms * 1e3,
                "launches": {k.__name__: k.launches - before[k.__name__]
                             for k in COUNTED if k.launches
                             - before[k.__name__]}})

    _, counts = counted(run)
    peak = torch.cuda.max_memory_allocated(dev)
    for st in steps:
        assert math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
    for name, n in counts.items():
        assert n == expect.get(name, 0) * n_steps, (counts, expect)
    emit("train", config=config, params=n_params, init_s=init_s, batch=B,
         seq_len=S, steps=steps, kernel_launches=counts,
         expected_launches_per_step=expect, max_memory_allocated=peak)
    return step_fn, state, batches[n_steps], counts


def train_phase(dev) -> dict:
    """The training path at full width: recurrentgemma-9b cut to 5 layers,
    bf16, seeded random weights, 4 AdamW steps at batch 2 x 4096 through
    ``build_train_step``. Returns the launches of K3 and K5 in the run."""
    cfg = configs.get("recurrentgemma_9b").replace(n_layers=5)
    step_fn, state, batch, counts = train_steps(
        cfg, dev, {"flash_attention": 2, "rglru_scan": 6,
              "rglru_scan_reverse": 4},
        "recurrentgemma_9b full width (d_model 4096, 16 heads, MQA, d_head "
        "256, d_ff 12288, vocab 256000, window 2048, lru width 4096), 5 "
        "layers (RRL + RR tail), bf16, random weights (seed 0)")
    layer_check(cfg, state, batch)
    profile_train(cfg, step_fn, state, batch, "5 layers",
                  {"flash_attention": "flash_wgmma_kernel",
                   "rglru_scan": "rglru_"})
    return counts


def rwkv_train_phase(dev) -> dict:
    """The W-layer training path at full width and full depth: rwkv6-3b,
    32 layers, bf16, seeded random weights, 4 AdamW steps at batch
    2 x 4096. Every W layer's WKV is a K4 launch, twice a step (forward
    and checkpoint recompute; the backward recomputes the plain
    chunk-parallel form). Returns K4's launches in the run."""
    cfg = configs.get("rwkv6_3b")
    step_fn, state, batch, counts = train_steps(
        cfg, dev, {"rwkv6_wkv": 2 * cfg.n_layers},
        "rwkv6_3b full width and depth (32 W layers, d_model 2560, 16 "
        "heads x 160, d_ff 8960, vocab 65536), bf16, random weights "
        "(seed 0)")
    rwkv_layer_check(cfg, state, batch)
    profile_train(cfg, step_fn, state, batch, "32 layers",
                  {"rwkv6_wkv": "rwkv6_"})
    # the whole step with the backward's state carry of rwkv6_scan.py and
    # with a plain loop over the chunks, in the order A B B A
    steps = []
    for name, carry in (("two_level", rwkv6_scan_mod._carry),
                        ("loop", carry_loop), ("loop", carry_loop),
                        ("two_level", rwkv6_scan_mod._carry)):
        with mock.patch.object(rwkv6_scan_mod, "_carry", carry):
            t = time.time()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
        steps.append({"carry": name, "ms": (time.time() - t) * 1e3,
                      "loss": m["loss"].item()})
        assert math.isfinite(steps[-1]["loss"]), steps
    emit("train_carry", what="rwkv6_3b steps with each state carry in "
         "the WKV backward", steps=steps)
    return counts


RESUME_STEPS, RESUME_AT = 6, 3


def lerc_pipeline(cfg, B, S, spill_dir):
    """``examples/train_lm.py``'s input: 8 token blocks of (B, S) int32
    from a seeded generator and their label blocks (``np.roll`` by one
    token), zipped into a batches dataset (a peer group a step) under the
    port's LERC ``Executor``, whose cache holds 6 token blocks, below the
    working set, so blocks spill to ``spill_dir`` and are re-read."""
    rng = np.random.default_rng(0)
    tok = [rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
           for _ in range(8)]
    lab = [np.roll(tb, -1, axis=1) for tb in tok]
    pipe = Pipeline("train")
    rt = pipe.source(tok, "tokens")
    rl = pipe.source(lab, "labels")
    rz = pipe.zip_([rt, rl], lambda t, l: np.stack([t, l]), "batches")
    ex = Executor(pipe, cache_bytes=6 * tok[0].nbytes, policy="lerc",
                  spill_dir=spill_dir)
    ex.load_sources(rt)
    ex.load_sources(rl)
    return ex, rz


def leaves_differ(a, b) -> list:
    """The paths of the leaves of two state trees that are not equal bit
    for bit."""
    lb = dict(tree_paths(b))
    return ["/".join(p) for p, t in tree_paths(a)
            if t.dtype != lb[p].dtype or not torch.equal(t, lb[p])]


def train_resume_phase(dev) -> None:
    """rwkv6-3b at full width, 4 layers, fed by the port's LERC pipeline:
    run A (6 steps), its control A' (the same 6 steps from a fresh state,
    which must equal A bit for bit), and run B (3 steps, an
    ``AsyncCheckpointer`` save at step 3, the state dropped and loaded
    back from disk, 3 more steps), whose parameters, moments, step and
    losses of steps 3-5 must equal A's bit for bit. Then the launcher
    (``launch.train.train_main``) on the rwkv6 smoke config: 6 steps with
    a checkpoint every 3, and in a second directory a run preempted by
    SIGTERM during step 3 and resumed with ``--resume``; their
    ``step_00000006`` files must be equal byte for byte."""
    cfg = configs.get("rwkv6_3b").replace(n_layers=4)
    tc = TrainConfig(opt=OptConfig(total_steps=RESUME_STEPS,
                                   warmup_steps=1))
    B, S = 2, 4096
    step_fn = build_train_step(cfg, tc)
    root = tempfile.mkdtemp(prefix="train_resume_")
    t_phase = time.time()

    def fresh():
        return make_train_state(cfg, tc, torch.Generator(
            device=dev).manual_seed(0), dev)

    def run(name, state, start, n):
        ex, rz = lerc_pipeline(cfg, B, S, os.path.join(root, "spill", name))
        steps = []

        def go():
            nonlocal state
            for i in range(start, start + n):
                pair = ex.get(rz, i % 8)
                batch = {"tokens": torch.from_numpy(pair[0]).to(dev),
                         "targets": torch.from_numpy(pair[1]).to(dev)}
                t = time.time()
                state, m = step_fn(state, batch)
                torch.cuda.synchronize()
                steps.append({"step": i, "loss": m["loss"].item(),
                              "ms": (time.time() - t) * 1e3})
        _, launches = counted(go)
        assert launches["rwkv6_wkv"] == 2 * cfg.n_layers * n, launches
        for st in steps:
            assert math.isfinite(st["loss"]), steps
        emit("train_resume_run", run=name, steps=steps,
             kernel_launches={k: v for k, v in launches.items() if v},
             pipeline_metrics=ex.metrics.as_dict(),
             pipeline_stats=dataclasses.asdict(ex.stats))
        return state, [st["loss"] for st in steps]

    try:
        a, losses_a = run("A", fresh(), 0, RESUME_STEPS)
        control, losses_c = run("A_control", fresh(), 0, RESUME_STEPS)
        control_differs = leaves_differ(a, control)
        control_equal = not control_differs and losses_c == losses_a
        del control
        assert control_equal, ("the uninterrupted run is not deterministic",
                               control_differs, losses_a, losses_c)

        b, losses_b = run("B_first", fresh(), 0, RESUME_AT)
        ck = AsyncCheckpointer(os.path.join(root, "ckpt"))
        t0 = time.time()
        ck.save(RESUME_AT, {"state": b, "loader": {"next_step": RESUME_AT}})
        t1 = time.time()
        ck.wait()
        t2 = time.time()
        del b
        gc.collect()
        torch.cuda.empty_cache()
        path = latest(os.path.join(root, "ckpt"))
        ckpt_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t3 = time.time()
        step, payload = load(path, dev)
        torch.cuda.synchronize()
        load_s = time.time() - t3
        assert step == RESUME_AT
        start = int(payload["loader"]["next_step"])
        b, more = run("B_resumed", payload["state"], start,
                      RESUME_STEPS - start)
        losses_b += more
        differs = leaves_differ(a, b)
        assert not differs, ("resumed run differs", differs)
        assert losses_b[RESUME_AT:] == losses_a[RESUME_AT:], (losses_a,
                                                              losses_b)
        n_params = sum(t.numel() for _, t in tree_paths(a["params"]))
        del a, b, payload
        gc.collect()
        torch.cuda.empty_cache()
        launcher = launcher_resume(root)
        emit("train_resume", config="rwkv6_3b full width (d_model 2560, 16 "
             "heads x 160, d_ff 8960, vocab 65536, tied embeddings), bf16, "
             "random weights (seed 0)", params=n_params, batch=B, seq_len=S,
             reduced={"n_layers": "32 -> 4: the phase writes the whole "
                      "train state to disk and reads it back; at full depth "
                      "that would be about 29 GB of host memory and disk a "
                      "write, and the full-depth step is timed by the "
                      "rwkv6_3b train phase"},
             losses_a=losses_a, losses_b=losses_b,
             control_equal=control_equal, resumed_equal=True,
             checkpoint_bytes=ckpt_bytes,
             snapshot_ms=(t1 - t0) * 1e3, write_s=t2 - t1, load_s=load_s,
             launcher=launcher, seconds=time.time() - t_phase)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def launcher_resume(root) -> dict:
    """The launcher on the card: ``--arch rwkv6_3b --smoke --steps 6
    --ckpt-every 3`` run through, and in a second directory preempted by
    SIGTERM during step 3 (a last checkpoint, then exit) and resumed with
    ``--resume`` to step 6; the two ``step_00000006`` must be equal file
    by file, byte for byte. Returns what it checked, for the phase's
    line."""
    argv = ["--arch", "rwkv6_3b", "--smoke", "--steps", str(RESUME_STEPS),
            "--ckpt-every", str(RESUME_AT), "--log-every", "1"]
    full, split = os.path.join(root, "full"), os.path.join(root, "split")
    real = launch_train.build_train_step

    def preempting(cfg, tc):
        step_fn, calls = real(cfg, tc), []

        def step(state, batch):
            calls.append(1)
            if len(calls) == RESUME_AT:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, batch)
        return step

    def launcher(args):
        return counted(lambda: launch_train.train_main(argv + args))[1]

    n_full = launcher(["--ckpt-dir", full])
    with mock.patch.object(launch_train, "build_train_step", preempting):
        n_first = launcher(["--ckpt-dir", split])
    assert sorted(os.listdir(split)) == [f"step_{RESUME_AT:08d}"]
    n_resumed = launcher(["--ckpt-dir", split, "--resume"])
    a = os.path.join(full, f"step_{RESUME_STEPS:08d}")
    b = os.path.join(split, f"step_{RESUME_STEPS:08d}")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    per_step = 2 * configs.get("rwkv6_3b", smoke=True).n_layers
    for n, steps in ((n_full, RESUME_STEPS), (n_first, RESUME_AT),
                     (n_resumed, RESUME_STEPS - RESUME_AT)):
        assert n["rwkv6_wkv"] == per_step * steps, n
    return {"argv": argv, "files": len(names),
            "bytes": sum(os.path.getsize(os.path.join(a, f))
                         for f in names),
            "step6_equal": True, "rwkv6_wkv_launches": {
                "full": n_full["rwkv6_wkv"],
                "preempted": n_first["rwkv6_wkv"],
                "resumed": n_resumed["rwkv6_wkv"]}}


def layer_check(cfg, state, batch) -> None:
    """One forward at the trained weights and a fresh batch: every K3 and
    K5 call held to its plain version on the same inputs (the kernel's
    output carried on), within ``LAYER_RTOL`` of the layer's scale; then
    the whole loss by the kernel route and by the plain route, printed
    (a random deep net turns one ulp into large logit moves, so that
    difference is not asserted)."""
    errs = {"flash_attention": [], "rglru_scan": []}

    def k3(q, k, v, **kw):
        got = flash_attention(q, k, v, **kw)
        errs["flash_attention"].append(
            rel_err(got, flash_attention_plain(q, k, v, **kw)[0]))
        return got

    def k5(a, b):
        y, h = rglru_scan(a, b)
        errs["rglru_scan"].append(rel_err(y, rglru_scan_plain(a, b)[0]))
        return y, h

    with torch.no_grad():
        with mock.patch.object(model_layers, "flash_attention", k3), \
                mock.patch.object(model_recurrent, "_rglru_scan_kernel", k5):
            loss_kernel = loss_fn(cfg, state["params"], batch).item()
        with mock.patch.object(model_layers, "flash_attention",
                               lambda q, k, v, **kw: flash_attention_plain(
                                   q, k, v, **kw)[0]), \
                mock.patch.object(model_recurrent, "_rglru_scan_kernel",
                                  rglru_scan_plain):
            loss_plain = loss_fn(cfg, state["params"], batch).item()
    assert len(errs["flash_attention"]) == 1, errs
    assert len(errs["rglru_scan"]) == 4, errs
    for name, e in errs.items():
        assert max(e) <= LAYER_RTOL[name], (name, e)
    emit("train_layers", what="recurrentgemma_9b 5 layers, bf16, trained "
         "weights, fresh batch 2 x 4096: each layer's kernel output "
         "against its plain version on the same inputs",
         rel_err=errs, rtol=LAYER_RTOL, loss_kernel_route=loss_kernel,
         loss_plain_route=loss_plain,
         loss_abs_diff=abs(loss_kernel - loss_plain))


def rwkv_layer_check(cfg, state, batch) -> None:
    """One forward at the trained weights and a fresh batch: every W
    layer's K4 output held to its plain version on the same inputs (the
    kernel's output carried on), within ``LAYER_RTOL`` of the layer's
    scale; then the whole loss by the kernel route and by the plain
    route, printed."""
    errs = []

    def k4(r, k, v, logw, u, *, chunk):
        got = rwkv6_wkv(r, k, v, logw, u, chunk=chunk)
        errs.append(rel_err(got[0], rwkv6_wkv_plain(r, k, v, logw, u,
                                                    chunk=chunk)[0]))
        return got

    with torch.no_grad():
        with mock.patch.object(model_recurrent, "_rwkv6_wkv_kernel", k4):
            loss_kernel = loss_fn(cfg, state["params"], batch).item()
        with mock.patch.object(model_recurrent, "_rwkv6_wkv_kernel",
                               rwkv6_wkv_plain):
            loss_plain = loss_fn(cfg, state["params"], batch).item()
    assert len(errs) == cfg.n_layers, errs
    assert max(errs) <= LAYER_RTOL["rwkv6_wkv"], errs
    emit("train_layers", what="rwkv6_3b 32 layers, bf16, trained weights, "
         "fresh batch 2 x 4096: each layer's K4 output against its plain "
         "version on the same inputs", rel_err=errs,
         rtol=LAYER_RTOL["rwkv6_wkv"], loss_kernel_route=loss_kernel,
         loss_plain_route=loss_plain,
         loss_abs_diff=abs(loss_kernel - loss_plain))


def profile_train(cfg, step_fn, state, batch, depth, kernels) -> None:
    """Where a train step's time goes: one step under torch.profiler,
    CUDA activity only. Device busy share = summed kernel time / wall.
    ``kernels`` maps each port kernel to a substring of its device name."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = device_ms_by_kernel(prof)
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        emit("profile", config=cfg.arch, device_time="not measured: the "
             "profiler recorded no device activity", wall_ms=wall_ms)
        return

    def total(pred):
        return sum(t for n, t in by_name.items() if pred(n.lower()))
    per_kernel = {}
    for name, key in kernels.items():
        ms = total(lambda n: key in n)
        per_kernel.update({f"{name}_ms": ms, f"{name}_share": ms / busy_ms})
    gemm_ms = total(lambda n: any(g in n for g in GEMM_NAMES))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit("profile", config=f"{cfg.arch} {depth}", run="one train step, "
         "batch 2 x 4096", wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms, **per_kernel,
         gemm_ms=gemm_ms, gemm_share=gemm_ms / busy_ms,
         top_kernels=[[n[:80], t] for n, t in top])


def kernel_entry(name, replaces, launches, kern) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": kern["max_abs_err"], "ms": kern["kernel_ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": kern["bound_by"], "library_ms": kern["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    t0 = time.time()
    logs = build.build(KERNELS)
    emit("build", seconds=time.time() - t0, kernels=KERNELS,
         ptxas=[ln.strip() for log in logs.values()
                for ln in log.splitlines()
                if "Function properties" in ln or "Used" in ln
                or "spill" in ln])
    k1 = kernel_phase(dev)
    k2 = decode_kernel_phase(dev)
    k3 = flash_kernel_phase(dev)
    k5 = rglru_kernel_phase(dev)
    k4 = rwkv_kernel_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    parity_phase(dev)
    train_parity_phase(dev)
    k1_launches, k1_runs = serve_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()       # the qwen2 weights go before gemma2's
    k2_launches, k2_runs = gather_serve_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()       # gemma2's 54.5 GB go before training
    train_launches = train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()       # recurrentgemma's state goes before rwkv6's
    k4_launches = rwkv_train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()       # rwkv6's 32-layer state goes first
    train_resume_phase(dev)
    k1_entry = kernel_entry("paged_attention",
                            "src/repro/kernels/paged_attention.py:41",
                            k1_launches, k1)
    k1_entry.update(tpu_kernel="src/repro/kernels/paged_attention.py:"
                    "_paged_kernel", max_err=k1["max_abs_err"],
                    kernel_ms=k1["kernel_ms"], shape="B=8 S=1 H=28 KV=4 "
                    "D=128 bt=16 NW=64, bf16", design=k1["design"],
                    device_launches=k1_runs,
                    kernel_host_ms=k1["kernel_host_ms"], S64=k1["S64"])
    k2_entry = kernel_entry("decode_attention",
                            "src/repro/kernels/decode_attention.py:29",
                            k2_launches, k2)
    k2_entry.update(tpu_kernel="src/repro/kernels/decode_attention.py:"
                    "_decode_kernel", shape="B=8 H=32 KV=16 D=128 S=128 "
                    "ragged, bf16", S4096=k2["S4096"],
                    device_launches=k2_runs)
    k3_entry = kernel_entry("flash_attention",
                            "src/repro/kernels/flash_attention.py:35",
                            train_launches["flash_attention"], k3)
    k3_entry.update(tpu_kernel="src/repro/kernels/flash_attention.py:"
                    "_flash_kernel", shape="recurrentgemma L layer: B=2 "
                    "S=4096 H=16 KV=1 D=256 window 2048, bf16",
                    design=k3["design"], gemma2_G=k3["gemma2_G"])
    k5_entry = kernel_entry("rglru_scan",
                            "src/repro/kernels/rglru_scan.py:28",
                            train_launches["rglru_scan"]
                            + train_launches["rglru_scan_reverse"], k5)
    k5_entry.update(tpu_kernel="src/repro/kernels/rglru_scan.py:"
                    "_rglru_kernel", shape="B=2 T=4096 W=4096, fp32",
                    launches_forward=train_launches["rglru_scan"],
                    launches_reverse=train_launches["rglru_scan_reverse"],
                    reverse_ms=k5["reverse_kernel_ms"],
                    reverse_plain_ms=k5["reverse_plain_ms"],
                    reverse_bound_ms=k5["reverse_bound_ms"],
                    plan=k5["plan"], reverse_plan=k5["reverse_plan"],
                    kernel_host_ms=k5["kernel_host_ms"],
                    B1={key: k5["B1"][key] for key in (
                        "kernel_ms", "reverse_kernel_ms", "bound_ms",
                        "reverse_bound_ms", "plan", "reverse_plan")})
    k4_entry = kernel_entry("rwkv6_scan",
                            "src/repro/kernels/rwkv6_scan.py:27",
                            k4_launches["rwkv6_wkv"], k4)
    k4_entry.update(tpu_kernel="src/repro/kernels/rwkv6_scan.py:"
                    "_rwkv_kernel", shape="rwkv6-3b W layer: B=2 T=4096 "
                    "H=16 N=160 chunk 16, bf16 r/k/v, fp32 logw/u/out",
                    max_rel_err=k4["max_rel_err"],
                    chunked_ms=k4["chunked_ms"],
                    backward_plain_ms=k4["backward_two_level_ms"])
    print(json.dumps({"kernels": [k1_entry, k2_entry, k3_entry, k4_entry,
                                  k5_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
