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
             kernel, K2 the flash-decoding kernel.
4. parity  — the serve engine on the card (kernels) against the same
             engine on the CPU (plain versions), smoke configs in f32: the
             paged plane on qwen2, the gather plane on gemma2 and qwen2.
5. serve   — the paged path: full-width qwen2-7b (28 layers, seeded
             random weights, bf16) served through ``ServeEngine(paged=
             True)`` under a LERC prefix cache with byte pressure; every
             attention launch is counted. Then one decode step through the
             plain attention and one through K1 on the same inputs, and a
             short run under torch.profiler: device busy and idle share,
             K1's and the GEMMs' device time.
6. serve   — the gather path: full-width, full-depth gemma2-27b (46 layers
             alternating rolling-window and global attention, softcaps,
             bf16, seeded random weights) through ``ServeEngine(paged=
             False)`` under a LERC store smaller than the working set;
             every attention is a K2 launch. Then one decode step through
             the plain attention and one through K2 with the rolling
             window wrapped, and a short profiled run.
7. the kernels line, the card line, and the result line.

Each path runs with every launch count set to 0 just before it and read
just after; a path whose kernel was never launched fails.

It imports only the port, torch and numpy, and needs no network.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain,
                                 paged_attention_plain,
                                 paged_decode_attention)
from repro_torch.models import (init_decode_cache,  # noqa: E402
                                init_params, lm_decode_step, model_spec,
                                tree_paths)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
KERNELS = ["paged_attention", "decode_attention"]
COUNTED = (paged_decode_attention, decode_attention)
PAGED_CASES = [
    # (B, S, H, KV, D, bt, NW, softcap), the reference test's cases
    (2, 1, 4, 2, 64, 8, 8, None),
    (3, 4, 4, 1, 64, 8, 6, None),
    (1, 8, 8, 2, 32, 4, 16, 50.0),
    (2, 3, 2, 2, 128, 16, 4, None),
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- kernel


def paged_inputs(B, S, H, KV, D, bt, NW, dtype, dev, seed, inactive=False):
    """Seeded pool pages, disjoint shuffled tables, ragged positions; with
    ``inactive`` the last row is an idle slot (all-zero table, lens 0)."""
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
    """K1 against its plain version; times at the paged path's shapes."""
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
         f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    return {"max_abs_err": max(errs.values()), **timings[1]}


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
    and on rows that see nothing, one slot or all, then bf16 at the gather
    path's shapes (gemma2-27b: B=8, H=32, KV=16, D=128, softcap 50) with
    ragged valid lengths at S=128 and the wrapped rolling window at
    S=4096, timed."""
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
        }
        emit("kernel", name="decode_attention", dtype="bfloat16",
             shape={"B": 8, "S": S, "H": 32, "KV": 16, "D": 128,
                    "softcap": 50.0}, valid_len=valid, max_abs_err=err,
             atol=BF16_ATOL, **timings[S])
    emit("kernel_check", name="decode_attention", max_abs_err=errs,
         f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    return {"max_abs_err": max(errs.values()), **timings[128],
            "S4096": timings[4096]}


# --------------------------------------------------------------- serve


def shared_prefix_prompts(vocab, n, families, prefix, unique, seed):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, prefix)) for _ in range(families)]
    return [prefixes[i % families] + list(rng.integers(0, vocab, unique))
            for i in range(n)]


def run_engine(cfg, params, dev, prompts, *, cap_blocks, bt, slots, max_seq,
               chunk, max_new, paged):
    probe = ServeEngine(cfg, params, max_slots=1, max_seq=bt,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=bt),
                        pool_blocks=1, prefill_chunk=chunk, paged=paged,
                        device=dev)
    store = PrefixStore(cap_blocks * probe._block_nbytes(), "lerc",
                        block_tokens=bt)
    del probe
    eng = ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                      store=store, prefill_chunk=chunk, paged=paged,
                      device=dev)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    return eng, store, reqs


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


def serve_phase(dev) -> int:
    """The paged path at full width. Returns K1's launches in its run."""
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

    t0 = time.time()
    (eng, store, reqs), counts = counted(lambda: run_engine(
        cfg, params, dev, prompts, cap_blocks=96, **kw))
    wall = time.time() - t0
    launches = counts["paged_decode_attention"]

    m = eng.metrics()
    resident = sum(1 for n in store._nodes.values() if n.resident)
    tokens = [t for r in reqs for t in r.generated]
    assert launches == cfg.n_layers * eng.steps, (launches, eng.steps)
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
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))

    # one decode step over the pool the run left, plain vs kernel attention
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
    logits = {}
    for impl in ("xla", "flash"):
        pool = {"stack": {k: {n: t.clone() for n, t in leaf.items()}
                          for k, leaf in eng.pool.buffers["stack"].items()}}
        out, _ = lm_decode_step(cfg.replace(decode_kernel=impl), eng.params,
                                pool, toks, pos, seq_lens=lens,
                                paged_tables=tables)
        logits[impl] = out[:-1, 0].float()           # live rows
        del pool
    compare_logits("lm_decode_step plain vs kernel attention, bf16, S=64, "
                   "7 live rows + 1 idle", logits)
    profile_serve(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 8, 4, 512, 64, seed=2), {**kw, "max_new": 8},
        "8 requests x (512 shared + 64 unique) prompt tokens, 8 new "
        "tokens, 8 slots, chunk 64", "paged_attention")
    return launches


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


def gather_serve_phase(dev) -> int:
    """The gather path at full width and depth: gemma2-27b, 46 layers, every
    attention a K2 launch. Returns K2's launches in its run."""
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

    t0 = time.time()
    (eng, store, reqs), counts = counted(lambda: run_engine(
        cfg, params, dev, prompts, cap_blocks=24, **kw))
    wall = time.time() - t0
    launches = counts["decode_attention"]

    m = eng.metrics()
    tokens = [t for r in reqs for t in r.generated]
    assert launches == cfg.n_layers * eng.steps, (launches, eng.steps)
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
         max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    del eng, store, reqs

    gather_decode_step(cfg, params, dev)
    profile_serve(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 8, 4, 64, 16, seed=2), {**kw, "max_new": 4},
        "8 requests x (64 shared + 16 unique) prompt tokens, 4 new tokens, "
        "8 slots, chunk 1", "decode_attention", cap_blocks=24)
    return launches


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


def profile_serve(cfg, params, dev, prompts, kw, run, kernel,
                  cap_blocks=96) -> None:
    """Where a serve step's time goes: a short run of a path's shape under
    torch.profiler, CUDA activity only. Device busy share = summed kernel
    time / wall time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng, _, _ = run_engine(cfg, params, dev, prompts,
                               cap_blocks=cap_blocks, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        emit("profile", config=cfg.arch, device_time="not measured: the "
             "profiler recorded no device activity", wall_ms=wall_ms,
             engine_steps=eng.steps)
        return

    def total(pred):
        return sum(t for n, t in by_name.items() if pred(n.lower()))
    kernel_ms = total(lambda n: kernel in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", config=cfg.arch, run=run, engine_steps=eng.steps,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms,
         **{f"{kernel}_ms": kernel_ms,
            f"{kernel}_share": kernel_ms / busy_ms},
         gemm_ms=total(lambda n: any(g in n for g in GEMM_NAMES)),
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
    parity_phase(dev)
    k1_launches = serve_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()       # the qwen2 weights go before gemma2's
    k2_launches = gather_serve_phase(dev)
    k1_entry = kernel_entry("paged_attention",
                            "src/repro/kernels/paged_attention.py:41",
                            k1_launches, k1)
    k1_entry.update(tpu_kernel="src/repro/kernels/paged_attention.py:"
                    "_paged_kernel", max_err=k1["max_abs_err"],
                    kernel_ms=k1["kernel_ms"])
    k2_entry = kernel_entry("decode_attention",
                            "src/repro/kernels/decode_attention.py:29",
                            k2_launches, k2)
    k2_entry.update(tpu_kernel="src/repro/kernels/decode_attention.py:"
                    "_decode_kernel", shape="B=8 H=32 KV=16 D=128 S=128 "
                    "ragged, bf16", S4096=k2["S4096"])
    print(json.dumps({"kernels": [k1_entry, k2_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
