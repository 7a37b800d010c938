"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA Hopper GPU: the quickest proof that the port still starts there.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line; any failure raises and the process
exits non-zero:

1. device  — CUDA must be available; the card's name and power limit.
2. build   — compile every kernel of the main path from the sources in
             the checkout (one nvcc per source, started together).
3. kernel  — hold each kernel against its plain PyTorch version on the
             card (f32 on the reference test's cases, bf16 at the main
             path's shapes) and time both, the library yardstick and the
             least time the card could take.
4. parity  — the serve engine on the card (kernel) against the same
             engine on the CPU (plain version), smoke config in f32.
5. serve   — the main path: full-width qwen2-7b (28 layers, seeded random
             weights, bf16) served through ``ServeEngine(paged=True)``
             under a LERC prefix cache with byte pressure; every attention
             launch is counted. Then one decode step through the plain
             attention and one through the kernel on the same inputs,
             and a short run under torch.profiler: device busy and idle
             share, K1's and the GEMMs' device time.
6. the kernels line, the card line, and the result line.

It imports only the port, torch and numpy, and needs no network.
"""
from __future__ import annotations

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
from repro_torch.kernels import (paged_attention_plain,  # noqa: E402
                                 paged_decode_attention)
from repro_torch.models import (init_params, lm_decode_step,  # noqa: E402
                                model_spec)
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.float32: 67e12}     # fp32 outside the tensor cores
KERNELS = ["paged_attention"]
PAGED_CASES = [
    # (B, S, H, KV, D, bt, NW, softcap), the reference test's cases
    (2, 1, 4, 2, 64, 8, 8, None),
    (3, 4, 4, 1, 64, 8, 6, None),
    (1, 8, 8, 2, 32, 4, 16, 50.0),
    (2, 3, 2, 2, 128, 16, 4, None),
]
# f32: kernel and plain version both sum in fp32, in different orders
F32_ATOL = 1e-4
# bf16: both round an fp32 result below 2 in magnitude to bf16 (one ulp
# there is at most 2^-7 = 7.8e-3) after summing in different orders
BF16_ATOL = 2e-2
# full-model logits, plain vs kernel attention in bf16: the one-ulp
# differences of 28 attention outputs travel through the residual stream,
# so the bar is relative to the logits' own scale
LOGITS_RTOL = 5e-2


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


# --------------------------------------------------------------- serve


def shared_prefix_prompts(vocab, n, families, prefix, unique, seed):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, prefix)) for _ in range(families)]
    return [prefixes[i % families] + list(rng.integers(0, vocab, unique))
            for i in range(n)]


def run_engine(cfg, params, dev, prompts, *, cap_blocks, bt, slots, max_seq,
               chunk, max_new):
    probe = ServeEngine(cfg, params, max_slots=1, max_seq=bt,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=bt),
                        pool_blocks=1, device=dev)
    store = PrefixStore(cap_blocks * probe._block_nbytes(), "lerc",
                        block_tokens=bt)
    del probe
    eng = ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                      store=store, prefill_chunk=chunk, paged=True,
                      device=dev)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    return eng, store, reqs


def parity_phase(dev) -> None:
    """Smoke config in f32: the engine on the card (kernel) gives the CPU
    engine's (plain version's) tokens, eviction log and metrics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype=torch.float32)
    prompts = shared_prefix_prompts(cfg.vocab, 9, 3, 24, 8, seed=7)
    kw = dict(cap_blocks=10, bt=8, slots=2, max_seq=64, chunk=8, max_new=4)
    runs = [run_engine(cfg, params, d, prompts, **kw) for d in ("cpu", dev)]
    (ce, cs, cr), (ge, gs, gr) = runs
    assert cs.evictions > 0
    assert [r.generated for r in gr] == [r.generated for r in cr]
    assert gs.eviction_log == cs.eviction_log
    assert ge.metrics() == ce.metrics()
    emit("parity", config="qwen2_7b smoke f32", requests=len(prompts),
         tokens_identical=True, evictions=cs.evictions)


def serve_phase(dev) -> int:
    """The main path at full width. Returns the kernel launches it made."""
    cfg = configs.get("qwen2_7b")                  # full width, bf16
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model_spec(cfg), gen, dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    kw = dict(bt=16, slots=8, max_seq=640, chunk=64, max_new=32)
    # warm-up (cuBLAS handles, allocator), not counted
    run_engine(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 2, 1, 64, 16, seed=1), cap_blocks=96,
        **{**kw, "max_new": 2})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = shared_prefix_prompts(cfg.vocab, 16, 4, 512, 64, seed=0)

    paged_decode_attention.launches = 0
    t0 = time.time()
    eng, store, reqs = run_engine(cfg, params, dev, prompts, cap_blocks=96,
                                  **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = paged_decode_attention.launches

    m = eng.metrics()
    resident = sum(1 for n in store._nodes.values() if n.resident)
    tokens = [t for r in reqs for t in r.generated]
    assert launches == cfg.n_layers * eng.steps, (launches, eng.steps)
    assert m["evictions"] > 0 and m["effective_hits"] > 0, m
    assert eng.pool.blocks_in_use == resident + 1
    assert len(tokens) == 16 * kw["max_new"]
    assert all(0 <= t < cfg.vocab for t in tokens)
    emit("serve", config="qwen2_7b full width, 28 layers, bf16, random "
         "weights (seed 0)", requests=len(prompts), engine_steps=eng.steps,
         kernel_launches=launches, generated_tokens=len(tokens),
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
    torch.cuda.synchronize()
    ref, got = logits["xla"], logits["flash"]
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    assert err <= LOGITS_RTOL * scale, (err, scale)
    emit("decode_step", what="lm_decode_step plain vs kernel attention, "
         "bf16, S=64, 7 live rows + 1 idle", max_abs_err=err,
         logits_scale=scale, rtol=LOGITS_RTOL, argmax_agreement=agree)
    profile_serve(cfg, params, dev, kw)
    return launches


def profile_serve(cfg, params, dev, kw) -> None:
    """Where a serve step's time goes: a short run of the main path's
    shape (8 requests, 8 new tokens each) under torch.profiler, CUDA
    activity only. Device busy share = summed kernel time / wall time."""
    prompts = shared_prefix_prompts(cfg.vocab, 8, 4, 512, 64, seed=2)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        eng, _, _ = run_engine(cfg, params, dev, prompts, cap_blocks=96,
                               **{**kw, "max_new": 8})
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    busy_ms = sum(by_name.values())
    if busy_ms == 0:
        emit("profile", device_time="not measured: the profiler recorded "
             "no device activity", wall_ms=wall_ms, engine_steps=eng.steps)
        return
    gemm = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")

    def total(pred):
        return sum(t for n, t in by_name.items() if pred(n.lower()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", run="8 requests x (512 shared + 64 unique) prompt "
         "tokens, 8 new tokens, 8 slots, chunk 64", engine_steps=eng.steps,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms,
         paged_attention_ms=total(lambda n: "paged_attention" in n),
         gemm_ms=total(lambda n: any(g in n for g in gemm)),
         top_kernels=[[n[:80], t] for n, t in top])


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
    kern = kernel_phase(dev)
    parity_phase(dev)
    launches = serve_phase(dev)
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:41",
        "tpu_kernel": "src/repro/kernels/paged_attention.py:_paged_kernel",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"], "max_err": kern["max_abs_err"],
        "ms": kern["kernel_ms"], "kernel_ms": kern["kernel_ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
