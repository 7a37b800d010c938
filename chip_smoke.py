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
             bf16; recurrentgemma's L-layer and whisper's self- and
             cross-attention decode shapes), K3 the flash-attention
             kernel of the training forward (forward and, through its
             autograd Function, backward, in f32 and bf16, on causal,
             windowed, bidirectional, cross-attention (Sq != Skv) and
             prefix-LM masks; recurrentgemma's L layer and gemma2's G
             layer at S=4096, whisper's encoder and cross-attention,
             paligemma's prefix-LM layer), K5 the RG-LRU
             scan (forward, reverse and gradients, bit-equal, on ragged
             cases; timed at B=1 and B=2, T=4096, W=4096), K4
             the RWKV6 WKV
             (f32 on the reference test's cases and at logw = -5, then
             bf16 r, k, v at rwkv6-3b's training shape B=2, T=4096,
             H=16, N=160; the gradients through its Function against
             autograd of its plain version; the backward's state carry
             against a plain loop over the chunks). K1 is also timed at
             one rank's heads of qwen2-7b served at tp=2 (H=14, KV=2).
4. parity  — the serve engine on the card (kernels, captured steps)
             against the same engine on the CPU (plain versions, eager),
             smoke configs in f32: the paged plane on qwen2, moonshot and
             llama4 (MoE) and paligemma (text-only decode), the gather
             plane on gemma2 and qwen2; then a 2-shard ``ShardedFrontend``
             on the codeqwen1.5-7b and qwen2-7b smoke configs under byte
             pressure: card equal to CPU (tokens, per-shard and replica
             eviction logs, metrics), K=2 equal to K=1 on the card, and a
             timed trace with a shard crash under a lossy status channel
             equal to the clean trace (tokens keyed by prompt and
             arrival), on the card as on the CPU.
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
             GEMMs' device time. ``serve_tp``: the same cell on the
             tensor-parallel path at tp=1 (a one-rank NCCL group, captured
             steps, K1 on the rank's head slice, the outputs all-gathered
             over heads before ``wo``): tokens, eviction log and metrics
             equal to the plain engine's, 28 K1 launches a step, both
             runs' tokens/s and what the TP graph holds beyond the plain
             one. Then ``tiered_serve``: two waves of 16
             requests (the same 4 prefixes, fresh suffixes) under five
             stores, (e) unbounded, (a) 96 blocks, (b) 96 over a lossless
             pinned host tier of 256 blocks, (c) the same host bytes in
             int8, (d) 32 host blocks over a 512-block disk tier; (b) and
             (d) must demote and promote, take (e)'s steps and give its
             tokens, and prefill fewer wave-2 tokens than (a); each wave's
             wall, the store's tier counters, K1's launches and every pool
             transfer's blocks, ms and GB/s are printed; then (c) again
             on the TP path at tp=1 (its int8 scales' amax all-reduced):
             equal to (c).
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
7. recurrent_decode — R and W layers through ``decode_step`` at full
             width and depth, bf16, seeded random weights: recurrentgemma-9b
             (38 layers; every L layer's attention a K2 launch, 12 a step)
             and rwkv6-3b (32 W layers, the reference's plain one-step
             update), 8 rows, a 64-token prompt a token a step and 32
             greedy tokens: ms a step, tokens/s, the cache's dtypes (``S``
             and ``h`` fp32), a profiled window; recurrentgemma's step at
             pos 2100 (window wrapped) with each L layer's K2 output held
             to its plain version; then both smoke configs in f32, the
             card against the CPU (identical tokens) and against its own
             ``forward``.
8. moe_serve — M layers on the paged plane: full-width, full-depth
             moonshot-v1-16b-a3b (48 M layers, 57.1 GB) under the qwen2
             cell's traffic, captured and eager (identical tokens,
             eviction log and metrics, 48 K1 launches a step),
             ``steady_decode``, a profiled run and the MoE layer's router,
             expert, one-hot and shared-expert times; then
             llama4-maverick at full width cut to one GM unit (2 layers,
             35.3 GB), captured and eager.
9. legacy_serve — ``LegacyServeEngine`` (token at a time, host KV
             round-trips, eager) beside ``ServeEngine(paged=False,
             prefill_chunk=1)`` on full-width qwen2-7b cut to 4 layers: the
             same tokens, eviction log and steps, 4 K2 launches a step in
             each.
    vlm_serve — paligemma-3b at full width and depth (18 layers, MQA, D
             256, vocab 257,216, 5.0 GB) under the qwen2 paged cell's
             traffic, as moonshot is served: captured and eager (identical
             tokens, eviction log and metrics, 18 K1 launches a step),
             ``steady_decode`` and a profiled run.
    sharded_serve — full-width, full-depth codeqwen1.5-7b (32 layers, MHA,
             16.38 GB, made on the card once) behind a 2-shard
             ``ShardedFrontend`` (the qwen2 paged cell's traffic, the
             96-block LERC store split 48 a shard; the four families route
             to shards [1, 1, 0, 1]): (a) captured and (b) eager give equal
             tokens, per-shard and replica eviction logs and metrics, the
             replicas verified after each; 32 K1 launches a step on each
             shard, eager or replayed; the bus's messages by kind; (c) one
             engine over the whole store (token share printed, not gated);
             (d) a timed trace, clean under torch.profiler and with shard 1
             crashed at the clean run's first token on shard 1 under a
             lossy status channel: one crash, every request finished,
             retries and drops counted, replicas verified after a resync;
             the shards' weights are the caller's tensors before and after
             the rebuild; memory allocated before the crash, after the
             rebuild, at the end and at peak. Then the launcher with
             ``--shards 2`` and a crash plan on the smoke config.
10. train  — parity first: the four smoke configs in f32 trained 3
             steps on the card (K3, K5, K4) and on the CPU (plain routes)
             from the same weights and batches, qwen2 also with cross-pod
             gradient compression. Then the training path at full
             width: recurrentgemma-9b cut to 5 layers (one RRL unit and
             the RR tail), bf16, seeded random weights, 4 AdamW steps at
             batch 2 x 4096 tokens through ``build_train_step``, every
             K3 and K5 launch counted; each layer's K3 and K5 outputs
             held to their plain versions at a step's inputs; a profiled
             step.
11. train  — rwkv6-3b at full width and full depth (32 W layers, bf16,
             seeded random weights), 4 AdamW steps at batch 2 x 4096,
             every K4 launch counted (64 a step: 32 forward and 32
             checkpoint recomputes); each layer's K4 output held to its
             plain version; a profiled step; four more steps, the
             backward's state carry two ways (A B B A).
12. train_resume — rwkv6-3b at full width cut to 4 layers (bf16, seeded
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
    train_compressed — the same 4-layer rwkv6-3b, 4 AdamW steps at batch
             2 x 4096 from one fresh state without and with
             ``compress_pod_grads``: step ms, losses, the error-feedback
             residuals' norm.
    vlm_train — paligemma-3b at full width and depth, bf16, seeded random
             weights, 4 AdamW steps at batch 4, each example 256 patch
             embeddings (dim 1152) and 256 tokens: every attention a K3
             launch with the prefix-LM mask (36 a step), step ms, tokens/s
             and peak memory; the first step's loss at 2 layers by K3 and
             by the plain route, beside a one-ulp control; each layer's K3
             output against its plain version; a profiled step.
    encdec — whisper-base at full width and depth (6 + 6 layers): 4 AdamW
             steps at batch 8 (1500 frames, 448 tokens), K3 counted by
             mask (bidirectional, causal, cross; 12 each a step), each
             call against its plain version, a profiled step; then decode
             at the trained
             weights: encode 8 rows, ``encdec_prefill_cache``, 4 prompt
             and 64 greedy tokens through ``decode_step`` (6 self and 6
             cross K2 launches a step), one step's K2 outputs against the
             plain version's, a profiled window; then the smoke config in
             f32, the card against the CPU (identical tokens).
    mesh_train — the mesh path (DTensor, ``launch.mesh``) on a (1, 1)
             mesh over a one-rank NCCL group: moonshot-v1-16b-a3b at
             full width cut to 4 M layers (bf16, seeded random weights,
             batch 2 x 4096 from ``TrainLoader``): one meshless step
             (untimed: K3's launches a step), then 3 AdamW steps on the
             mesh, every MoE layer through the expert-parallel
             ``_moe_ep_device`` at ep=1 (capacity 960 of 8192 tokens), K3
             under ``local_map``: finite losses, K3's launches three
             times the meshless step's, layer 0's EP call equal bit for
             bit to the same call with no group; ms a step, peak memory
             and the assignments capacity dropped in each layer. Then
             each family meshless beside mesh, each run from the state
             seed 0 makes (losses within ``TRAIN_LOSS_RTOL``, K3, K4 and
             K5 launches equal to the meshless run's and to the layout's):
             qwen2-7b cut to 4 layers (3 steps), recurrentgemma-9b cut to
             5 layers and rwkv6-3b cut to 4 (2 steps each), all at batch
             2 x 4096, and whole whisper-base (2 steps at batch 8 x (1500
             frames, 448 tokens)); each then decodes 16 prompt and 16
             greedy tokens of 8 rows through ``decode_step`` with and
             without the mesh at the trained weights (identical tokens,
             equal K2 and K3 launches; a (1, 1) mesh shards no
             sequence, so the kernel phase checks the merge). Then the
             dry-run cells started in subprocesses at the run's beginning
             (moonshot's train_4k on the 512-rank multi-pod mesh;
             recurrentgemma-9b's and whisper-base's decode_32k on the
             256-rank mesh, a fake group): their per-rank bytes and
             ``hbm_frac``. The kernel phase also holds K3 at a query
             offset (the context-parallel rows of one model rank) to its
             plain version and times it at one rank of qwen2-7b's
             prefill_32k beside SDPA with the same boolean mask and the
             bound; and K2's log-sum-exp output to its plain version (at
             the gather shapes and recurrentgemma's L layer, K2 timed
             with and without it), and the merge of K2 on the two halves
             of one qwen2-7b decode_32k row block's keys to K2 over the
             whole cache, timed.
13. the walls line (each phase's seconds), the kernels line (each
             kernel's launches on each of its paths under
             ``launches_by_path``, K1's on the TP path and K2-K5's on the
             mesh paths among them), the card line, and the result line.

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

import atexit
import contextlib
import ctypes
import dataclasses
import filecmp
import gc
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import weakref
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
from repro_torch.faults import BusFault, FaultPlan  # noqa: E402
from repro_torch.launch import ranks as launch_ranks  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh_context  # noqa: E402
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
                                 rwkv6_wkv_plain, merge_partials)
from repro_torch.models import (decode_step, encdec_prefill_cache,  # noqa
                                encode, forward, init_decode_cache,
                                init_params, lm_decode_step, loss_fn,
                                model_spec, tree_paths)
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import moe as model_moe  # noqa: E402
from repro_torch.models import recurrent as model_recurrent  # noqa: E402
from repro_torch.models.common import tree_map, unflatten  # noqa: E402
from repro_torch.serve import (LegacyServeEngine,  # noqa: E402
                               PrefixStore, ServeEngine, ShardedFrontend,
                               TieredKVStore, TracedRequest, play_trace)
from repro_torch.sharding import serve_tp_context  # noqa: E402
from repro_torch.sim import poisson_arrivals  # noqa: E402
from repro_torch.train import (AsyncCheckpointer, OptConfig,  # noqa: E402
                               TrainConfig, adamw_init, build_train_step,
                               compression_ratio, ef_init, latest, load,
                               make_train_state, shard_train_state)

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
# K2 at recurrentgemma-9b's L-layer decode: G=16 heads a KV head at D=256
# (the kernel's NC=2, GB=4 instance, four row groups a KV head) over the
# 2048-slot rolling window, rows full, ragged and wrapped (2048 valid past
# the window)
RG_DECODE = dict(B=8, S=2048, H=16, KV=1, D=256,
                 valid=[2048, 1000, 1, 2048, 517, 2048, 33, 1500])
# K2 at whisper-base's decode (G=1 at D=64, the kernel's first model
# shapes at D=64): the self-attention cache of 448 slots, rows ragged, and
# the cross-attention over 1500 encoder frames, every row full
WHISPER_DECODE = {
    "whisper_self": dict(B=8, S=448, H=8, KV=8, D=64,
                         valid=[448, 1, 100, 300, 17, 448, 64, 250]),
    "whisper_cross": dict(B=8, S=1500, H=8, KV=8, D=64, valid=[1500] * 8),
}
# K2's log-sum-exp (fp32, of scores up to some 60: softcap 50 plus the
# log of the keys) against its plain version: the kernel's fast softcap
# (within about 1e-7 x 50 a score) and its own summation order
LSE_ATOL = 1e-3
# K2's log-sum-exp at the gather shapes (the S=128 row that sees nothing
# gives -inf) and recurrentgemma's L layer, (case, softcap)
LSE_CASES = {
    "S128": (dict(B=8, S=128, H=32, KV=16, D=128,
                  valid=[80, 128, 1, 96, 33, 64, 127, 0]), 50.0),
    "S4096": (dict(B=8, S=4096, H=32, KV=16, D=128, valid=[4096] * 8),
              50.0),
    "recurrentgemma_L": (RG_DECODE, None),
}
# the two-halves merge at one row block of qwen2-7b's decode_32k (B=8 of
# its 128 rows, the 32,768-slot cache, 28 heads over 4 KV heads): rows
# full, one ending inside the first half, one at the halves' border, one
# that sees one key
MERGE_DECODE = dict(B=8, S=32768, H=28, KV=4, D=128,
                    valid=[32768, 32768, 20000, 16384, 100, 32768, 30000,
                           1])
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
# K3 on the masks of the encoder-decoder and image-prefix paths, (B, Sq,
# Skv, H, KV, D, causal, window, softcap, prefix_len): an encoder
# (non-causal, Sq == Skv), cross-attention with ragged key tails both ways,
# PaliGemma's prefix-LM mask with a prefix off the 64-key stage, and with a
# window
FLASH_MASK_CASES = [
    (1, 128, 128, 4, 4, 64, False, None, None, 0),
    (2, 37, 100, 4, 4, 64, False, None, None, 0),
    (1, 100, 37, 2, 1, 64, False, None, 30.0, 0),
    (2, 300, 300, 8, 1, 256, True, None, None, 100),
    (1, 200, 200, 4, 2, 64, True, 32, None, 150),
]
# K3 with a query offset (the mesh path's context-parallel fallback: one
# model rank's rows [q_offset, q_offset + Sq) against every key), (B, Sq,
# Skv, H, KV, D, window, softcap, prefix_len, q_offset), causal: a ragged
# row tile, a window with a softcap, and a prefix, D=64 to 256
FLASH_OFFSET_CASES = [
    (2, 64, 200, 4, 2, 64, None, None, 0, 136),
    (1, 100, 300, 4, 1, 128, 64, 30.0, 0, 150),
    (1, 96, 256, 8, 1, 256, None, None, 100, 160),
]
# K3 at the training path's shapes: recurrentgemma-9b's L layer and
# gemma2-27b's G layer, S=4096 (the repo's train_4k length); whisper-base's
# encoder (bidirectional over 1500 frames) and cross-attention (448 decoder
# tokens over 1500 frames) at batch 8; paligemma-3b's prefix-LM layer (256
# patches + 256 tokens, MQA, D=256) at batch 4. A shape without ``Skv``
# is self-attention; without ``causal``, causal
FLASH_SHAPES = {
    "recurrentgemma_L": dict(B=2, S=4096, H=16, KV=1, D=256, window=2048,
                             softcap=None),
    "gemma2_G": dict(B=2, S=4096, H=32, KV=16, D=128, window=None,
                     softcap=50.0),
    "whisper_enc": dict(B=8, S=1500, H=8, KV=8, D=64, window=None,
                        softcap=None, causal=False),
    "whisper_cross": dict(B=8, S=448, Skv=1500, H=8, KV=8, D=64, window=None,
                          softcap=None, causal=False),
    "paligemma_prefix": dict(B=4, S=512, H=8, KV=1, D=256, window=None,
                             softcap=None, prefix_len=256),
    # one model rank (the last of 16) of qwen2-7b's prefill_32k under the
    # mesh path's context-parallel fallback (28 heads do not divide 16):
    # its 2048 query rows at offset 30720 against all 32768 keys, causal,
    # at batch 1 (the cell's rank holds 2); bf16 only
    "qwen2_cp_rank": dict(B=1, S=2048, Skv=32768, H=28, KV=4, D=128,
                          window=None, softcap=None, q_offset=30720,
                          dtypes=(torch.bfloat16,)),
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
    # the paged path's heads: qwen2-7b's (G=7, D=128), paligemma-3b's
    # (G=8 over one KV head of D=256), codeqwen1.5-7b's (MHA, G=1 at 32
    # heads of D=128, over the 40-block tables of its 640-slot cell) and
    # one rank's of qwen2-7b served at tp=2 (14 heads over 2 KV heads)
    for (model, H, KV, D, NW), S in ((m, S) for m in (
            ("qwen2", 28, 4, 128, 64), ("paligemma", 8, 1, 256, 64),
            ("codeqwen", 32, 32, 128, 40), ("qwen2_tp2", 14, 2, 128, 64))
            for S in (1, 64)):
        tag = f"S{S}" if model == "qwen2" else f"{model}_S{S}"
        args = paged_inputs(8, S, H, KV, D, 16, NW, torch.bfloat16, dev,
                            seed=S, inactive=True)
        got = paged_decode_attention(*args)
        want = paged_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_ATOL, (tag, err)
        errs[f"bf16_{tag}"] = err
        bound_ms, bound_by = bound(args[0], args[1], args[3], args[4])
        timings[tag] = {
            "design": paged_design(S, H // KV, torch.bfloat16),
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
             shape={"B": 8, "S": S, "H": H, "KV": KV, "D": D, "bt": 16,
                    "NW": NW}, max_abs_err=err, atol=BF16_ATOL,
             **timings[tag])
    emit("kernel_check", name="paged_attention", max_abs_err=errs,
         designs=designs, f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    return {"max_abs_err": max(errs.values()), **timings.pop("S1"),
            **timings}


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
    shapes = {"recurrentgemma_L": (RG_DECODE, "recurrentgemma-9b L-layer "
                                   "decode, G=16 at D=256"),
              **{name: (c, f"whisper-base decode, {name.split('_')[1]}-"
                        "attention, G=1 at D=64")
                 for name, c in WHISPER_DECODE.items()}}
    model_shapes = {}
    for name, (c, what) in shapes.items():
        dims = [c[x] for x in ("B", "S", "H", "KV", "D")]
        args = decode_inputs(*dims, c["valid"], torch.float32, dev,
                             seed=c["S"] + 2)
        err = (decode_attention(*args) - decode_attention_plain(*args)
               ).abs().max().item()
        assert err <= F32_ATOL, (name, err)
        errs[f"f32_{name}"] = err
        args = decode_inputs(*dims, c["valid"], torch.bfloat16, dev,
                             seed=c["S"] + 1)
        got = decode_attention(*args)
        want = decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_ATOL, (name, err)
        errs[f"bf16_{name}"] = err
        bound_ms, bound_by = decode_bound(args[0], args[1], args[3])
        t = {"kernel_ms": time_ms(lambda: decode_attention(*args), 50,
                                  flush),
             "plain_ms": time_ms(lambda: decode_attention_plain(*args), 10,
                                 flush),
             "library_ms": time_ms(sdpa_decode_call(*args), 50, flush),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "kernel_host_ms": host_ms(lambda: decode_attention(*args), 50),
             "split_plan": decode_attention_mod._plan(
                 *dims, -1, torch.bfloat16, dev.index or 0)}
        emit("kernel", name="decode_attention", dtype="bfloat16",
             shape={k: c[k] for k in ("B", "S", "H", "KV", "D")}, what=what,
             valid_len=c["valid"], max_abs_err=err, atol=BF16_ATOL, **t)
        model_shapes[name] = t
    emit("kernel_check", name="decode_attention", max_abs_err=errs,
         f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    lse = decode_lse_phase(dev, flush)
    return {"max_abs_err": max(errs.values()), **timings[128],
            "S4096": timings[4096], **model_shapes, "lse": lse}


def decode_lse_phase(dev, flush) -> dict:
    """K2's log-sum-exp output: held to its plain version in f32 and bf16
    at ``LSE_CASES`` (the output with it equal bit for bit to the output
    without it; -inf where a row sees no key), and K2 timed with and
    without it at the PERF shapes' valid lengths. Then the mesh path's
    merge on one card: at ``MERGE_DECODE`` K2 runs on the two halves of
    the keys (each row's valid length clipped to its half) and
    ``merge_partials`` merges them, held to K2 over the whole cache within
    the bf16 bar; the merge, the two halves and the whole call timed."""
    out = {}
    for name, (c, softcap) in LSE_CASES.items():
        dims = [c[x] for x in ("B", "S", "H", "KV", "D")]
        errs = {}
        for dtype, atol in ((torch.float32, F32_ATOL),
                            (torch.bfloat16, BF16_ATOL)):
            args = decode_inputs(*dims, c["valid"], dtype, dev,
                                 seed=300 + c["S"])
            got, lse = decode_attention(*args, softcap=softcap,
                                        return_lse=True)
            alone = decode_attention(*args, softcap=softcap)
            want, want_lse = decode_attention_plain(*args, None, softcap,
                                                    return_lse=True)
            torch.cuda.synchronize()
            assert torch.equal(got, alone), name
            seen = torch.isfinite(want_lse)
            assert torch.equal(torch.isfinite(lse), seen), name
            err = (got.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse)[seen].abs().max().item()
            assert err <= atol and lse_err <= LSE_ATOL, (name, dtype, err,
                                                         lse_err)
            errs[str(dtype).split(".")[-1]] = {"max_abs_err": err,
                                               "lse_max_abs_err": lse_err}
        # timed at the valid lengths the PERF table's K2 times are taken at
        valid = ([80, 128, 1, 96, 33, 64, 127, 5] if name == "S128"
                 else RG_DECODE["valid"] if name == "recurrentgemma_L"
                 else c["valid"])
        args = decode_inputs(*dims, valid, torch.bfloat16, dev,
                             seed=c["S"] + 1)
        t = {"kernel_ms": time_ms(lambda: decode_attention(
                 *args, softcap=softcap), 50, flush),
             "lse_kernel_ms": time_ms(lambda: decode_attention(
                 *args, softcap=softcap, return_lse=True), 50, flush),
             "kernel_ms_again": time_ms(lambda: decode_attention(
                 *args, softcap=softcap), 50, flush)}
        emit("kernel", name="decode_attention_lse", dtype="bfloat16",
             shape={k: c[k] for k in ("B", "S", "H", "KV", "D")},
             softcap=softcap, checked_valid_len=c["valid"],
             timed_valid_len=valid, checks=errs, lse_atol=LSE_ATOL, **t)
        out[name] = {**t, "checks": errs}

    c = MERGE_DECODE
    B, S, H, KV, D = (c[x] for x in ("B", "S", "H", "KV", "D"))
    q, k, v, valid = decode_inputs(B, S, H, KV, D, c["valid"],
                                   torch.bfloat16, dev, seed=32768)
    half = S // 2
    parts = [(q, k[:, r * half:(r + 1) * half].contiguous(),
              v[:, r * half:(r + 1) * half].contiguous(),
              (valid.long() - r * half).clamp(0, half).int())
             for r in range(2)]

    def halves():
        return [decode_attention(*a, return_lse=True) for a in parts]

    res = halves()
    outs = torch.stack([o for o, _ in res])
    lses = torch.stack([lse for _, lse in res])
    merged, merged_lse = merge_partials(outs, lses)
    whole, whole_lse = decode_attention(q, k, v, valid, return_lse=True)
    torch.cuda.synchronize()
    err = (merged.float() - whole.float()).abs().max().item()
    lse_err = (merged_lse - whole_lse).abs().max().item()
    assert err <= BF16_ATOL and lse_err <= LSE_ATOL, (err, lse_err)
    # the merge reads two (B, H, D) bf16 partials and two (B, H) fp32
    # log-sum-exps and writes one of each
    nbytes = 3 * B * H * D * 2 + 3 * B * H * 4
    merge = {"max_abs_err": err, "lse_max_abs_err": lse_err,
             "merge_ms": time_ms(lambda: merge_partials(outs, lses), 50,
                                 flush),
             "merge_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "merge_bound_by": "bytes",
             "halves_ms": time_ms(halves, 20, flush),
             "whole_ms": time_ms(lambda: decode_attention(q, k, v, valid),
                                 20, flush),
             "split_plans": [decode_attention_mod._plan(
                 B, n, H, KV, D, -1, torch.bfloat16, dev.index or 0)
                 for n in (half, S)]}
    emit("decode_merge", what="K2 on the two halves of one qwen2-7b "
         "decode_32k row block's keys, merged by merge_partials, against "
         "K2 over the whole cache", shape={"B": B, "S": S, "H": H,
                                           "KV": KV, "D": D},
         dtype="bfloat16", valid_len=c["valid"], atol=BF16_ATOL,
         lse_atol=LSE_ATOL, **merge)
    out["merge_qwen2_decode_32k"] = merge
    return out


def visible(Sq, Skv, causal=True, window=None, prefix_len=0, q_offset=None):
    """K3's (Sq, Skv) boolean mask, numpy: causal, window, then every key
    below ``prefix_len``; query row i at position ``q_offset + i``."""
    i = (q_offset or 0) + np.arange(Sq)[:, None]
    j = np.arange(Skv)[None, :]
    m = j <= i if causal else np.ones((Sq, Skv), bool)
    if window is not None:
        m = m & (j > i - window)
    if prefix_len:
        m = m | (j < prefix_len)
    return m


def flash_bound(q, k, kw):
    """Least time for K3's forward: the larger of the bytes it must move
    (q, k, v read once, the output and the fp32 lse written once) over
    HBM bandwidth and its operations (2 per multiply-add of QK^T and PV,
    4*D per visible (query, key) pair, counted from this call's mask)
    over the peak for the dtype."""
    B, S, H, D = q.shape
    pairs = int(visible(S, k.shape[1], kw.get("causal", True),
                        kw.get("window"), kw.get("prefix_len", 0),
                        kw.get("q_offset")).sum()) * B * H
    isz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * isz + B * H * S * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * pairs / PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), pairs


def flash_inputs(B, S, H, KV, D, dtype, dev, seed, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(dev, dtype) for s in
            [(B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, D)]]


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


def sdpa_flash_call(q, k, v, kw):
    """The library yardstick for K3 on a layer without softcap: one
    ``scaled_dot_product_attention`` with ``enable_gqa`` and K3's boolean
    mask (``visible``), inputs transposed and the mask built beforehand
    (not timed). Timed only; the port never calls it."""
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = torch.from_numpy(visible(q.shape[1], k.shape[1],
                                    kw.get("causal", True), kw.get("window"),
                                    kw.get("prefix_len", 0),
                                    kw.get("q_offset"))).to(q.device)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)


def flash_kernel_phase(dev) -> dict:
    """K3 against its plain version: f32 on the reference test's cases
    and the smoke heads, f32 and bf16 on the encoder, cross-attention and
    prefix-LM masks (``FLASH_MASK_CASES``), then f32 and bf16 at the
    training shapes, forward (out and lse) and backward through the
    Function, each timed (K3, plain, SDPA where one call computes the
    same function); the bf16 times go to the kernels line."""
    errs = {}
    cases = [(f"case{i}", (B, S, H, KV, D),
              dict(causal=True, window=window, softcap=softcap), None)
             for i, (B, S, H, KV, D, window, softcap)
             in enumerate(FLASH_CASES)]
    cases += [(f"mask_case{i}", (B, Sq, H, KV, D),
               dict(causal=causal, window=window, softcap=softcap,
                    prefix_len=prefix), Skv)
              for i, (B, Sq, Skv, H, KV, D, causal, window, softcap, prefix)
              in enumerate(FLASH_MASK_CASES)]
    cases += [(f"offset_case{i}", (B, Sq, H, KV, D),
               dict(causal=True, window=window, softcap=softcap,
                    prefix_len=prefix, q_offset=off), Skv)
              for i, (B, Sq, Skv, H, KV, D, window, softcap, prefix, off)
              in enumerate(FLASH_OFFSET_CASES)]
    for i, (name, dims, kw, Skv) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(*dims, dtype, dev, seed=i, Skv=Skv)
            got, glse = flash_attention_forward(q, k, v, **kw)
            want, wlse = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            lse_err = (glse - wlse).abs().max().item()
            if dtype == torch.float32:
                assert max(err, lse_err) <= F32_ATOL, (name, err, lse_err)
            else:
                assert err <= BF16_ATOL and lse_err <= 1e-3, (name, err,
                                                              lse_err)
            tag = str(dtype).split(".")[-1]
            errs[f"{tag}_{name}"] = max(err, lse_err)
            g = flash_grads_check(q, k, v, kw)
            assert max(g.values()) <= GRAD_RTOL[dtype], (name, dtype, g)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    timings = {}
    for name, shp in FLASH_SHAPES.items():
        kw = dict(causal=shp.get("causal", True), window=shp["window"],
                  softcap=shp["softcap"], prefix_len=shp.get("prefix_len",
                                                             0))
        if "q_offset" in shp:
            kw["q_offset"] = shp["q_offset"]
        dims = [shp[x] for x in ("B", "S", "H", "KV", "D")]
        for dtype in shp.get("dtypes", (torch.float32, torch.bfloat16)):
            q, k, v = flash_inputs(*dims, dtype, dev, seed=1,
                                   Skv=shp.get("Skv"))
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
            bound_ms, bound_by, pairs = flash_bound(q, k, kw)
            t = {"kernel_ms": time_ms(lambda: flash_attention_forward(
                     q, k, v, **kw), 5, flush),
                 "plain_ms": time_ms(lambda: flash_attention_plain(
                     q, k, v, **kw), 2, flush),
                 "design": flash_design(dtype),
                 "library_ms": (time_ms(sdpa_flash_call(q, k, v, kw), 5,
                                        flush)
                                if shp["softcap"] is None else None),
                 "bound_ms": bound_ms, "bound_by": bound_by}
            emit("kernel", name="flash_attention", dtype=tag,
                 shape={k: v for k, v in shp.items() if k != "dtypes"},
                 visible_pairs=pairs, max_abs_err=err, lse_max_abs_err=
                 lse_err, atol=atol, grad_rel_err=grads,
                 grad_rtol=GRAD_RTOL[dtype], **t)
            if dtype == torch.bfloat16:
                timings[name] = {**t, "max_abs_err": err}
            del q, k, v, got, want, glse, wlse
    emit("kernel_check", name="flash_attention", max_abs_err=errs,
         f32_atol=F32_ATOL, bf16_atol=BF16_ATOL)
    main = timings.pop("recurrentgemma_L")
    return {**main, "max_abs_err": max(errs.values()), **timings}


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
               chunk, max_new, paged, cuda_graphs=None, kv_shard=None):
    probe = ServeEngine(cfg, params, max_slots=1, max_seq=bt,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=bt),
                        pool_blocks=1, prefill_chunk=chunk, paged=paged,
                        device=dev, cuda_graphs=False)
    store = PrefixStore(cap_blocks * probe._block_nbytes(), "lerc",
                        block_tokens=bt)
    del probe
    eng = ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                      store=store, prefill_chunk=chunk, paged=paged,
                      device=dev, cuda_graphs=cuda_graphs, kv_shard=kv_shard)
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


def kernel_table(prof) -> dict:
    """{kernel name: (runs, device ms)} of a finished torch.profiler run,
    CUDA activity (a graph's kernels are recorded as kernels), from one
    pass over its averages (each pass over a full-depth model's trace
    takes seconds of host time)."""
    table = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            runs, ms = table.get(e.key, (0, 0.0))
            table[e.key] = (runs + e.count,
                            ms + e.self_device_time_total / 1e3)
    return table


def traced_kernel(table, kernel) -> tuple:
    """(runs, device ms) of ``kernel``'s device kernel in a
    ``kernel_table``."""
    return (named(kernel, {k: n for k, (n, _) in table.items()}),
            named(kernel, {k: ms for k, (_, ms) in table.items()}))


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
                  steps=32, profiled=8) -> None:
    """8 slots all decoding, captured beside eager: ms a step by host
    clock over ``steps`` steps once the decode signature has been captured
    (the captured engine's first sight and capture of it come before),
    then device busy and idle share of ``profiled`` more under
    torch.profiler, CUDA activity (a graph's kernels are recorded as
    kernels), with the attention kernel's launches in those steps
    (``n_layers`` a step: the wrapper's eagerly, the graph's nodes
    captured), and its runs and device ms in the trace. Both engines must
    have generated the same tokens. (Reading a trace is host time in
    torch.profiler's parse: 32 eager steps of full-depth gemma2-27b took
    33 s to read on an H100 machine, 8 take a quarter of that.)"""
    prompts = shared_prefix_prompts(cfg.vocab, 8, 8, prompt, 0, seed=3)
    kernel = "paged_decode_attention" if paged else "decode_attention"
    out, tokens = {}, []
    for cuda_graphs in (None, False):
        eng = ServeEngine(cfg, params, max_slots=8, max_seq=max_seq,
                          prefill_chunk=chunk, paged=paged, device=dev,
                          cuda_graphs=cuda_graphs)
        reqs = [eng.submit(p, max_new=steps + profiled + 8)
                for p in prompts]
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
            for _ in range(profiled):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        calls = wrapper.launches - calls
        nodes = named(kernel, prog.replayed_kernels) - nodes
        # the profiled steps' launches: the wrapper's eagerly, the
        # graph's nodes captured, where no wrapper is called
        assert calls + nodes == cfg.n_layers * profiled, (kernel, calls,
                                                          nodes)
        assert (calls if prog.capture else nodes) == 0, (calls, nodes)
        table = kernel_table(prof)
        by_name = device_ms_by_kernel(table)
        busy = sum(by_name.values())
        # the trace's own count, below the launches where it lost
        # records: 0 < runs <= launches
        runs, kernel_ms = traced_kernel(table, kernel)
        assert 0 < runs <= cfg.n_layers * profiled, (kernel, runs)
        assert all(r.n_generated < r.max_new for r in reqs)
        tokens.append([eng.drain(r) for r in reqs])
        out["captured" if prog.capture else "eager"] = {
            "ms_per_step": ms, "steps_replayed": prog.replays - replays,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_ms_per_step": busy / profiled,
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
    assert out["captured"]["steps_replayed"] == steps + profiled
    assert tokens[0] == tokens[1]
    emit("steady_decode", config=cfg.arch, paged=paged, slots=8,
         prompt_tokens=prompt, steps=steps, profiled_steps=profiled, **out)


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
    layers, chunk 1) and on qwen2 (chunk 8), the paged plane on the MoE
    configs (moonshot: every layer M; llama4: G and M alternating) and on
    paligemma (text-only decode, MQA)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, paged, chunk, kernel in (
            ("qwen2_7b", True, 8, paged_decode_attention),
            ("gemma2_27b", False, 1, decode_attention),
            ("qwen2_7b", False, 8, decode_attention),
            ("moonshot_v1_16b_a3b", True, 8, paged_decode_attention),
            ("llama4_maverick_400b_a17b", True, 8, paged_decode_attention),
            ("paligemma_3b", True, 8, paged_decode_attention)):
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
    for arch in ("codeqwen1_5_7b", "qwen2_7b"):
        sharded_parity(dev, arch)


def smoke_frontend(cfg, params, dev, n_shards, blk, faults=None):
    """A frontend of smoke shards on the paged plane, 2 slots each, a LERC
    store of 10 blocks split across the shards (byte pressure)."""
    return ShardedFrontend(
        cfg, params, n_shards, max_slots=2, max_seq=64,
        capacity_bytes=10 * blk // n_shards, policy="lerc", block_tokens=8,
        prefill_chunk=8, paged=True, record_eviction_log=True,
        faults=faults, device=dev)


def by_key(requests) -> dict:
    """Tokens keyed by (prompt, arrival): rids are per-shard counters, so
    they collide across shards and across a crash's rebuild."""
    return {(tuple(r.prompt), r.arrival): list(r.generated)
            for r in requests}


def sharded_parity(dev, arch) -> None:
    """The sharded tier's exactness claims on the card, smoke ``arch`` in
    f32: a 2-shard frontend on the card (K1, captured steps) gives the CPU
    frontend's (plain, eager) tokens, per-shard eviction logs, replica
    logs and metrics; on the card K=2 gives K=1's tokens; and a timed
    trace under a crash of shard 0 and a lossy status channel gives the
    clean trace's tokens, keyed by (prompt, arrival), the same on the card
    as on the CPU."""
    cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype=torch.float32)
    prompts = shared_prefix_prompts(cfg.vocab, 12, 4, 24, 8, seed=7)
    blk = ServeEngine(cfg, {}, max_slots=1, max_seq=8,
                      store=PrefixStore(1 << 40, "lerc", block_tokens=8),
                      pool_blocks=1, paged=True,
                      device="cpu")._block_nbytes()
    times = poisson_arrivals(12, 1.5, seed=3)
    trace = [TracedRequest(t=t, prompt=p, max_new=4)
             for t, p in zip(times, prompts)]

    def batch(where, n_shards):
        fe = smoke_frontend(cfg, params, where, n_shards, blk)
        rs = [fe.submit(p, max_new=4)[1] for p in prompts]
        fe.run()
        fe.verify_replicas()
        return fe, rs

    def timed(where, faults):
        fe = smoke_frontend(cfg, params, where, 2, blk, faults)
        report = play_trace(fe, trace)
        if faults is not None:
            assert fe.shard_crashes_fired == 1 and fe.failover_retries >= 1
            assert all(r.finished_at is not None for r in report.requests)
            fe.resync_replicas()
        fe.verify_replicas()
        return fe, by_key(report.requests)

    def observed(fe, rs):
        return ([r.generated for r in rs],
                [e.store.eviction_log for e in fe.shards],
                [tr.eviction_log for tr in fe.trackers], fe.metrics())

    plan = FaultPlan(seed=7, shard_crashes=((5.0, 0),),
                     bus_faults=(BusFault(channel="status", drop_p=0.2),))
    cpu = observed(*batch("cpu", 2))
    (gfe, grs), launches = counted(lambda: batch(dev, 2))
    assert launches["paged_decode_attention"] > 0, launches
    assert all(e.step_program.captures > 0 for e in gfe.shards)
    card = observed(gfe, grs)
    assert sum(len(log) for log in cpu[1]) > 0, "no byte pressure"
    assert card == cpu
    one = observed(*batch(dev, 1))
    assert one[0] == card[0]
    clean = timed(dev, None)[1]
    crashed_fe, crashed = timed(dev, plan)
    assert crashed == clean
    cpu_fe, cpu_crashed = timed("cpu", plan)
    assert cpu_crashed == crashed
    assert crashed_fe.metrics() == cpu_fe.metrics()
    m = crashed_fe.metrics()
    emit("parity", config=f"{arch} smoke f32, ShardedFrontend (2 shards)",
         paged=True, requests=len(prompts), card_equals_cpu=True,
         k2_equals_k1=True, crash_equals_clean=True,
         evictions=card[3]["evictions"],
         effective_hits=card[3]["effective_hits"],
         eviction_reports=card[3]["msg_eviction_reports"],
         crash_run={key: m[key] for key in (
             "shard_crashes", "failover_retries", "msg_dropped",
             "msg_resyncs")},
         kernel_launches=launches)


def serve_phase(dev) -> tuple:
    """The paged path at full width. Returns K1's launches in its run (the
    wrapper's count and the device's) and in the TP run's."""
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

    # serve tensor parallelism at tp=1: a one-rank NCCL group
    tp_ctx = serve_tp_context(1, dev)
    k1_tp = serve_tp_step(cfg, params, dev, prompts, kw, (eng, store, reqs),
                          run, tp_ctx)
    paged_decode_step(cfg, eng, dev)
    del eng, store, reqs
    steady_decode(cfg, params, dev, paged=True, chunk=64, prompt=64,
                  max_seq=kw["max_seq"])
    profile_serve(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 8, 4, 512, 64, seed=2), {**kw, "max_new": 8},
        "8 requests x (512 shared + 64 unique) prompt tokens, 8 new "
        "tokens, 8 slots, chunk 64", "paged_attention", match="paged_")
    tiered_serve(cfg, params, dev, prompts, kw, tp_ctx)
    torch.distributed.destroy_process_group()
    return launches, run["device_launches"], k1_tp


# CUgraphNodeType (cuda.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
              11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_node_types(raw_graph: int) -> dict:
    """{node type: nodes} of a CUDA graph's top level, read with libcuda's
    graph calls."""
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t()
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    out: dict = {}
    for node in map(ctypes.c_void_p, nodes):
        kind = ctypes.c_int()
        assert cu.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
        name = NODE_TYPES.get(kind.value, str(kind.value))
        out[name] = out.get(name, 0) + 1
    return out


def per_capture(prog) -> dict:
    """A step program's captured kernels by name, a capture's worth."""
    return {k: v / prog.captures for k, v in prog.captured_kernels.items()}


def serve_tp_step(cfg, params, dev, prompts, kw, base, base_run, ctx):
    """The qwen2-7b paged cell served on the TP path at tp=1 (``ctx``, a
    one-rank NCCL group; captured steps): its tokens, eviction log and
    ``metrics()`` must equal the phase's engine without TP bit for bit
    (the head slice is all 28 heads, the all-gather a copy), K1 28
    launches a step. Prints both runs' tokens/s and replays, and what a
    TP graph holds beyond the plain one: kernels by name and node types.
    Returns K1's launches, the wrapper's and the device's."""
    tp, tp_run = timed_serve(cfg, params, dev, prompts,
                             "paged_decode_attention", None, cap_blocks=96,
                             kv_shard=ctx, **kw)
    assert_same_run(base, tp)
    eng = tp[0]
    m = eng.metrics()
    assert eng.tp == 1 and m["serve_tp"] == 1, m["serve_tp"]
    assert m["device_kv_bytes"] == m["kv_bytes_global"]
    bprog, tprog = base[0].step_program, eng.step_program
    assert tp_run["device_launches"] == cfg.n_layers * eng.steps
    bk, tk = per_capture(bprog), per_capture(tprog)
    key = next(k for k in tprog._graphs if k in bprog._graphs)
    emit("serve_tp", config="qwen2_7b full width, 28 layers, bf16, random "
         "weights (seed 0), paged plane, tp=1 on a one-rank NCCL group "
         "(serve_tp_context(1)), the qwen2 cell's traffic",
         nvidia_smi=card_line(), identical_to_plain_engine=True,
         tokens_per_s={"plain": base_run["tokens_per_s"],
                       "tp1": tp_run["tokens_per_s"]},
         wall_s={"plain": base_run["wall_s"], "tp1": tp_run["wall_s"]},
         steps_replayed={"plain": base_run["steps_replayed"],
                         "tp1": tp_run["steps_replayed"]},
         captures={"plain": base_run["captures"],
                   "tp1": tp_run["captures"]},
         k1_launches_per_step=tp_run["device_launches"] / eng.steps,
         kernel_launches=tp_run["kernel_launches"],
         device_launches=tp_run["device_launches"],
         graph_kernels_added_per_capture={
             k: v - bk.get(k, 0) for k, v in tk.items()
             if v != bk.get(k, 0)},
         graph_kernels_dropped_per_capture={
             k: v for k, v in bk.items() if k not in tk},
         graph_node_types={"signature": list(key),
                           "plain": graph_node_types(
                               bprog._graphs[key][0].raw_cuda_graph()),
                           "tp1": graph_node_types(
                               tprog._graphs[key][0].raw_cuda_graph())},
         device_kv_bytes=m["device_kv_bytes"],
         kv_bytes_global=m["kv_bytes_global"])
    return [tp_run["kernel_launches"]["paged_decode_attention"],
            tp_run["device_launches"]]


# ---------------------------------------------------------- tiered serve


def tree_nbytes(x) -> int:
    """Bytes of the host arrays in a (nested dict / tuple) tree."""
    if isinstance(x, dict):
        return sum(tree_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(tree_nbytes(v) for v in x)
    return 0 if x is None else x.nbytes


class TransferClock:
    """Host-clock timers around a pool's ``read_rows``/``write_rows``: a
    ``synchronize`` before (the steps queued ahead are not the copy's
    time) and after (the copy and its scatter are). Per direction: calls,
    blocks, bytes and ms."""

    def __init__(self):
        self.stats = {}

    def wrap(self, pool, name, direction):
        fn = getattr(pool, name)

        def timed(idxs, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(idxs, *args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            s = self.stats.setdefault(direction, {
                "calls": 0, "blocks": 0, "bytes": 0, "ms": 0.0})
            s["calls"] += 1
            s["blocks"] += len(idxs)
            s["bytes"] += tree_nbytes(out if name == "read_rows" else args)
            s["ms"] += ms
            return out

        setattr(pool, name, timed)

    def summary(self) -> dict:
        return {d: {**s, "ms_per_block": s["ms"] / max(s["blocks"], 1),
                    "GB_per_s": s["bytes"] / max(s["ms"], 1e-9) / 1e6}
                for d, s in self.stats.items()}


TIER_RUNS = ["e", "a", "b", "c", "d"]
TIER_STORES = {
    "e": "PrefixStore unbounded (never evicts): the oracle for tokens",
    "a": "PrefixStore of 96 blocks: evict and recompute",
    "b": "TieredKVStore, 96 device blocks, lossless host tier of 256 "
         "blocks",
    "c": "TieredKVStore, 96 device blocks, the same host bytes in int8",
    "d": "TieredKVStore, 96 device blocks, lossless host tier of 32 "
         "blocks, disk tier of 512 blocks"}


def tiered_run(name, cfg, params, dev, waves, kw, blk, card,
               kv_shard=None) -> tuple:
    """One run of ``tiered_serve``: the store of ``name``, two waves each
    submitted and run, captured steps; K1 counted as ``timed_serve``
    counts it and each pool's transfers timed. Returns (the run's
    summary, its tokens, its three eviction logs and ``metrics()``)."""
    cap = 96 * blk
    disk_dir = None
    pool_blocks = None
    if name == "e":
        store = PrefixStore(1 << 62, "lerc", block_tokens=kw["bt"])
        pool_blocks = 1024         # never grows: the graphs are never dropped
    elif name == "a":
        store = PrefixStore(cap, "lerc", block_tokens=kw["bt"])
    elif name in ("b", "c"):
        store = TieredKVStore(cap, "lerc", block_tokens=kw["bt"],
                              host_capacity_bytes=256 * blk,
                              kv_quant="int8" if name == "c" else None)
    else:
        disk_dir = tempfile.mkdtemp(prefix="chip-smoke-kv-disk-")
        store = TieredKVStore(cap, "lerc", block_tokens=kw["bt"],
                              host_capacity_bytes=32 * blk,
                              disk_capacity_bytes=512 * blk,
                              disk_dir=disk_dir)
    eng = ServeEngine(cfg, params, max_slots=kw["slots"],
                      max_seq=kw["max_seq"], store=store,
                      prefill_chunk=kw["chunk"], paged=True, device=dev,
                      pool_blocks=pool_blocks, kv_shard=kv_shard)
    clock = TransferClock()
    clock.wrap(eng.pool, "read_rows", "device_to_host")
    clock.wrap(eng.pool, "write_rows", "host_to_device")
    if getattr(store, "host_pool", None) is not None:
        # the host halves: rows stored into and taken from the host tier
        clock.wrap(store.host_pool, "write_rows", "into_host_rows")
        clock.wrap(store.host_pool, "read_rows", "from_host_rows")
    if getattr(store, "disk_pool", None) is not None:
        clock.wrap(store.disk_pool, "write_rows", "host_to_disk")
        clock.wrap(store.disk_pool, "read_rows", "disk_to_host")
    prog = eng.step_program
    for k in COUNTED:
        k.launches = 0
    reqs, per_wave = [], []
    for wave in waves:
        before = eng.metrics()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = [eng.submit(p, max_new=kw["max_new"]) for p in wave]
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = eng.metrics()
        reqs += rs
        per_wave.append({
            "wall_s": wall,
            "tokens_per_s": sum(len(r.generated) for r in rs) / wall,
            **{k: after[k] - before[k] for k in (
                "engine_steps", "prefill_tokens", "prefill_tokens_skipped",
                "evictions", "demotions", "promotions", "tier1_hits",
                "tier2_hits", "disk_demotions", "disk_promotions")}})
    launches = paged_decode_attention.launches
    recorded = named("paged_decode_attention", prog.captured_kernels)
    replayed = named("paged_decode_attention", prog.replayed_kernels)
    eager = launches - recorded
    assert recorded == cfg.n_layers * prog.captures, (recorded, prog.captures)
    assert eager + replayed == cfg.n_layers * eng.steps, \
        (eager, replayed, eng.steps)
    m = eng.metrics()
    hp = getattr(store, "host_pool", None)
    out = {
        "store": TIER_STORES[name], "nvidia_smi": card, "waves": per_wave,
        "engine_steps": eng.steps, "steps_replayed": prog.replays,
        "captures": prog.captures,
        "paged_attention_launches": launches, "graph_nodes": recorded,
        "replayed_launches": replayed, "device_launches": eager + replayed,
        **{k: m.get(k, 0) for k in (
            "prefill_tokens", "prefill_tokens_skipped", "evictions",
            "demotions", "promotions", "tier1_hits", "tier2_hits",
            "disk_demotions", "disk_promotions", "host_evictions",
            "quantized_demotions", "dequantized_promotions",
            "promotion_dispatches", "host_blocks", "host_high_water",
            "disk_blocks", "disk_high_water", "host_block_nbytes")},
        "pinned_host_bytes": (sum(t.numel() for t in hp.pinned)
                              if hp is not None else 0),
        "transfers": clock.summary()}
    tokens = [r.generated for r in reqs]
    detail = {"logs": [getattr(store, log, None) for log in (
        "eviction_log", "host_eviction_log", "disk_eviction_log")],
              "metrics": m}
    eng.close()
    if disk_dir is not None:
        assert not os.listdir(disk_dir), "close() left disk tier files"
        os.rmdir(disk_dir)
    return out, tokens, detail


def tiered_serve(cfg, params, dev, wave1, kw, tp_ctx) -> None:
    """The compressed tier ladder on full-width qwen2-7b: two waves of 16
    requests (wave 1 ``serve_phase``'s prompts; wave 2 the same 4 shared
    prefixes with fresh 64-token suffixes) through five stores: (e) an
    unbounded ``PrefixStore``, (a) one of 96 chain blocks, (b) a
    ``TieredKVStore`` of 96 device blocks over a lossless pinned host
    tier of 256 blocks, (c) the same host bytes in int8, (d) a lossless
    host tier of 32 blocks over a disk tier of 512. (b) and (d) must
    demote and promote, take (e)'s engine steps and generate (e)'s
    tokens, and prefill fewer tokens in wave 2 than (a); (c)'s agreement
    with (b) is printed. Then (c) again on the TP path at tp=1
    (``tp_ctx``), its int8 scales' amax all-reduced over the one-rank
    group: tokens, the three eviction logs and ``metrics()`` equal to
    (c)'s."""
    rng = np.random.default_rng(3)
    wave2 = [wave1[i % 4][:512] + list(rng.integers(0, cfg.vocab, 64))
             for i in range(16)]
    probe = ServeEngine(cfg, params, max_slots=1, max_seq=kw["bt"],
                        store=PrefixStore(1 << 40, "lerc",
                                          block_tokens=kw["bt"]),
                        pool_blocks=1, paged=True, device=dev,
                        cuda_graphs=False)
    blk = probe.pool.block_nbytes
    del probe
    card = card_line()
    runs, tokens, detail = {}, {}, {}
    for name in TIER_RUNS:
        runs[name], tokens[name], detail[name] = tiered_run(
            name, cfg, params, dev, (wave1, wave2), kw, blk, card)
        emit("tiered_serve_run", run=name, **runs[name])
        gc.collect()
    tp_run, tp_tokens, tp_detail = tiered_run(
        "c", cfg, params, dev, (wave1, wave2), kw, blk, card,
        kv_shard=tp_ctx)
    assert tp_tokens == tokens["c"]
    assert tp_detail == detail["c"], "the TP int8 tier parted from (c)"
    emit("tiered_serve_run", run="c_tp1", identical_to_c=True, **tp_run)
    gc.collect()
    for name in ("b", "d"):
        r = runs[name]
        assert r["demotions"] > 0 and r["promotions"] > 0 \
            and r["tier1_hits"] > 0, (name, r)
        assert r["engine_steps"] == runs["e"]["engine_steps"], \
            (name, r["engine_steps"], runs["e"]["engine_steps"])
        assert tokens[name] == tokens["e"], name
        assert r["waves"][1]["prefill_tokens"] \
            < runs["a"]["waves"][1]["prefill_tokens"], name
    assert runs["d"]["disk_demotions"] > 0 \
        and runs["d"]["disk_promotions"] > 0, runs["d"]
    assert runs["c"]["dequantized_promotions"] > 0, runs["c"]
    for name in ("b", "c", "d"):
        assert runs[name]["captures"] <= runs["a"]["captures"], \
            (name, runs[name]["captures"], runs["a"]["captures"])

    def agree(a, b):
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n / max(len(a), 1)

    emit("tiered_serve", config="qwen2_7b full width, 28 layers, bf16, "
         "random weights (seed 0), paged plane, bt=16, 8 slots, max_seq "
         "640, chunk 64, 32 new tokens, 2 waves x 16 requests",
         nvidia_smi=card, chain_block_bytes=blk,
         int8_block_bytes=runs["c"]["host_block_nbytes"],
         device_store_blocks=96, tokens_identical_b_d_e=True,
         steps_equal_b_d_e=runs["e"]["engine_steps"],
         wave2_prefill_tokens={n: runs[n]["waves"][1]["prefill_tokens"]
                               for n in TIER_RUNS},
         captures={n: runs[n]["captures"] for n in TIER_RUNS},
         int8_mean_leading_agreement_with_b=sum(
             agree(c, b) for c, b in zip(tokens["c"], tokens["b"]))
         / len(tokens["b"]))


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


def device_ms_by_kernel(table) -> dict:
    """{kernel name: device ms} of a ``kernel_table``."""
    return {k: ms for k, (_, ms) in table.items()}


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
    by_name = device_ms_by_kernel(kernel_table(prof))
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


# ------------------------------------------------------ recurrent decode


def greedy_decode(cfg, params, dev, prompt, new, max_seq):
    """``decode_step`` one token a step with a scalar position: the (B, P)
    ``prompt`` (a host tensor) fed a column a step, then ``new`` greedy
    tokens. Returns (every step's logits, fp32 (B, P + new, V) on the
    host; the greedy tokens (B, new); the cache; prompt and greedy ms a
    step)."""
    B, P = prompt.shape
    prompt = prompt.to(dev)
    cache = init_decode_cache(cfg, B, max_seq, device=dev)
    logits, toks = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(P):
            lg, _ = decode_step(cfg, params, cache, prompt[:, pos:pos + 1],
                                pos)
            logits.append(lg[:, -1].float())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(new):
            tok = logits[-1].argmax(-1, keepdim=True).int()
            toks.append(tok)
            lg, _ = decode_step(cfg, params, cache, tok, P + i)
            logits.append(lg[:, -1].float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (torch.stack(logits, 1).cpu(), torch.cat(toks, 1).cpu(), cache,
            (t1 - t0) * 1e3 / P, (t2 - t1) * 1e3 / max(new, 1))


def recurrent_decode_phase(dev) -> int:
    """R and W layers decoding through ``decode_step`` at full width and
    depth: recurrentgemma-9b (38 layers: every L layer's attention a K2
    launch, 12 a step) and rwkv6-3b (32 W layers, no kernel: the W step is
    the reference's plain update), bf16, seeded random weights, B=8, a
    64-token prompt a token a step, then 32 greedy tokens; recurrentgemma's
    wrapped-window step held per layer to the plain version; then both
    smoke configs in f32 on the card against the CPU and against the
    card's own forward. Returns K2's launches in recurrentgemma's run."""
    B, P, new = 8, 64, 32
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 65_536, (B, P)).astype(np.int32))
    k2 = 0
    for arch, max_seq, expect in (("recurrentgemma_9b", 4096,
                                   {"decode_attention": 12}),
                                  ("rwkv6_3b", 128, {})):
        cfg = configs.get(arch)
        t0 = time.time()
        params = init_params(model_spec(cfg), torch.Generator(
            device=dev).manual_seed(0), dev, dtype=cfg.dtype)
        torch.cuda.synchronize()
        init_s = time.time() - t0
        greedy_decode(cfg, params, dev, prompt[:, :2], 1, max_seq)  # warm-up
        (logits, toks, cache, prompt_ms, greedy_ms), counts = counted(
            lambda: greedy_decode(cfg, params, dev, prompt, new, max_seq))
        steps = P + new
        for name, n in counts.items():
            assert n == expect.get(name, 0) * steps, (arch, counts)
        assert torch.isfinite(logits).all()
        assert ((0 <= toks) & (toks < cfg.vocab)).all()
        dtypes = {"/".join(path): str(t.dtype).split(".")[-1]
                  for path, t in tree_paths(cache)
                  if path[0] in ("stack", "tail_0_R")}
        # where a step's time goes: 9 steps under torch.profiler
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            greedy_decode(cfg, params, dev, prompt[:, :1], 8, max_seq)
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = device_ms_by_kernel(kernel_table(prof))
        busy = sum(by_name.values())
        for path, t in tree_paths(cache):
            want = (torch.float32 if path[-1] in ("S", "h")
                    else torch.bfloat16)
            assert t.dtype == want, (path, t.dtype)
        emit("recurrent_decode", config=f"{arch} full width and depth, "
             f"{cfg.n_layers} layers ({cfg.layer_pattern}), bf16, random "
             "weights (seed 0)", batch=B, prompt_tokens=P, new_tokens=new,
             init_s=init_s, prompt_ms_per_step=prompt_ms,
             greedy_ms_per_step=greedy_ms,
             tokens_per_s=B * 1e3 / greedy_ms, kernel_launches=counts,
             expected_launches_per_step=expect, cache_dtypes=dtypes,
             first_tokens=toks[:2, :8].tolist(), profiled_steps=9,
             profiled_wall_ms=wall_ms, device_busy_ms=busy,
             device_idle_share=(1 - busy / wall_ms if busy else
                                "not measured: the profiler recorded no "
                                "device activity"),
             gemm_ms=sum(t for n, t in by_name.items()
                         if any(g in n.lower() for g in GEMM_NAMES)),
             top_kernels=[[n[:80], t] for n, t in sorted(
                 by_name.items(), key=lambda kv: -kv[1])[:5]])
        if arch == "recurrentgemma_9b":
            k2 = counts["decode_attention"]
            recurrent_wrapped_step(cfg, params, dev)
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
    recurrent_parity(dev)
    return k2


def recurrent_wrapped_step(cfg, params, dev) -> None:
    """One recurrentgemma-9b decode step at pos 2100, past its 2048-slot
    window (every L layer writes slot 52 and sees all 2048), from a cache
    of seeded values, B=8: each L layer's K2 output against its plain
    version on the same inputs (the plain output carried on), within one
    bf16 ulp of the layer's scale; then the whole step through K2 and
    through the plain version: finite logits, their distance and argmax
    agreement printed."""
    B, pos = 8, 2100
    cache = init_decode_cache(cfg, B, 4096, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for _, t in tree_paths(cache):
        t.normal_(generator=g)
    toks = torch.randint(0, cfg.vocab, (B, 1), generator=g, device=dev,
                         dtype=torch.int32)
    layer_errs = []

    def kernel_and_plain(q, k, v, valid, softcap=None):
        assert k.shape[1] == cfg.window and (valid == cfg.window).all()
        want = decode_attention_plain(q, k, v, valid, None, softcap)
        got = decode_attention(q, k, v, valid, softcap=softcap)
        layer_errs.append(((got.float() - want.float()).abs().max().item(),
                           want.float().abs().max().item()))
        return want

    def step(impl, attend=None):
        c = tree_map(torch.clone, cache)
        wrapper = model_layers.decode_attention
        if attend is not None:
            model_layers.decode_attention = attend
        try:
            with torch.no_grad():
                out, _ = decode_step(cfg.replace(decode_kernel=impl), params,
                                     c, toks, pos)
        finally:
            model_layers.decode_attention = wrapper
        torch.cuda.synchronize()
        return out[:, 0].float()

    step("flash", attend=kernel_and_plain)
    assert len(layer_errs) == 12, layer_errs       # one L layer a unit
    worst = max(e / s for e, s in layer_errs)
    assert worst <= 2 ** -7, layer_errs            # one bf16 ulp
    plain, kern = step("xla"), step("flash")
    assert torch.isfinite(kern).all() and torch.isfinite(plain).all()
    emit("decode_step", what=f"recurrentgemma-9b decode_step, "
         f"{cfg.n_layers} layers, plain version vs K2, bf16, B=8, pos "
         f"{pos} (window {cfg.window} wrapped)",
         per_layer_max_err_over_scale=worst,
         per_layer_errs=[[e, sc] for e, sc in layer_errs],
         max_abs_err=(kern - plain).abs().max().item(),
         logits_scale=plain.abs().max().item(),
         argmax_agreement=(kern.argmax(-1) == plain.argmax(-1))
         .float().mean().item())


def recurrent_parity(dev) -> None:
    """The recurrentgemma and rwkv6 smoke configs in f32, 4 prompt tokens
    and 12 greedy ones through ``decode_step`` on the card (K2 for the L
    layers) and on the CPU from the same weights: identical tokens, logits
    within ``LOGITS_RTOL`` of their scale; and the card's incremental
    logits against its own ``forward`` on the same tokens, within the
    reference's ``test_decode_matches_forward`` bar (0.15)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in ("recurrentgemma_9b", "rwkv6_3b"):
        cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
        params = init_params(model_spec(cfg),
                             torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 4)).astype(np.int32))
        cpu = greedy_decode(cfg, params, "cpu", prompt, 12, 32)
        card_params = tree_map(lambda t: t.to(dev), params)
        card, counts = counted(lambda: greedy_decode(
            cfg, card_params, dev, prompt, 12, 32))
        if "L" in cfg.layer_pattern:
            assert counts["decode_attention"] > 0, counts
        assert torch.equal(card[1], cpu[1]), (card[1], cpu[1])
        err = (card[0] - cpu[0]).abs().max().item()
        scale = cpu[0].abs().max().item()
        assert err <= LOGITS_RTOL * scale, (arch, err, scale)
        fed = torch.cat([prompt, card[1]], 1).to(dev)
        with torch.no_grad():
            full = forward(cfg, card_params, {"tokens": fed}).float().cpu()
        inc_err = (full - card[0]).abs().max().item()
        assert inc_err < 0.15, (arch, inc_err)
        emit("recurrent_parity", config=f"{arch} smoke f32", new_tokens=12,
             tokens_identical=True, max_abs_err=err, logits_scale=scale,
             rtol=LOGITS_RTOL, incremental_vs_forward_max_abs_err=inc_err,
             kernel_launches=counts)


# ------------------------------------------------------------ MoE serve


def moe_layer_timings(cfg, params, dev) -> dict:
    """The first M layer's MoE alone, bf16, at the serve path's token
    counts (8: steady decode; 512: a prefill chunk of 64 in 8 slots):
    device ms of the router (fp32 product, softmax, stable sort), the
    expert products (every expert on every token, the reference's
    single-device design), the one-hot combine, the shared experts, and the
    whole layer, beside the bytes bound of its weights and, at 512 tokens,
    the operations bound."""
    prm = {k: v[0] for k, v in params["stack"]["0_M"]["moe"].items()}
    E, d = cfg.n_experts, cfg.d_model
    wbytes = sum(t.numel() * t.element_size() for t in prm.values())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"weight_bytes": wbytes}
    for T in (8, 512):
        x = torch.randn((T, d), generator=torch.Generator(
            device=dev).manual_seed(T), device=dev).to(cfg.dtype)
        topw, topi = model_moe._route(cfg, prm["router"], x)
        wi = prm["wi"]

        def experts():
            h = torch.matmul(x, wi.reshape(E, d, -1)).reshape(
                E, T, wi.shape[2], wi.shape[3])
            return torch.bmm(model_moe._act(cfg, h), prm["wo"])
        y = experts()

        def combine():
            onehot = (topi[..., None] == torch.arange(E, device=dev)).to(
                x.dtype)
            w = torch.einsum("tk,tke->te", topw.to(x.dtype), onehot)
            return torch.einsum("etd,te->td", y, w)
        flops = 2 * T * sum(t.numel() for n, t in prm.items()
                            if n != "router")
        out[f"T{T}"] = {
            "route_ms": time_ms(lambda: model_moe._route(
                cfg, prm["router"], x), 20, flush),
            "experts_ms": time_ms(experts, 20, flush),
            "onehot_combine_ms": time_ms(combine, 20, flush),
            "shared_ms": time_ms(lambda: model_moe._shared(cfg, prm, x), 20,
                                 flush),
            "layer_ms": time_ms(lambda: model_moe._moe_local(cfg, prm, x),
                                20, flush),
            "bytes_bound_ms": wbytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": flops / PEAK_OPS_PER_S[cfg.dtype] * 1e3}
    return out


def paged_cell(cfg, dev, config) -> tuple:
    """``cfg`` at full width on the paged plane under the qwen2 paged
    cell's traffic (16 requests, 4 families of 512 shared + 64 unique
    prompt tokens, 32 new tokens, 8 slots, chunk 64, bt 16, a LERC store
    of 96 chain blocks), captured and eager (identical tokens, eviction
    log and metrics), then ``steady_decode`` and a profiled run. Returns
    (params, K1's launches in the captured run: the wrapper's and the
    device's)."""
    t0 = time.time()
    params = init_params(model_spec(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_paths(params))
    kw = dict(bt=16, slots=8, max_seq=640, chunk=64, max_new=32, paged=True)
    run_engine(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 2, 1, 64, 16, seed=1), cap_blocks=96,
        **{**kw, "max_new": 2})                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    prompts = shared_prefix_prompts(cfg.vocab, 16, 4, 512, 64, seed=0)
    (eng, store, reqs), run = timed_serve(
        cfg, params, dev, prompts, "paged_decode_attention", None,
        cap_blocks=96, **kw)
    peak = torch.cuda.max_memory_allocated(dev)
    eager, eager_run = timed_serve(
        cfg, params, dev, prompts, "paged_decode_attention", False,
        cap_blocks=96, **kw)
    assert_same_run((eng, store, reqs), eager)
    del eager
    m = eng.metrics()
    tokens = [t for r in reqs for t in r.generated]
    assert m["evictions"] > 0 and m["effective_hits"] > 0, m
    assert len(tokens) == 16 * kw["max_new"]
    assert all(0 <= t < cfg.vocab for t in tokens)
    emit("serve", config=config, requests=len(prompts),
         engine_steps=eng.steps, kernel_launches=run["kernel_launches"],
         generated_tokens=len(tokens), tokens_per_s=len(tokens)
         / run["wall_s"], wall_s=run["wall_s"], init_s=init_s,
         param_bytes=param_bytes, block_nbytes=eng.pool.block_nbytes,
         store_capacity=store.capacity,
         evictions=m["evictions"], effective_hits=m["effective_hits"],
         hits=m["hits"], accesses=m["accesses"],
         prefill_tokens=m["prefill_tokens"],
         prefill_tokens_skipped=m["prefill_tokens_skipped"],
         max_memory_allocated=peak, captured=run, eager=eager_run,
         eager_identical=True)
    del eng, store, reqs
    steady_decode(cfg, params, dev, paged=True, chunk=64, prompt=64,
                  max_seq=kw["max_seq"])
    profile_serve(cfg, params, dev, shared_prefix_prompts(
        cfg.vocab, 8, 4, 512, 64, seed=2), {**kw, "max_new": 8},
        "8 requests x (512 shared + 64 unique) prompt tokens, 8 new "
        "tokens, 8 slots, chunk 64", "paged_attention", match="paged_")
    return params, (run["kernel_launches"]["paged_decode_attention"],
                    run["device_launches"])


def moe_serve_phase(dev) -> dict:
    """M layers on the paged plane at full width: moonshot-v1-16b-a3b (48
    M layers, 57.1 GB) under the qwen2 paged cell's traffic
    (``paged_cell``) and the MoE layer's timings; then llama4-maverick's
    GM unit (2 layers at full width). Returns K1's launches in each run:
    the wrappers' and the device's."""
    cfg = configs.get("moonshot_v1_16b_a3b")           # full width, bf16
    params, moonshot = paged_cell(
        cfg, dev, "moonshot_v1_16b_a3b full width and depth, 48 M layers "
        "(64 experts top-6 + 2 shared), bf16, random weights (seed 0), "
        "paged plane")
    launches = {"moonshot": moonshot}
    emit("moe_layer", config=cfg.arch, **moe_layer_timings(cfg, params, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg = configs.get("llama4_maverick_400b_a17b").replace(n_layers=2)
    t0 = time.time()
    params = init_params(model_spec(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_paths(params))
    kw = dict(bt=16, slots=4, max_seq=128, chunk=64, max_new=16, paged=True)
    prompts = shared_prefix_prompts(cfg.vocab, 4, 2, 48, 16, seed=0)
    run_engine(cfg, params, dev, prompts[:1], cap_blocks=64,
               **{**kw, "max_new": 2})                 # warm-up
    (eng, store, reqs), run = timed_serve(
        cfg, params, dev, prompts, "paged_decode_attention", None,
        cap_blocks=64, **kw)
    eager, eager_run = timed_serve(
        cfg, params, dev, prompts, "paged_decode_attention", False,
        cap_blocks=64, **kw)
    assert_same_run((eng, store, reqs), eager)
    tokens = [t for r in reqs for t in r.generated]
    assert len(tokens) == 4 * kw["max_new"]
    assert all(0 <= t < cfg.vocab for t in tokens)
    emit("serve", config="llama4_maverick_400b_a17b full width, 2 of 48 "
         "layers (one GM unit: G with dense d_ff 16384, M with 128 experts "
         "top-1 + 1 shared), bf16, random weights (seed 0), paged plane",
         requests=len(prompts), engine_steps=eng.steps,
         kernel_launches=run["kernel_launches"],
         generated_tokens=len(tokens),
         tokens_per_s=len(tokens) / run["wall_s"], wall_s=run["wall_s"],
         init_s=init_s, param_bytes=param_bytes, captured=run,
         eager=eager_run, eager_identical=True)
    launches["llama4_GM"] = (run["kernel_launches"]["paged_decode_attention"],
                             run["device_launches"])
    del eng, store, reqs, eager, params
    return launches


# ---------------------------------------------------------- legacy serve


def first_difference(a, b):
    """(index, a's entry, b's entry) where two sequences first differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return min(len(a), len(b)), a[len(b):len(b) + 1], b[len(a):len(a) + 1]


def legacy_serve_phase(dev) -> int:
    """The frozen token-at-a-time baseline beside the gather engine at
    chunk 1: full-width qwen2-7b cut to 4 layers, bf16, seeded random
    weights, 8 requests (64 shared + 16 unique tokens, 2 families), 16 new
    tokens, 2 slots, under the same store of 8 blocks (the working set is
    16). ``LegacyServeEngine`` (eager, host KV round-trips) and
    ``ServeEngine(paged=False, prefill_chunk=1)`` (captured) must give the
    same tokens, eviction log and steps, with 4 K2 launches a step in each.
    Returns K2's launches in the legacy run."""
    cfg = configs.get("qwen2_7b").replace(n_layers=4)
    params = init_params(model_spec(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, dtype=cfg.dtype)
    kw = dict(bt=16, slots=2, max_seq=128, chunk=1, max_new=16, paged=False)
    prompts = shared_prefix_prompts(cfg.vocab, 8, 2, 64, 16, seed=0)
    probe = ServeEngine(cfg, params, max_slots=1, max_seq=16,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=16),
                        pool_blocks=1, paged=False, device=dev,
                        cuda_graphs=False)
    cap = 8 * probe._block_nbytes()
    del probe

    def legacy_run(prompts, max_new):
        eng = LegacyServeEngine(cfg, params, max_slots=2, max_seq=128,
                                store=PrefixStore(cap, "lerc",
                                                  block_tokens=16),
                                device=dev)
        reqs = [eng.submit(p, max_new=max_new) for p in prompts]
        t0 = time.time()
        eng.run()
        torch.cuda.synchronize()
        return eng, reqs, time.time() - t0
    legacy_run(prompts[:1], 2)                         # warm-up
    (leg, lreqs, lwall), counts = counted(lambda: legacy_run(prompts, 16))
    assert counts["decode_attention"] == cfg.n_layers * leg.steps, \
        (counts, leg.steps)
    (eng, store, reqs), run = timed_serve(
        cfg, params, dev, prompts, "decode_attention", None, cap_blocks=8,
        **kw)
    assert store.capacity == leg.store.capacity
    gen, lgen = [r.generated for r in reqs], [r.generated for r in lreqs]
    same = {"tokens": gen == lgen,
            "eviction_log": store.eviction_log == leg.store.eviction_log,
            "steps": eng.steps == leg.steps}
    emit("legacy_serve", config="qwen2_7b full width, 4 of 28 layers, bf16, "
         "random weights (seed 0)", requests=len(prompts), slots=2,
         legacy={"wall_s": lwall, "engine_steps": leg.steps,
                 "tokens_per_s": sum(map(len, lgen)) / lwall,
                 "decode_attention_launches": counts["decode_attention"],
                 "evictions": leg.store.evictions,
                 "prefill_tokens_skipped": leg.prefill_tokens_skipped},
         gather_engine={"wall_s": run["wall_s"], "engine_steps": eng.steps,
                        "tokens_per_s": run["tokens_per_s"],
                        "decode_attention_launches": run["device_launches"],
                        "steps_replayed": run["steps_replayed"],
                        "evictions": store.evictions,
                        "prefill_tokens_skipped": eng.prefill_tokens_skipped},
         identical=same,
         first_token_difference=None if same["tokens"] else first_difference(
             [t for g in gen for t in g], [t for g in lgen for t in g]),
         first_eviction_difference=None if same["eviction_log"] else
         first_difference(store.eviction_log, leg.store.eviction_log))
    assert leg.store.evictions > 0
    assert all(same.values()), same
    return counts["decode_attention"]


# --------------------------------------------------------------- train


def smoke_train(cfg, params, dev, batches, oc, compress=False):
    """Losses of ``len(batches)`` train steps from a copy of ``params``
    on ``dev`` (with ``compress``, through cross-pod gradient
    compression)."""
    params = tree_map(lambda t: t.to(dev).clone(), params)
    state = {"params": params, "opt": adamw_init(params)}
    if compress:
        state["ef"] = ef_init(params)
    step = build_train_step(cfg, TrainConfig(opt=oc,
                                             compress_pod_grads=compress))
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
    plain versions); losses within ``TRAIN_LOSS_RTOL`` relative. qwen2
    also with cross-pod gradient compression."""
    oc = OptConfig(total_steps=3, warmup_steps=1)
    for arch, compress in (("qwen2_7b", False), ("qwen2_7b", True),
                           ("gemma2_27b", False),
                           ("recurrentgemma_9b", False),
                           ("rwkv6_3b", False)):
        cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
        params = init_params(model_spec(cfg),
                             torch.Generator().manual_seed(0), "cpu",
                             dtype=torch.float32)
        loader = TrainLoader(LoaderConfig(global_batch=2, seq_len=64,
                                          vocab=cfg.vocab, seed=0))
        batches = [loader.build_batch(i) for i in range(3)]
        cpu = smoke_train(cfg, params, "cpu", batches, oc, compress)
        card, launches = counted(
            lambda: smoke_train(cfg, params, dev, batches, oc, compress))
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
             compress_pod_grads=compress,
             seq_len=64, batch=2, losses_card=card, losses_cpu=cpu,
             max_rel_diff=rel, rtol=TRAIN_LOSS_RTOL,
             kernel_launches=launches)


def train_steps(cfg, dev, expect, config, batches=None):
    """4 AdamW steps of ``cfg`` (bf16, seeded random weights) through
    ``build_train_step``, every launch counted, at batch 2 x 4096 from
    ``TrainLoader`` or on the first four of ``batches`` (five, on the
    card); ``expect`` holds each kernel's launches a step by the layout.
    ``tokens_per_s`` counts the tokens that carry loss; beside it
    ``positions_per_s`` counts every position the model runs (an image
    prefix's patches, an encoder's frames, the text). Returns (step_fn,
    state, a fifth batch, the run's launches)."""
    tc = TrainConfig(opt=OptConfig(total_steps=4, warmup_steps=1))
    n_steps = 4
    t0 = time.time()
    state = make_train_state(cfg, tc, torch.Generator(
        device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for _, t in tree_paths(state["params"]))
    if batches is None:
        loader = TrainLoader(LoaderConfig(global_batch=2, seq_len=4096,
                                          vocab=cfg.vocab, seed=0))
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in loader.build_batch(i).items()}
                   for i in range(n_steps + 1)]
    B, S = batches[0]["tokens"].shape
    extra = sum(batches[0][k].shape[1] for k in ("patches", "frames")
                if k in batches[0])
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
                "positions_per_s": B * (S + extra) / ms * 1e3,
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
         seq_len=S, frontend_positions=extra, steps=steps,
         kernel_launches=counts,
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


def train_compressed_phase(dev) -> None:
    """rwkv6-3b at full width cut to 4 layers (bf16, seeded random
    weights, batch 2 x 4096 from ``TrainLoader``): 4 AdamW steps from the
    same fresh state without and with ``compress_pod_grads`` (every
    gradient through the int8 round trip with error feedback before
    AdamW): step ms, losses (the first, taken before any update, equal),
    the residuals' norm and largest magnitude, K4 launches (8 a step)."""
    cfg = configs.get("rwkv6_3b").replace(n_layers=4)
    loader = TrainLoader(LoaderConfig(global_batch=2, seq_len=4096,
                                      vocab=cfg.vocab, seed=0))
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in loader.build_batch(i).items()}
               for i in range(4)]
    runs = {}
    for compress in (False, True):
        tc = TrainConfig(opt=OptConfig(total_steps=4, warmup_steps=1),
                         compress_pod_grads=compress)
        state = make_train_state(cfg, tc, torch.Generator(
            device=dev).manual_seed(0), dev)
        step_fn = build_train_step(cfg, tc)
        ms, losses = [], []

        def go():
            nonlocal state
            for b in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, m = step_fn(state, b)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                losses.append(m["loss"].item())
        _, launches = counted(go)
        assert launches["rwkv6_wkv"] == 2 * cfg.n_layers * len(batches), \
            launches
        assert all(math.isfinite(x) for x in losses), losses
        run = {"step_ms": ms, "losses": losses,
               "kernel_launches": {k: v for k, v in launches.items() if v}}
        if compress:
            ef = [t.float() for _, t in tree_paths(state["ef"])]
            run["ef_norm"] = math.sqrt(sum((t * t).sum().item()
                                           for t in ef))
            run["ef_max_abs"] = max(t.abs().max().item() for t in ef)
            assert math.isfinite(run["ef_norm"]) and run["ef_norm"] > 0
        runs["compressed" if compress else "plain"] = run
        del state
        gc.collect()
        torch.cuda.empty_cache()
    assert runs["compressed"]["losses"][0] == runs["plain"]["losses"][0]
    emit("train_compressed", config="rwkv6_3b full width cut to 4 layers, "
         "bf16, random weights (seed 0), batch 2 x 4096 (TrainLoader)",
         nvidia_smi=card_line(), steps=len(batches), **runs,
         compression_ratio_bf16=compression_ratio(torch.bfloat16))


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


def profile_train(cfg, step_fn, state, batch, depth, kernels,
                  run="one train step, batch 2 x 4096") -> None:
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
    by_name = device_ms_by_kernel(kernel_table(prof))
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
    emit("profile", config=f"{cfg.arch} {depth}", run=run,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms, **per_kernel,
         gemm_ms=gemm_ms, gemm_share=gemm_ms / busy_ms,
         top_kernels=[[n[:80], t] for n, t in top])


# --------------------------------------- encoder-decoder and image prefix


# paligemma-3b's chain block: 16 tokens x 18 layers x (k, v) x 1 KV head
# x 256 x 2 bytes
PALIGEMMA_BLOCK_BYTES = 16 * 18 * 2 * 256 * 2
# a full-depth bf16 loss, kernel route vs plain route, at 2 layers:
# relative to the loss (beside it, the control: the plain route with one
# attention output of its first layer nudged one ulp)
TRAIN_LOSS_BF16_RTOL = 1e-2


def vlm_serve_phase(dev) -> tuple:
    """The image-prefix family on the paged plane: paligemma-3b at full
    width and depth (18 layers, MQA with one KV head of 256, vocab
    257,216; text-only decode, as the reference engine serves it) under
    the qwen2 paged cell's traffic (``paged_cell``). Returns K1's
    launches in the captured run: the wrapper's and the device's."""
    cfg = configs.get("paligemma_3b")
    probe = ServeEngine(cfg, {}, max_slots=1, max_seq=16,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=16),
                        pool_blocks=1, paged=True, device=dev,
                        cuda_graphs=False)
    assert probe.pool.block_nbytes == PALIGEMMA_BLOCK_BYTES, \
        probe.pool.block_nbytes
    del probe
    params, launches = paged_cell(
        cfg, dev, "paligemma_3b full width and depth, 18 G layers (8 heads, "
        "MQA, d_head 256, d_ff 16384, vocab 257216), bf16, random weights "
        "(seed 0), paged plane, text-only decode")
    del params
    return launches


# ---------------------------------------------------------- sharded serve

CODEQWEN_PARAMS = 8_190_038_016                  # the reference's param_count
CODEQWEN_BLOCK_BYTES = 16 * 32 * 2 * 32 * 128 * 2  # bt x layers x k,v x KV x D
SHARDS = 2
SHARD_KW = dict(max_slots=8, max_seq=640, policy="lerc", block_tokens=16,
                prefill_chunk=64, paged=True, record_eviction_log=True)
STORE_BLOCKS = 96                               # split across the shards


def codeqwen_frontend(cfg, params, dev, cuda_graphs=None, faults=None):
    """The cell's frontend: 2 shards of 8 slots, chunk 64, block 16, the
    96-block LERC store split as the launcher splits ``--cache-kb``."""
    return ShardedFrontend(
        cfg, params, SHARDS,
        capacity_bytes=STORE_BLOCKS * CODEQWEN_BLOCK_BYTES // SHARDS,
        faults=faults, device=dev, cuda_graphs=cuda_graphs, **SHARD_KW)


def count_messages(bus) -> dict:
    """{message kind: messages sent} on ``bus`` from now on (dropped ones
    included: the bus drops after it counts)."""
    kinds, send = {}, bus.send

    def counting(msg):
        kinds[msg.kind] = kinds.get(msg.kind, 0) + 1
        send(msg)

    bus.send = counting
    return kinds


def assert_shared_weights(fe, params) -> None:
    """Every shard's engine and step program serve from the caller's
    tensors: the same storage, one copy of the weights on the card."""
    want = [t.data_ptr() for _, t in tree_paths(params)]
    assert [t.data_ptr() for _, t in tree_paths(fe._params)] == want
    for eng in fe.shards:
        for tree in (eng.params, eng.step_program.params):
            assert [t.data_ptr() for _, t in tree_paths(tree)] == want


def program_tally(eng, kernel="paged_decode_attention") -> dict:
    """A shard's steps and its step program's captures and replays, with
    ``kernel``'s launches recorded into its graphs and replayed from them."""
    prog = eng.step_program
    return {"engine_steps": eng.steps, "captures": prog.captures,
            "steps_replayed": prog.replays,
            "graph_nodes": named(kernel, prog.captured_kernels),
            "replayed_launches": named(kernel, prog.replayed_kernels)}


def frontend_launches(cfg, tallies, counts, kernel="paged_decode_attention"):
    """K1's launches over a frontend run's engines (a crashed shard's
    included): each graph holds ``n_layers`` of them and each replay
    launches them all, 32 a step on each shard; the wrapper counts the
    eager steps' launches and one a capture. Returns (the wrapper's count,
    the device's: eager plus replayed)."""
    for t in tallies:
        assert t["graph_nodes"] == cfg.n_layers * t["captures"], t
        assert t["replayed_launches"] == cfg.n_layers * t["steps_replayed"], t
    eager = counts[kernel] - sum(t["graph_nodes"] for t in tallies)
    steps = sum(t["engine_steps"] for t in tallies)
    replays = sum(t["steps_replayed"] for t in tallies)
    assert eager == cfg.n_layers * (steps - replays), (counts, tallies)
    device = eager + sum(t["replayed_launches"] for t in tallies)
    assert device == cfg.n_layers * steps, (device, steps)
    return counts[kernel], device


def token_share(a, b) -> float:
    """The share of positions where two runs' generations agree."""
    pairs = [(x, y) for ga, gb in zip(a, b) for x, y in zip(ga, gb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def shard_lines(fe, reqs) -> list:
    """Each shard's requests, steps, captures and store counters."""
    return [{"requests": sum(fe.shard_of(r.prompt) == k for r in reqs),
             **program_tally(e),
             "effective_hits": e.store.metrics()["effective_hits"],
             "evictions": e.store.evictions,
             "prefill_tokens_skipped": e.prefill_tokens_skipped}
            for k, e in enumerate(fe.shards)]


def sharded_serve_phase(dev) -> tuple:
    """The sharded tier at full width: codeqwen1.5-7b (32 layers, MHA,
    16.38 GB of bf16 weights, made on the card once) served by a 2-shard
    ``ShardedFrontend`` under the qwen2 paged cell's traffic, the 96-block
    LERC store split 48 a shard. (a) captured (the card's default) and (b)
    eager: equal tokens, per-shard eviction logs, replica logs and metrics,
    replicas verified after each; (c) one engine over the whole store: its
    token share with (a) printed, not gated (a random full-depth model is
    chaotic in bf16 across schedules); (d) the prompts on a timed trace,
    clean (profiled) and with shard 1 crashed at the clean run's first
    token on shard 1 under a lossy status channel: one crash, every request
    finished, retries and drops counted, replicas verified after a resync,
    and the weights shared before and after the rebuild. Then the launcher
    with ``--shards 2`` and a crash plan on the smoke config. Returns K1's
    launches in (a): the wrapper's and the device's."""
    cfg = configs.get("codeqwen1_5_7b")            # full width and depth
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    params = init_params(model_spec(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, dtype=cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(t.numel() for _, t in tree_paths(params))
    assert n_params == CODEQWEN_PARAMS, n_params
    probe = ServeEngine(cfg, {}, max_slots=1, max_seq=16,
                        store=PrefixStore(1 << 40, "lerc", block_tokens=16),
                        pool_blocks=1, paged=True, device=dev,
                        cuda_graphs=False)
    assert probe.pool.block_nbytes == CODEQWEN_BLOCK_BYTES, \
        probe.pool.block_nbytes
    del probe
    prompts = shared_prefix_prompts(cfg.vocab, 16, 4, 512, 64, seed=0)
    run_engine(cfg, params, dev, prompts[:2], cap_blocks=STORE_BLOCKS,
               bt=16, slots=8, max_seq=640, chunk=64, max_new=2,
               paged=True)                                 # warm-up
    torch.cuda.synchronize()
    weights_allocated = torch.cuda.memory_allocated(dev)

    def batch(cuda_graphs):
        fe = codeqwen_frontend(cfg, params, dev, cuda_graphs)
        assert_shared_weights(fe, params)
        kinds = count_messages(fe.bus)
        t0 = time.time()
        rs = [fe.submit(p, max_new=32)[1] for p in prompts]
        fe.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        fe.verify_replicas()
        return fe, rs, kinds, wall

    (fe, reqs, kinds, wall), counts = counted(lambda: batch(None))
    route = [fe.shard_of(p) for p in prompts[:4]]
    launches = frontend_launches(cfg, [program_tally(e) for e in fe.shards],
                                 counts)
    (efe, ereqs, _, ewall), ecounts = counted(lambda: batch(False))
    assert all(e.step_program.captures == 0 for e in efe.shards)
    assert [r.generated for r in ereqs] == [r.generated for r in reqs]
    assert [e.store.eviction_log for e in efe.shards] == \
        [e.store.eviction_log for e in fe.shards]
    assert [t.eviction_log for t in efe.trackers] == \
        [t.eviction_log for t in fe.trackers]
    assert efe.metrics() == fe.metrics()
    m = fe.metrics()
    tokens = [t for r in reqs for t in r.generated]
    assert len(tokens) == 16 * 32 and all(0 <= t < cfg.vocab for t in tokens)
    assert m["evictions"] > 0 and m["effective_hits"] > 0, m
    assert m["msg_eviction_reports"] > 0 and m["msg_peer_profile_broadcasts"] \
        == len(prompts)
    emit("sharded_serve", run="(a) captured and (b) eager",
         config="codeqwen1_5_7b full width and depth, 32 G layers (32 heads, "
         "kv 32, d_head 128, d_ff 13440, vocab 92416), bf16, random weights "
         "(seed 0), ShardedFrontend of 2 paged shards",
         params=n_params, init_s=init_s, weights_allocated=weights_allocated,
         block_nbytes=CODEQWEN_BLOCK_BYTES,
         store_capacity_per_shard=fe.shards[0].store.capacity,
         family_shards=route, requests=len(prompts),
         generated_tokens=len(tokens), wall_s=wall,
         tokens_per_s=len(tokens) / wall, eager_wall_s=ewall,
         eager_tokens_per_s=len(tokens) / ewall, eager_identical=True,
         verify_replicas=True, kernel_launches=counts,
         eager_kernel_launches=ecounts,
         paged_decode_attention={"wrapper": launches[0],
                                 "device": launches[1],
                                 "per_step_per_shard": cfg.n_layers},
         shards=shard_lines(fe, reqs), messages_by_kind=kinds,
         bus={key[4:]: val for key, val in m.items()
              if key.startswith("msg_")},
         evictions=m["evictions"], effective_hits=m["effective_hits"],
         prefill_tokens_skipped=m["prefill_tokens_skipped"],
         engine_steps=m["engine_steps"])
    fe_tokens = [r.generated for r in reqs]
    fe.close()
    efe.close()
    del fe, efe, reqs, ereqs

    # (c) one engine over the whole store: the schedule differs, so only
    # the token share is printed
    t0 = time.time()
    single, sstore, sreqs = run_engine(
        cfg, params, dev, prompts, cap_blocks=STORE_BLOCKS, bt=16, slots=8,
        max_seq=640, chunk=64, max_new=32, paged=True)
    torch.cuda.synchronize()
    sm = single.metrics()
    emit("sharded_serve", run="(c) one ServeEngine, the whole 96-block "
         "store, captured", wall_s=time.time() - t0,
         engine_steps=single.steps, evictions=sm["evictions"],
         effective_hits=sm["effective_hits"],
         prefill_tokens_skipped=sm["prefill_tokens_skipped"],
         token_share_with_a=token_share([r.generated for r in sreqs],
                                        fe_tokens))
    del single, sstore, sreqs
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a timed trace, clean (profiled) and with a crash of shard 1
    trace = [TracedRequest(t=t, prompt=p, max_new=32)
             for t, p in zip(poisson_arrivals(16, 0.2, seed=0), prompts)]
    clean_fe = codeqwen_frontend(cfg, params, dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        clean = play_trace(clean_fe, trace)
        torch.cuda.synchronize()
        clean_ms = (time.time() - t0) * 1e3
    clean_fe.verify_replicas()
    table = kernel_table(prof)
    by_name = device_ms_by_kernel(table)
    busy = sum(by_name.values())
    runs, k1_ms = traced_kernel(table, "paged_decode_attention")
    clean_steps = sum(e.steps for e in clean_fe.shards)
    assert 0 < runs <= cfg.n_layers * clean_steps, (runs, clean_steps)
    crash_at = min(r.first_token_at for r in clean.requests
                   if clean_fe.shard_of(r.prompt) == 1)
    clean_fe.close()
    del clean_fe
    gc.collect()
    torch.cuda.empty_cache()

    plan = FaultPlan(seed=7, shard_crashes=((crash_at, 1),),
                     bus_faults=(BusFault(channel="status", drop_p=0.2),))
    tallies, memory, crashed = [], {}, []

    def faulted():
        fe = codeqwen_frontend(cfg, params, dev, faults=plan)
        assert_shared_weights(fe, params)
        real = fe._crash_shard

        def crash(k):
            torch.cuda.synchronize()
            tallies.append(program_tally(fe.shards[k]))
            crashed.append(weakref.ref(fe.shards[k]))
            memory["before_crash"] = torch.cuda.memory_allocated(dev)
            real(k)
            assert_shared_weights(fe, params)
            torch.cuda.synchronize()
            memory["after_rebuild"] = torch.cuda.memory_allocated(dev)

        fe._crash_shard = crash
        t0 = time.time()
        report = play_trace(fe, trace)
        torch.cuda.synchronize()
        return fe, report, time.time() - t0

    (ffe, report, fwall), fcounts = counted(faulted)
    fm = ffe.metrics()
    assert fm["shard_crashes"] == 1 and len(tallies) == 1, fm
    assert all(r.finished_at is not None for r in report.requests)
    assert len(report.requests) == len(trace)
    assert fm["failover_retries"] >= 1 and fm["msg_dropped"] > 0, fm
    ffe.resync_replicas()
    ffe.verify_replicas()
    flaunches = frontend_launches(
        cfg, tallies + [program_tally(e) for e in ffe.shards], fcounts)
    memory["end"] = torch.cuda.memory_allocated(dev)
    memory["peak"] = torch.cuda.max_memory_allocated(dev)
    # the crashed engine, its pool and its graphs are gone by the end (the
    # trace loop's own reference to the shard lasts until its next arrival)
    assert crashed[0]() is None, "the crashed shard was never freed"
    keyed = by_key(report.requests)
    clean_keyed = by_key(clean.requests)
    emit("sharded_serve", run="(d) timed trace (Poisson, rate 0.2 a unit of "
         "virtual time, seed 0), clean and with shard 1 crashed",
         crash_at=crash_at, clean_wall_ms=clean_ms,
         clean_engine_steps=clean_steps,
         clean_profile={"device_busy_ms": busy,
                        "device_idle_share": (1 - busy / clean_ms if busy
                                              else "not measured: the "
                                              "profiler recorded no device "
                                              "activity"),
                        "paged_decode_attention_runs_in_trace": runs,
                        "paged_decode_attention_ms": k1_ms,
                        "gemm_ms": sum(t for n, t in by_name.items() if any(
                            g in n.lower() for g in GEMM_NAMES))},
         wall_s=fwall, engine_steps=fm["engine_steps"],
         crashed_shard=tallies[0],
         shards=shard_lines(ffe, report.requests),
         shard_crashes=fm["shard_crashes"],
         failover_retries=fm["failover_retries"],
         msg_dropped=fm["msg_dropped"],
         msg_resyncs=ffe.bus.stats.resyncs, verify_replicas=True,
         all_finished=True, weights_shared_after_rebuild=True,
         crashed_shard_freed=True,
         memory_allocated=memory,
         paged_decode_attention={"wrapper": flaunches[0],
                                 "device": flaunches[1]},
         token_share_with_clean=token_share(
             [keyed[k] for k in sorted(keyed)],
             [clean_keyed[k] for k in sorted(keyed)]))
    ffe.close()
    del ffe, report, params
    gc.collect()
    torch.cuda.empty_cache()
    emit("sharded_serve", run="launcher", **launcher_shards())
    return launches


def launcher_shards() -> dict:
    """``repro_torch.launch.serve --arch codeqwen1_5_7b --smoke --shards 2``
    on the card, in this process, with a plan that crashes shard 1 under a
    lossy status channel: it exits 0, says ``shards=2`` and fires the
    crash once."""
    with tempfile.TemporaryDirectory() as root:
        plan = os.path.join(root, "plan.json")
        with open(plan, "w") as f:
            json.dump({"seed": 7, "shard_crashes": [[2.0, 1]],
                       "bus_faults": [{"channel": "status",
                                       "drop_p": 0.2}]}, f)
        argv = ["--arch", "codeqwen1_5_7b", "--smoke", "--shards", "2",
                "--fault-plan", plan]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, counts = counted(lambda: launch_serve.serve_main(argv))
    lines = out.getvalue().splitlines()
    head = [ln for ln in lines if ln.startswith("policy=")]
    vals = {ln.split()[0]: ln.split()[1] for ln in lines
            if ln.startswith("  ")}
    assert rc == 0 and len(head) == 1 and "shards=2" in head[0], lines[:3]
    assert int(vals["shard_crashes"]) == 1, vals
    assert counts["paged_decode_attention"] > 0, counts
    return {"argv": argv[:-1] + ["PLAN"], "exit": rc, "header": head[0],
            **{key: vals[key] for key in (
                "shard_crashes", "failover_retries", "msg_dropped",
                "msg_resyncs", "engine_steps")},
            "kernel_launches": counts}


def frontend_batches(cfg, dev, n, B, S, seed=0):
    """``n`` training batches of B x S tokens and targets and, for the
    stub frontends, B patch embeddings (vlm) or frames (encdec) from a
    seeded numpy generator, on the card in the model dtype."""
    rng = np.random.default_rng(seed)
    feats = ({"patches": (cfg.frontend_len, cfg.frontend_dim)}
             if cfg.frontend == "patch_embed"
             else {"frames": (cfg.frontend_len, cfg.d_model)})
    out = []
    for _ in range(n):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)).to(dev) for k in ("tokens", "targets")}
        for k, shp in feats.items():
            b[k] = torch.from_numpy(rng.standard_normal(
                (B,) + shp, np.float32)).to(dev, cfg.dtype)
        out.append(b)
    return out


def k3_mask(q, k, kw) -> str:
    """Which of the slice's masks a K3 call runs."""
    if kw.get("prefix_len"):
        return "prefix"
    if kw.get("causal", True):
        return "causal"
    return "bidirectional" if q.shape[1] == k.shape[1] else "cross"


def k3_by_mask(tally):
    """A stand-in for K3's wrapper inside the layers: tallies each call by
    ``k3_mask`` in ``tally``, then calls the wrapper (which counts its
    launch as always)."""
    def k3(q, k, v, **kw):
        name = k3_mask(q, k, kw)
        tally[name] = tally.get(name, 0) + 1
        return flash_attention(q, k, v, **kw)
    return k3


def k3_layer_check(cfg, params, batch, what) -> None:
    """One forward at ``params`` and ``batch``: every K3 call held to its
    plain version on the same inputs (the kernel's output carried on),
    within one bf16 ulp (``LAYER_RTOL``) of the call's scale."""
    errs = {}

    def k3(q, k, v, **kw):
        got = flash_attention(q, k, v, **kw)
        errs.setdefault(k3_mask(q, k, kw), []).append(
            rel_err(got, flash_attention_plain(q, k, v, **kw)[0]))
        return got

    with torch.no_grad(), mock.patch.object(model_layers, "flash_attention",
                                            k3):
        loss_fn(cfg, params, batch)
    worst = max(max(e) for e in errs.values())
    assert worst <= LAYER_RTOL["flash_attention"], errs
    emit("train_layers", what=what, rel_err=errs,
         rtol=LAYER_RTOL["flash_attention"])


def vlm_loss_check(cfg, params, batch) -> dict:
    """The first step's loss at 2 of the 18 layers (the first two, the
    image prefix included), kernel route (K3's prefix-LM mask) against the
    plain route (``flash_attention_plain``), beside the control: the plain
    route with its first call's first output nudged one ulp. A random
    full-depth bf16 model is chaotic (``paged_decode_step``), so the bar
    is asserted at 2 layers and the full depth's distance is printed."""
    def plain(q, k, v, **kw):
        return flash_attention_plain(q, k, v, **kw)[0]

    def nudged():
        calls = []

        def attend(q, k, v, **kw):
            out = plain(q, k, v, **kw)
            if not calls:
                out[0, 0, 0, 0] = (out[0, 0, 0, 0].float()
                                   * (1 + 2 ** -7)).to(out.dtype)
            calls.append(1)
            return out
        return attend

    out = {}
    for n in (2, cfg.n_layers):
        c = cfg.replace(n_layers=n)
        p = {**params, "stack": _slice(params["stack"], n)}
        losses = {}
        with torch.no_grad():
            losses["kernel"] = loss_fn(c, p, batch).item()
            for name, fn in (("plain", plain), ("one_ulp", nudged())):
                with mock.patch.object(model_layers, "flash_attention", fn):
                    losses[name] = loss_fn(c, p, batch).item()
        out[n] = {**losses,
                  "kernel_vs_plain": abs(losses["kernel"] - losses["plain"]),
                  "one_ulp_vs_plain": abs(losses["one_ulp"]
                                          - losses["plain"])}
    two = out[2]
    assert all(math.isfinite(x) for d in out.values() for x in d.values())
    assert two["kernel_vs_plain"] <= TRAIN_LOSS_BF16_RTOL * abs(
        two["plain"]), out
    return out


def vlm_train_phase(dev) -> int:
    """paligemma-3b at full width and depth (18 layers), bf16, seeded
    random weights, 4 AdamW steps at batch 4 through ``build_train_step``:
    each example 256 patch embeddings (dim 1152, the SigLIP stub) and 256
    text tokens from a seeded numpy generator; every attention a K3
    launch with the prefix-LM mask (36 a step: 18 forward, 18 checkpoint
    recomputes). Before the first step, the loss at 2 layers by the kernel
    and by the plain route (``vlm_loss_check``); after the last, each
    layer's K3 output against its plain version and a profiled step.
    Returns K3's launches."""
    cfg = configs.get("paligemma_3b")
    batches = frontend_batches(cfg, dev, 5, 4, 256)
    # the weights ``train_steps`` starts from (the same seed and draws)
    params = init_params(model_spec(cfg), torch.Generator(
        device=dev).manual_seed(0), dev, dtype=cfg.dtype)
    first = vlm_loss_check(cfg, params, batches[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tally = {}
    with mock.patch.object(model_layers, "flash_attention",
                           k3_by_mask(tally)):
        step_fn, state, batch, counts = train_steps(
            cfg, dev, {"flash_attention": 2 * cfg.n_layers},
            "paligemma_3b full width and depth (18 layers, d_model 2048, 8 "
            "heads, MQA, d_head 256, d_ff 16384, vocab 257216), bf16, "
            "random weights (seed 0); 256 patches (dim 1152) + 256 tokens",
            batches=batches)
    assert tally == {"prefix": counts["flash_attention"]}, tally
    emit("vlm_loss_check", what="paligemma_3b first-step loss, kernel "
         "route vs plain route, and the plain route with one ulp nudged in "
         "its first layer", by_depth=first, rtol=TRAIN_LOSS_BF16_RTOL,
         asserted_at_layers=2)
    k3_layer_check(cfg, state["params"], batch, "paligemma_3b 18 layers, "
                   "bf16, trained weights, a fifth batch: each K3 call "
                   "against its plain version")
    profile_train(cfg, step_fn, state, batch, "18 layers",
                  {"flash_attention": "flash_wgmma_kernel"},
                  "one train step, batch 4 x (256 patches + 256 tokens)")
    del state
    return counts["flash_attention"]


def encdec_greedy(cfg, params, dev, frames, prompt, new, max_seq):
    """whisper's decode: ``encode`` the (B, T, d) ``frames``,
    ``encdec_prefill_cache``, then ``decode_step`` with a scalar position,
    the (B, P) ``prompt`` fed a column a step and ``new`` greedy tokens.
    Returns (every step's logits, fp32 (B, P + new, V) on the host; the
    greedy tokens (B, new); prefill, prompt and greedy ms a step)."""
    B, P = prompt.shape
    prompt = prompt.to(dev)
    logits, toks = [], []
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode(cfg, params, frames.to(dev))
        cache = encdec_prefill_cache(cfg, params, enc, B, max_seq)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for pos in range(P):
            lg, _ = decode_step(cfg, params, cache, prompt[:, pos:pos + 1],
                                pos)
            logits.append(lg[:, -1].float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(new):
            tok = logits[-1].argmax(-1, keepdim=True).int()
            toks.append(tok)
            lg, _ = decode_step(cfg, params, cache, tok, P + i)
            logits.append(lg[:, -1].float())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    toks = (torch.cat(toks, 1) if toks
            else torch.empty((B, 0), dtype=torch.int32))
    return (torch.stack(logits, 1).cpu(), toks.cpu(), (t1 - t0) * 1e3,
            (t2 - t1) * 1e3 / P, (t3 - t2) * 1e3 / max(new, 1))


def k2_by_attention(tally, enc_len, check=None):
    """A stand-in for K2's wrapper inside the layers: tallies each call as
    ``cross`` (over the encoder's ``enc_len`` keys) or ``self``, then
    calls the wrapper; with ``check`` (a list) each call's output is held
    to the plain version's, (max error, scale) appended."""
    def k2(q, k, v, valid, window=None, softcap=None):
        name = "cross" if k.shape[1] == enc_len else "self"
        tally[name] = tally.get(name, 0) + 1
        got = decode_attention(q, k, v, valid, window=window,
                               softcap=softcap)
        if check is not None:
            want = decode_attention_plain(q, k, v, valid, window, softcap)
            check.append((name, (got.float() - want.float()).abs().max()
                          .item(), want.float().abs().max().item()))
        return got
    return k2


def encdec_phase(dev) -> dict:
    """whisper-base at full width and depth (6 + 6 layers, d 512, 8 heads,
    D 64, vocab 51,865), bf16, seeded random weights. Training: 4 AdamW
    steps at batch 8, 1500 frames and 448 decoder tokens, every attention
    a K3 launch (36 a step: the encoder's bidirectional, the decoder's
    causal and its cross-attention over the frames, each with its
    checkpoint recompute), then each call against its plain version and a
    profiled step.
    Decode at the trained weights: encode 8 rows of 1500 frames,
    ``encdec_prefill_cache``, 4 prompt tokens and 64 greedy ones through
    ``decode_step`` with a scalar position, every attention a K2 launch (6
    self, 6 cross a step); one step's K2 outputs against the plain
    version's; a profiled window. Then the smoke config in f32 on the card
    against the CPU: identical tokens. Returns the K3 launches by mask
    and the K2 launches by attention."""
    cfg = configs.get("whisper_base")
    B, S, max_seq = 8, 448, 448
    batches = frontend_batches(cfg, dev, 5, B, S)
    k3_tally = {}
    with mock.patch.object(model_layers, "flash_attention",
                           k3_by_mask(k3_tally)):
        step_fn, state, batch, counts = train_steps(
            cfg, dev, {"flash_attention": 6 * cfg.n_layers},
            "whisper_base full width and depth (6 encoder + 6 decoder "
            "layers, d_model 512, 8 heads x 64, d_ff 2048, vocab 51865), "
            "bf16, random weights (seed 0); 1500 frames + 448 tokens",
            batches=batches)
    assert k3_tally == {m: 2 * 4 * cfg.n_layers for m in (
        "bidirectional", "causal", "cross")}, k3_tally
    k3_layer_check(cfg, state["params"], batch, "whisper_base 6 + 6 layers, "
                   "bf16, trained weights, a fifth batch: each K3 call "
                   "(encoder, decoder self, cross) against its plain "
                   "version")
    profile_train(cfg, step_fn, state, batch, "6 + 6 layers",
                  {"flash_attention": "flash_wgmma_kernel"},
                  "one train step, batch 8 x (1500 frames + 448 tokens)")
    params = state["params"]
    del state
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.frontend_len, cfg.d_model), np.float32)).to(dev, cfg.dtype)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 4)).astype(
        np.int32))
    encdec_greedy(cfg, params, dev, frames, prompt[:, :1], 1, max_seq)
    k2_tally = {}
    with mock.patch.object(model_layers, "decode_attention",
                           k2_by_attention(k2_tally, cfg.frontend_len)):
        (logits, toks, prefill_ms, prompt_ms, greedy_ms), counts = counted(
            lambda: encdec_greedy(cfg, params, dev, frames, prompt, 64,
                                  max_seq))
    steps = 4 + 64
    assert counts["decode_attention"] == 2 * cfg.n_layers * steps, counts
    assert k2_tally == {"self": cfg.n_layers * steps,
                        "cross": cfg.n_layers * steps}, k2_tally
    assert counts["flash_attention"] == cfg.n_encoder_layers, counts
    assert torch.isfinite(logits).all()
    assert ((0 <= toks) & (toks < cfg.vocab)).all()
    # one step's K2 outputs against the plain version's
    checks = []
    with mock.patch.object(model_layers, "decode_attention",
                           k2_by_attention({}, cfg.frontend_len, checks)):
        encdec_greedy(cfg, params, dev, frames, prompt[:, :1], 0, max_seq)
    assert len(checks) == 2 * cfg.n_layers, checks
    worst = max(e / sc for _, e, sc in checks)
    assert worst <= 2 ** -7, checks                  # one bf16 ulp
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encdec_greedy(cfg, params, dev, frames, prompt[:, :1], 8, max_seq)
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_kernel(kernel_table(prof))
    busy = sum(by_name.values())
    emit("encdec_decode", config="whisper_base full width and depth, bf16, "
         "trained weights (4 steps from seed 0)", batch=B,
         frames=cfg.frontend_len, max_seq=max_seq, prompt_tokens=4,
         new_tokens=64, prefill_ms=prefill_ms, prompt_ms_per_step=prompt_ms,
         greedy_ms_per_step=greedy_ms, tokens_per_s=B * 1e3 / greedy_ms,
         kernel_launches=counts, k2_launches=k2_tally,
         per_call_max_err_over_scale=worst,
         first_tokens=toks[:2, :8].tolist(),
         profiled="encode + prefill + 9 decode steps",
         profiled_wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=(1 - busy / wall_ms if busy else
                            "not measured: the profiler recorded no device "
                            "activity"),
         top_kernels=[[n[:80], t] for n, t in sorted(
             by_name.items(), key=lambda kv: -kv[1])[:5]])
    del params
    encdec_parity(dev)
    return {"k3_by_mask": k3_tally, "k2_by_attention": k2_tally}


def encdec_parity(dev) -> None:
    """The whisper-base smoke config in f32: encode, prefill, 4 prompt
    tokens and 12 greedy ones on the card (K3 in the encoder, K2 in every
    decode attention) and on the CPU from the same weights: identical
    tokens, logits within ``LOGITS_RTOL`` of their scale."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("whisper_base", smoke=True).replace(dtype=torch.float32)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_len, cfg.d_model), np.float32))
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4)).astype(
        np.int32))
    cpu = encdec_greedy(cfg, params, "cpu", frames, prompt, 12, 32)
    card_params = tree_map(lambda t: t.to(dev), params)
    card, counts = counted(lambda: encdec_greedy(
        cfg, card_params, dev, frames, prompt, 12, 32))
    assert counts["flash_attention"] == cfg.n_encoder_layers, counts
    assert counts["decode_attention"] == 2 * cfg.n_layers * 16, counts
    assert torch.equal(card[1], cpu[1]), (card[1], cpu[1])
    err = (card[0] - cpu[0]).abs().max().item()
    scale = cpu[0].abs().max().item()
    assert err <= LOGITS_RTOL * scale, (err, scale)
    emit("encdec_parity", config="whisper_base smoke f32", new_tokens=12,
         tokens_identical=True, max_abs_err=err, logits_scale=scale,
         rtol=LOGITS_RTOL, kernel_launches=counts)


# --------------------------------------------------------------- mesh

# the dry-run cell the card machine's torch builds: moonshot-v1-16b-a3b's
# train_4k on the 512-rank multi-pod mesh, one microbatch
DRYRUN_CELL = ["--arch", "moonshot-v1-16b-a3b", "--shape", "train_4k",
               "--multi-pod", "--microbatches", "1"]
# and, in a second subprocess beside it, two decode cells on the 256-rank
# mesh: recurrentgemma-9b's (R state over the lru width, the rolling L
# cache's sequence over the model axis) and whisper-base's (the self
# cache's sequence over the model axis, 8 KV heads on 16 ranks)
DRYRUN_DECODE_CELLS = [["--arch", "recurrentgemma-9b", "--shape",
                        "decode_32k"],
                       ["--arch", "whisper-base", "--shape", "decode_32k"]]
DRYRUN_DEADLINE = 600


def start_dryrun(out_dir: Path) -> list:
    """The dry-run cells, each in a subprocess of its own (CPU only: a
    fake process group, fake tensors), started now, all at once, and read
    by ``mesh_train_phase``: the moonshot train cell, then the two decode
    cells one after the other in a second subprocess."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), CUDA_VISIBLE_DEVICES="")
    started = []
    for name, cells in (("moonshot_train_4k", [DRYRUN_CELL]),
                        ("decode_32k", DRYRUN_DECODE_CELLS)):
        outs = [out_dir / f"dryrun_{name}_{i}.json"
                for i in range(len(cells))]
        cmd = " && ".join(
            f"{sys.executable} -m repro_torch.launch.dryrun "
            f"{' '.join(c)} --json {o}" for c, o in zip(cells, outs))
        proc = subprocess.Popen(["/bin/sh", "-c", cmd], env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        # whatever ends the run ends the subprocess (and its children) too
        atexit.register(lambda p=proc: p.poll() is None and os.killpg(
            p.pid, signal.SIGKILL))
        started.append((proc, cells, outs))
    return started


def finish_dryrun(started) -> None:
    """Each dry-run subprocess's cells: ``ok``, their per-rank bytes and
    ``hbm_frac``."""
    for proc, cells, outs in started:
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_DEADLINE)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        assert proc.returncode == 0, stderr[-3000:]
        lines = [ln for ln in stdout.splitlines() if ln.startswith("[ok]")]
        for cell, out, line in zip(cells, outs, lines):
            (r,) = json.loads(out.read_text())
            multi = "--multi-pod" in cell
            assert r["ok"] and r["devices"] == (512 if multi else 256), r
            assert r["mesh"] == ("2x16x16" if multi else "16x16"), r
            mem = r["memory"]
            assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
            assert mem["temp_bytes"] is None
            assert r["cost"]["bytes_accessed"] is None
            emit("mesh_dryrun", command="python -m repro_torch.launch."
                 "dryrun " + " ".join(cell), per_rank=mem,
                 hbm_frac=r["hbm_frac"], flops=r["cost"]["flops"],
                 collectives=r["collectives"], run_s=r["compile_s"],
                 line=line)


def mesh_batch(mc, batch) -> dict:
    return {k: mc.distribute(v, mc.placements(mc.batch_pspec(
        tuple(v.shape)))) for k, v in batch.items()}


def mesh_train_steps(cfg, mc, state, batches, tc) -> tuple:
    """AdamW steps of ``state`` (DTensors on ``mc``'s mesh, or plain
    without ``mc``) on ``batches``, each timed; every launch counted.
    Returns (steps, launches, peak bytes, the final state)."""
    step_fn = build_train_step(cfg, tc, mc)
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def run():
        nonlocal state
        for b in batches:
            if model_moe.DROP_LOG is not None:
                model_moe.DROP_LOG = []
            t = time.time()
            state, m = step_fn(state, mesh_batch(mc, b) if mc else b)
            loss = m["loss"]
            loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                         else loss)
            torch.cuda.synchronize()
            steps.append({"loss": loss, "ms": (time.time() - t) * 1e3})
            if model_moe.DROP_LOG is not None:
                # the forward's M layers in order (the backward's
                # recomputation runs them again, in reverse)
                steps[-1]["dropped_by_layer"] = [
                    int(n) for n in model_moe.DROP_LOG[:cfg.n_layers]]
    _, launches = counted(run)
    for st in steps:
        assert math.isfinite(st["loss"]), steps
    return steps, launches, torch.cuda.max_memory_allocated(), state


def train_batches(cfg, dev, n) -> list:
    loader = TrainLoader(LoaderConfig(global_batch=2, seq_len=4096,
                                      vocab=cfg.vocab, seed=0))
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in loader.build_batch(i).items()} for i in range(n)]


class FirstEPCall:
    """Records the first ``_moe_ep_device`` call's inputs and output
    (copies), calling through."""

    def __init__(self):
        self.call = None
        self.orig = model_moe._moe_ep_device

    def __call__(self, cfg, group, params, x_flat, dropped=None):
        out = self.orig(cfg, group, params, x_flat, dropped)
        if self.call is None:
            self.call = ({k: v.detach().clone() for k, v in params.items()},
                         x_flat.detach().clone(), out.detach().clone())
        return out


def mesh_moonshot(dev, mc) -> dict:
    """moonshot-v1-16b-a3b at full width cut to 4 M layers: one meshless
    step (K3's launches a step), then 3 steps on the (1, 1) mesh through
    the EP MoE at ep=1, layer 0's EP call held bit for bit to the same
    call with no group."""
    cfg = configs.get("moonshot_v1_16b_a3b").replace(n_layers=4)
    tc = TrainConfig(opt=OptConfig(total_steps=4, warmup_steps=1))
    t0 = time.time()
    state = make_train_state(cfg, tc, torch.Generator(
        device=dev).manual_seed(0), dev)
    n_params = sum(t.numel() for _, t in tree_paths(state["params"]))
    batches = train_batches(cfg, dev, 4)
    init_s = time.time() - t0
    _, one, _, _ = mesh_train_steps(cfg, None, state, batches[:1], tc)
    # a layer's forward, and again its checkpoint's recomputation
    assert one["flash_attention"] == 2 * cfg.n_layers, one
    state = shard_train_state(cfg, state, mc)
    rec = FirstEPCall()
    model_moe.DROP_LOG = []
    try:
        with mock.patch.object(model_moe, "_moe_ep_device", rec):
            steps, launches, peak, _ = mesh_train_steps(
                cfg, mc, state, batches[1:], tc)
    finally:
        model_moe.DROP_LOG = None
    assert launches["flash_attention"] == 3 * one["flash_attention"], (
        launches, one)
    params, x, out = rec.call
    with torch.no_grad():
        again = model_moe._moe_ep_device(cfg, None, params, x)
    assert torch.equal(out, again), (out - again).abs().max()
    T = x.shape[0]
    emit("mesh_train", config="moonshot_v1_16b_a3b full width (d_model "
         "2048, 16 heads, 64 experts top-6 + 2 shared, d_ff 1408, vocab "
         "163840), 4 M layers, bf16, random weights (seed 0)",
         mesh="(1, 1) data=1 model=1, one NCCL rank", params=n_params,
         init_s=init_s, batch=2, seq_len=4096, steps=steps,
         capacity=max(1, math.ceil(T * cfg.top_k * cfg.capacity_factor
                                   / cfg.n_experts)),
         tokens_a_step=T, meshless_step_launches=one,
         kernel_launches=launches, max_memory_allocated=peak,
         ep_layer0_bit_equal_to_groupless=True)
    return {"meshless_step": one, "mesh_3_steps": launches}


def mesh_greedy(cfg, params, dev, prompt, new, mc, frames=None) -> tuple:
    """``prompt`` (B, P) fed a token a step through ``decode_step`` at one
    shared position, then ``new`` greedy tokens; with ``mc`` on its mesh
    (params, cache and tokens DTensors, views of the same tensors). With
    ``frames`` (the encoder-decoder) the cache is ``encdec_prefill_cache``
    of the frames' encoding, made without the mesh. Returns (the greedy
    tokens, ms a step of the greedy part)."""
    B, P = prompt.shape
    if frames is None:
        cache = init_decode_cache(cfg, B, P + new, device=dev)
    else:
        with torch.no_grad():
            cache = encdec_prefill_cache(cfg, params, encode(
                cfg, params, frames), B, P + new)
    if mc is not None:
        params = tree_map(lambda t, s: mc.distribute(t, mc.param_sharding(
            s)), params, model_spec(cfg))
        flat = {}
        for path, leaf in tree_paths(cache):
            flat[path] = mc.distribute(leaf, mc.placements(
                mc.cache_pspec(path, tuple(leaf.shape))))
        cache = unflatten(flat)

    def step(tok, pos):
        if mc is not None:
            tok = mc.distribute(tok, mc.placements(mc.batch_pspec(
                tuple(tok.shape))))
        logits, _ = decode_step(cfg, params, cache, tok, pos,
                                mesh_ctx=mc)
        last = logits[:, -1]
        if mc is not None:
            last = mc.gather_seq(last).full_tensor()
        return torch.argmax(last, dim=-1).to(torch.int32)[:, None]

    with torch.no_grad():
        for p in range(P):
            tok = step(prompt[:, p:p + 1], p)
        out = [tok]
        torch.cuda.synchronize()
        t = time.time()
        for i in range(new - 1):
            out.append(step(out[-1], P + i))
        torch.cuda.synchronize()
        ms = (time.time() - t) * 1e3 / max(new - 1, 1)
    return torch.cat(out, 1).cpu().tolist(), ms


def mesh_family(dev, mc, cfg, batches, expect, config, frames=None,
                expect_decode=None) -> dict:
    """``cfg`` trained an AdamW step a batch of ``batches`` meshless and as
    many on the (1, 1) mesh, each from the state seed 0 makes (made anew
    for each run, so only one state is on the card at a time): losses
    within ``TRAIN_LOSS_RTOL``, launches equal to the meshless run's and
    ``expect`` a step. Then, at the mesh run's trained weights, 16 prompt
    and 16 greedy tokens of 8 rows through ``decode_step`` with and
    without the mesh (with ``frames``: the encoder-decoder's, 8 rows of
    them): identical tokens, equal launches (``expect_decode`` a step
    where given). ms a step and peak memory both ways. Returns the
    launches of the mesh run's training and decode."""
    tc = TrainConfig(opt=OptConfig(total_steps=4, warmup_steps=1))

    def fresh():
        return make_train_state(cfg, tc, torch.Generator(
            device=dev).manual_seed(0), dev)

    plain_steps, plain_k, plain_peak, state = mesh_train_steps(
        cfg, None, fresh(), batches, tc)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steps, launches, peak, state = mesh_train_steps(
        cfg, mc, shard_train_state(cfg, fresh(), mc), batches, tc)
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(steps, plain_steps))
    assert rel <= TRAIN_LOSS_RTOL, (steps, plain_steps)
    assert launches == plain_k, (launches, plain_k)
    want = {k.__name__: expect.get(k.__name__, 0) * len(batches)
            for k in COUNTED}
    assert launches == want, (launches, want)
    params = tree_map(lambda t: t.to_local(), state["params"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 16)).astype(np.int32)).to(dev)
    runs = {}
    for name, ctx in (("meshless", None), ("mesh", mc)):
        (toks, ms), k = counted(lambda: mesh_greedy(
            cfg, params, dev, prompt, 16, ctx, frames))
        runs[name] = {"tokens": toks, "ms_a_step": ms, "launches": k}
    assert runs["mesh"]["tokens"] == runs["meshless"]["tokens"], runs
    assert runs["mesh"]["launches"] == runs["meshless"]["launches"], runs
    # 16 prompt steps and 15 greedy (the last prompt step gives the first
    # greedy token)
    for name, n in (expect_decode or {}).items():
        assert runs["mesh"]["launches"][name] == 31 * n, runs
    emit("mesh_train", config=config, mesh="(1, 1) data=1 model=1, one "
         "NCCL rank", batch=batches[0]["tokens"].shape[0],
         seq_len=batches[0]["tokens"].shape[1], steps_meshless=plain_steps,
         steps_mesh=steps, max_rel_loss_diff=rel, rtol=TRAIN_LOSS_RTOL,
         launches_meshless=plain_k, launches_mesh=launches,
         max_memory_allocated_meshless=plain_peak,
         max_memory_allocated_mesh=peak,
         decode={n: {k: v for k, v in r.items() if k != "tokens"}
                 for n, r in runs.items()},
         decode_tokens_equal=True, decode_rows=8, decode_prompt=16,
         decode_new=16)
    return {"train": launches, "decode": runs["mesh"]["launches"]}


def mesh_families(dev, mc) -> dict:
    """The families on the (1, 1) mesh (``mesh_family``): qwen2-7b at full
    width cut to 4 layers, 3 steps; recurrentgemma-9b cut to 5 layers (the
    train cell's ``RRL`` unit and ``RR`` tail) and rwkv6-3b cut to 4 W
    layers, 2 steps each, all at batch 2 x 4096 from ``TrainLoader``; and
    whisper-base whole, 2 steps at batch 8 x (1500 frames, 448
    tokens)."""
    out = {}
    cfg = configs.get("qwen2_7b").replace(n_layers=4)
    out["qwen2"] = mesh_family(
        dev, mc, cfg, train_batches(cfg, dev, 3),
        {"flash_attention": 2 * cfg.n_layers},
        "qwen2_7b full width (d_model 3584, 28 heads, GQA kv=4, d_ff "
        "18944, vocab 152064), 4 layers, bf16, random weights (seed 0)",
        expect_decode={"decode_attention": cfg.n_layers})
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get("recurrentgemma_9b").replace(n_layers=5)
    out["recurrentgemma"] = mesh_family(
        dev, mc, cfg, train_batches(cfg, dev, 2),
        {"flash_attention": 2, "rglru_scan": 6, "rglru_scan_reverse": 4},
        "recurrentgemma_9b full width (d_model 4096, 16 heads, MQA, "
        "d_head 256, d_ff 12288, vocab 256000, window 2048, lru width "
        "4096), 5 layers (RRL + RR tail), bf16, random weights (seed 0)",
        expect_decode={"decode_attention": 1})
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get("rwkv6_3b").replace(n_layers=4)
    out["rwkv6"] = mesh_family(
        dev, mc, cfg, train_batches(cfg, dev, 2), {"rwkv6_wkv": 8},
        "rwkv6_3b full width (d_model 2560, d_ff 8960, vocab 65536, 16 "
        "heads x 160), 4 W layers, bf16, random weights (seed 0)")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get("whisper_base")
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, cfg.frontend_len, cfg.d_model), np.float32)).to(dev, cfg.dtype)
    out["whisper"] = mesh_family(
        dev, mc, cfg, frontend_batches(cfg, dev, 2, 8, 448),
        {"flash_attention": 6 * cfg.n_layers},
        "whisper_base full width and depth (6 encoder + 6 decoder layers, "
        "d_model 512, 8 heads x 64, d_ff 2048, vocab 51865), bf16, random "
        "weights (seed 0); 1500 frames + 448 tokens", frames=frames,
        expect_decode={"decode_attention": 2 * cfg.n_layers})
    return out


def mesh_train_phase(dev, dryrun) -> dict:
    """The mesh path on one card: a (1, 1) mesh (data=1, model=1) over a
    one-rank NCCL group (``make_debug_mesh_context``), moonshot through
    the EP MoE, then qwen2 and the R, W and encoder-decoder families
    meshless beside mesh (``mesh_families``), then the dry-run cells
    started at the run's beginning. Returns the launches by path."""
    if not torch.distributed.is_initialized():
        launch_ranks.init_local_group("cuda")
    mc = make_debug_mesh_context((1, 1))
    out = {"moonshot": mesh_moonshot(dev, mc)}
    gc.collect()
    torch.cuda.empty_cache()
    out.update(mesh_families(dev, mc))
    finish_dryrun(dryrun)
    return out


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
    t_start = time.time()
    dev = torch.device("cuda")
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count(),
         total_memory=torch.cuda.get_device_properties(0).total_memory)
    walls = {}

    def timed(name, phase, *args):
        t = time.time()
        out = phase(*args)
        walls[name] = round(time.time() - t, 3)
        return out

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dryrun = start_dryrun(out_dir)
    t0 = time.time()
    logs = build.build(KERNELS)
    walls["build"] = round(time.time() - t0, 3)
    emit("build", seconds=time.time() - t0, kernels=KERNELS,
         ptxas=[ln.strip() for log in logs.values()
                for ln in log.splitlines()
                if "Function properties" in ln or "Used" in ln
                or "spill" in ln])
    k1 = timed("kernel", kernel_phase, dev)
    k2 = timed("decode_kernel", decode_kernel_phase, dev)
    k3 = timed("flash_kernel", flash_kernel_phase, dev)
    k5 = timed("rglru_kernel", rglru_kernel_phase, dev)
    k4 = timed("rwkv_kernel", rwkv_kernel_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    timed("parity", parity_phase, dev)
    timed("train_parity", train_parity_phase, dev)
    k1_launches, k1_runs, k1_tp = timed("serve", serve_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()       # the qwen2 weights go before gemma2's
    k2_launches, k2_runs = timed("gather_serve", gather_serve_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()       # gemma2's 54.5 GB go before the next
    k2_recurrent = timed("recurrent_decode", recurrent_decode_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    k1_moe = timed("moe_serve", moe_serve_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()       # llama4's 35.3 GB go before qwen2's
    k2_legacy = timed("legacy_serve", legacy_serve_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    k1_vlm = timed("vlm_serve", vlm_serve_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()       # paligemma's weights go before codeqwen's
    k1_sharded = timed("sharded_serve", sharded_serve_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = timed("train", train_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()       # recurrentgemma's state goes before rwkv6's
    k4_launches = timed("rwkv_train", rwkv_train_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()       # rwkv6's 32-layer state goes first
    timed("train_resume", train_resume_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    timed("train_compressed", train_compressed_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    k3_vlm = timed("vlm_train", vlm_train_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    whisper = timed("encdec", encdec_phase, dev)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = timed("mesh_train", mesh_train_phase, dev, dryrun)
    k1_entry = kernel_entry("paged_attention",
                            "src/repro/kernels/paged_attention.py:41",
                            k1_launches, k1)
    k1_entry.update(tpu_kernel="src/repro/kernels/paged_attention.py:"
                    "_paged_kernel", max_err=k1["max_abs_err"],
                    kernel_ms=k1["kernel_ms"], shape="B=8 S=1 H=28 KV=4 "
                    "D=128 bt=16 NW=64, bf16", design=k1["design"],
                    device_launches=k1_runs,
                    kernel_host_ms=k1["kernel_host_ms"], S64=k1["S64"],
                    paligemma_S1=k1["paligemma_S1"],
                    paligemma_S64=k1["paligemma_S64"],
                    codeqwen_S1=k1["codeqwen_S1"],
                    codeqwen_S64=k1["codeqwen_S64"],
                    qwen2_tp2_S1=k1["qwen2_tp2_S1"],
                    qwen2_tp2_S64=k1["qwen2_tp2_S64"],
                    launches_by_path={
                        "qwen2_7b_paged_serve": [k1_launches, k1_runs],
                        "qwen2_7b_paged_serve_tp1": k1_tp,
                        "moonshot_v1_16b_a3b_paged_serve": k1_moe["moonshot"],
                        "llama4_maverick_GM_paged_serve":
                            k1_moe["llama4_GM"],
                        "paligemma_3b_paged_serve": k1_vlm,
                        "codeqwen1_5_7b_sharded_serve": k1_sharded})
    k2_entry = kernel_entry("decode_attention",
                            "src/repro/kernels/decode_attention.py:29",
                            k2_launches, k2)
    k2_entry.update(tpu_kernel="src/repro/kernels/decode_attention.py:"
                    "_decode_kernel", shape="B=8 H=32 KV=16 D=128 S=128 "
                    "ragged, bf16", S4096=k2["S4096"],
                    recurrentgemma_L=k2["recurrentgemma_L"],
                    whisper_self=k2["whisper_self"],
                    whisper_cross=k2["whisper_cross"],
                    device_launches=k2_runs,
                    launches_by_path={
                        "gemma2_27b_gather_serve": [k2_launches, k2_runs],
                        "recurrentgemma_9b_decode_step": k2_recurrent,
                        "qwen2_7b_4_layers_legacy_serve": k2_legacy,
                        "whisper_base_decode_step":
                            whisper["k2_by_attention"],
                        "qwen2_7b_4_layers_mesh_decode_step":
                            mesh["qwen2"]["decode"],
                        "recurrentgemma_9b_5_layers_mesh_decode_step":
                            mesh["recurrentgemma"]["decode"],
                        "whisper_base_mesh_decode_step":
                            mesh["whisper"]["decode"]},
                    lse=k2["lse"])
    k3_entry = kernel_entry("flash_attention",
                            "src/repro/kernels/flash_attention.py:35",
                            train_launches["flash_attention"], k3)
    k3_entry.update(tpu_kernel="src/repro/kernels/flash_attention.py:"
                    "_flash_kernel", shape="recurrentgemma L layer: B=2 "
                    "S=4096 H=16 KV=1 D=256 window 2048, bf16",
                    design=k3["design"], gemma2_G=k3["gemma2_G"],
                    whisper_enc=k3["whisper_enc"],
                    whisper_cross=k3["whisper_cross"],
                    paligemma_prefix=k3["paligemma_prefix"],
                    launches_by_path={
                        "recurrentgemma_9b_5_layers_train":
                            train_launches["flash_attention"],
                        "paligemma_3b_train_prefix": k3_vlm,
                        "whisper_base_train": whisper["k3_by_mask"],
                        "moonshot_v1_16b_a3b_4_layers_mesh_train":
                            mesh["moonshot"],
                        "qwen2_7b_4_layers_mesh_train":
                            mesh["qwen2"]["train"],
                        "recurrentgemma_9b_5_layers_mesh_train":
                            mesh["recurrentgemma"]["train"],
                        "whisper_base_mesh_train":
                            mesh["whisper"]["train"]},
                    qwen2_cp_rank=k3["qwen2_cp_rank"])
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
                        "reverse_bound_ms", "plan", "reverse_plan")},
                    launches_by_path={
                        "recurrentgemma_9b_5_layers_train": train_launches,
                        "recurrentgemma_9b_5_layers_mesh_train":
                            mesh["recurrentgemma"]["train"]})
    k4_entry = kernel_entry("rwkv6_scan",
                            "src/repro/kernels/rwkv6_scan.py:27",
                            k4_launches["rwkv6_wkv"], k4)
    k4_entry.update(tpu_kernel="src/repro/kernels/rwkv6_scan.py:"
                    "_rwkv_kernel", shape="rwkv6-3b W layer: B=2 T=4096 "
                    "H=16 N=160 chunk 16, bf16 r/k/v, fp32 logw/u/out",
                    max_rel_err=k4["max_rel_err"],
                    chunked_ms=k4["chunked_ms"],
                    backward_plain_ms=k4["backward_two_level_ms"],
                    launches_by_path={
                        "rwkv6_3b_train": k4_launches,
                        "rwkv6_3b_4_layers_mesh_train":
                            mesh["rwkv6"]["train"]})
    walls["total"] = round(time.time() - t_start, 3)
    emit("walls", seconds=walls)
    print(json.dumps({"kernels": [k1_entry, k2_entry, k3_entry, k4_entry,
                                  k5_entry]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
