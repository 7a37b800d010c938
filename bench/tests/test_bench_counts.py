"""The yardstick's arithmetic: percentiles over every request due (the
unfinished ones at their age), and the FLOP and byte counts behind
``mfu`` and ``k1_roofline`` on hand-worked shapes, each at or under what
the shapes need."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT
from bench import flops, harness, stats
from bench.check import load_reference

TINY = {"hidden_size": 4, "intermediate_size": 3, "num_attention_heads": 2,
        "num_key_value_heads": 1, "num_hidden_layers": 1, "vocab_size": 5,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6}


def test_percentile_is_numpys_and_empty_is_none():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 90) == pytest.approx(np.percentile(xs, 90))
    assert stats.percentile([], 90) is None


def _run(requests, steps, T=10.0, finished=()):
    cell = harness.Cell("x", 1, TINY, {}, [], [])
    return harness.Run(cell, 0, T, 1.0, requests, list(finished), steps, {},
                       {})


def test_ttft_counts_every_request_due_unfinished_at_its_age():
    read = harness.load_reader(ROOT / "bench", "ttft_p90_ms")
    s1 = harness.StepRec(None, [], 1, t=1.5)
    late = harness.StepRec(None, [], 1, t=12.0)    # after the window
    reqs = [harness.ReqRec(1.0, 1.0, 10, 4, first=s1),
            harness.ReqRec(2.0, 2.0, 10, 4, first=late),
            harness.ReqRec(3.0, None, 10, 4)]      # never submitted
    # 0.5 s, then two unfinished at their ages at T=10: 8 s and 7 s
    assert read(_run(reqs, [s1, late])) == pytest.approx(
        np.percentile([0.5, 8.0, 7.0], 90) * 1e3)


def test_tpot_and_tokens_count_what_finished_in_the_window():
    tpot = harness.load_reader(ROOT / "bench", "tpot_p90_ms")
    rate = harness.load_reader(ROOT / "bench", "output_tokens_per_s")
    a, b, c = (harness.StepRec(None, [], 2, t=t) for t in (1.0, 3.0, 11.0))
    done = harness.ReqRec(0.0, 0.0, 8, 5, first=a, last=b, n_out=5)
    spill = harness.ReqRec(0.0, 0.0, 8, 5, first=a, last=c, n_out=5)
    run = _run([done, spill], [a, b, c], finished=[done, spill])
    assert tpot(run) == pytest.approx((3.0 - 1.0) / 4 * 1e3)
    assert rate(run) == pytest.approx(4 / 10.0)


def test_linear_params_and_step_flops_by_hand():
    # d=4, H=2, KV=1, D=2, f=3: q 16 + k,v 16 + o 16 + mlp 36
    assert flops.linear_params(TINY) == 84
    # one slot fed positions 0 and 1: 2 tokens, 1 + 2 visible pairs
    assert flops.attention_pairs([(0, 2)]) == 3
    assert flops.step_flops(TINY, [(0, 2)]) == \
        2 * 84 * 2 + 2 * 4 * 5 + 4 * 2 * 2 * 3
    # a decode token at position 5 sees 6 keys
    assert flops.step_flops(TINY, [(5, 6)]) == \
        2 * 84 + 2 * 4 * 5 + 4 * 2 * 2 * 6


def test_k1_cost_by_hand():
    nbytes, fl = flops.k1_step_cost(TINY, [(0, 2), (5, 6)])
    # K and V rows visible: 2 + 6, each KV=1 x D=2 x 2 B, K and V;
    # q read and o written: 3 tokens x H=2 x D=2 x 2 B each
    assert nbytes == 2 * (2 * 8 * 1 * 2) + 2 * (2 * 3 * 2 * 2)
    assert fl == 4 * 2 * 2 * (3 + 6)
    peak = {"hbm_byte_per_s": 2.0, "bf16_flop_per_s": 100.0}
    assert flops.roofline_s(nbytes, fl, peak) == max(nbytes / 2.0,
                                                     fl / 100.0)


@pytest.mark.parametrize("T", [7, 33, 64])
def test_step_flops_at_or_under_a_forward_of_the_chunk(T):
    """One slot's prefill of T tokens from position 0 needs no more than
    the plain reference computes for those tokens and their last logit."""
    cfg = dict(TINY, hidden_size=16, intermediate_size=24,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=40,
               num_hidden_layers=2)
    ref = load_reference(ROOT / "bench", "qwen2")
    w = ref.make_weights(cfg, 1, "cpu", torch.float32)
    with FlopCounterMode(display=False) as fc:
        ref.logits_at(cfg, w, [[i % 40 for i in range(T)]], [T - 1])
    counted = fc.get_total_flops()
    mine = flops.step_flops(cfg, [(0, T)])
    assert mine <= counted
    # and no less than its products outside attention
    assert mine >= 2 * flops.linear_params(cfg) * T


def test_k1_bytes_at_or_under_the_tensors_it_must_touch():
    """A call over a pool reads at least the visible K and V rows and the
    queries, and writes the outputs: what k1_step_cost counts."""
    cfg = dict(TINY, num_attention_heads=4, num_key_value_heads=2,
               hidden_size=16, num_hidden_layers=1)
    feeds = [(0, 16), (30, 31)]
    D, H, KV = 4, 4, 2
    kv = sum(a for _, a in feeds) * KV * D * 2 * 2
    qo = sum(a - b for b, a in feeds) * H * D * 2 * 2
    assert flops.k1_step_cost(cfg, feeds)[0] == kv + qo


# ------------------------------------------------ configurations by kind
def _config(name):
    import json
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def _parent_step_flops(cfg, feeds):
    """step_flops as it read for dense GQA before the counts took their
    kind from the configuration's keys."""
    D, H = flops.head_dim(cfg), cfg["num_attention_heads"]
    d, f, KV = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_key_value_heads"]
    linear = cfg["num_hidden_layers"] * (d * H * D + 2 * d * KV * D
                                         + H * D * d + 3 * d * f)
    tokens = sum(a - b for b, a in feeds)
    return (2.0 * linear * tokens
            + 2.0 * d * cfg["vocab_size"] * len(feeds)
            + 4.0 * D * H * flops.attention_pairs(feeds)
            * cfg["num_hidden_layers"])


FEEDS = [[(0, 64)], [(100, 101)], [(0, 64), (1500, 1501), (2000, 2064)],
         [(p, p + 1) for p in range(1000, 3000, 125)],
         [(0, 16), (64, 128), (4031, 4032), (3968, 4032)]]


@pytest.mark.parametrize("name,block,linear", [
    ("qwen2-7b", 917_504, 6_525_288_448),
    ("qwen1.5-110b-s10", 655_360, 13_589_544_960)])
def test_existing_configurations_keep_their_counts(name, block, linear):
    """The dense GQA configurations read exactly what they read before
    the counts took the cache layout and the MLP from the keys."""
    cfg = _config(name)
    assert harness.block_nbytes(cfg, 16) == block
    assert flops.linear_params(cfg) == linear
    H, KV, D, L = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   flops.head_dim(cfg), cfg["num_hidden_layers"])
    assert flops.pair_flops(cfg) == 4 * D * H
    for feeds in FEEDS:
        assert flops.step_flops(cfg, feeds) == _parent_step_flops(cfg, feeds)
        rows = sum(a for _, a in feeds)
        tokens = sum(a - b for b, a in feeds)
        assert flops.k1_step_cost(cfg, feeds) == (
            float(L * 2 * (2 * rows * KV * D + 2 * tokens * H * D)),
            4.0 * D * H * flops.attention_pairs(feeds) * L)


# Moonlight-16B-A3B's published config.json
# (https://huggingface.co/moonshotai/Moonlight-16B-A3B), the keys that
# size it.
MOONLIGHT = {
    "model_type": "deepseek_v3", "hidden_size": 2048,
    "intermediate_size": 11264, "moe_intermediate_size": 1408,
    "num_hidden_layers": 27, "first_k_dense_replace": 1,
    "moe_layer_freq": 1, "n_routed_experts": 64, "n_shared_experts": 2,
    "num_experts_per_tok": 6, "norm_topk_prob": True,
    "routed_scaling_factor": 2.446, "scoring_func": "sigmoid",
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "kv_lora_rank": 512, "q_lora_rank": None, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "vocab_size": 163840,
    "rope_theta": 50000, "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
    "attention_bias": False, "max_position_embeddings": 8192}


def test_latent_moe_configuration_resolves_and_counts(tmp_path):
    """A latent-cache MoE configuration written as new files resolves and
    is sized and counted from its own keys: one 576-wide latent row a
    token and layer, the active experts' and the router's weights, and
    the MLA projections."""
    import json
    import shutil
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (bench / "configs" / "moonlight-16b-a3b.json").write_text(
        json.dumps(dict(MOONLIGHT, store_blocks=1536)))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "moonlight-16b-a3b", "file":
        "bench/configs/moonlight-16b-a3b.json", "reduced": [],
        "source": "https://huggingface.co/moonshotai/Moonlight-16B-A3B",
        "why": "test"})
    manifest["workloads"].append({
        "name": "moonlight-16b-a3b.rag-zipf", "config": "moonlight-16b-a3b",
        "traffic": "rag-zipf", "chips": 1, "why": "test"})
    cfg = harness.resolve_cell(manifest, "moonlight-16b-a3b.rag-zipf",
                               bench).config
    assert flops.cache_elements(cfg) == 512 + 64
    assert harness.block_nbytes(cfg, 16) == 27 * 16 * 576 * 2 == 497_664
    # attention a layer: q 2048x16x192, kv_a 2048x576, kv_b 512x16x256,
    # o 16x128x2048
    assert flops.attention_params(cfg) == (6_291_456 + 1_179_648
                                           + 2_097_152 + 4_194_304)
    assert flops.mlp_params(cfg, 0) == 3 * 2048 * 11264
    assert flops.mlp_params(cfg, 1) == 8 * 3 * 2048 * 1408 + 2048 * 64
    assert flops.linear_params(cfg) == 2_243_559_424
    assert flops.pair_flops(cfg) == 2 * 16 * (192 + 128) == 10_240
    assert flops.step_flops(cfg, [(9, 10)]) == (
        2.0 * 2_243_559_424 + 2.0 * 2048 * 163840 + 10_240 * 10 * 27)


def test_q_lora_rank_splits_the_query_projection():
    cfg = dict(MOONLIGHT, q_lora_rank=1536)
    assert flops.attention_params(cfg) == (
        2048 * 1536 + 1536 * 16 * 192 + 1_179_648 + 2_097_152 + 4_194_304)


LATENT = {"hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4,
          "qk_nope_head_dim": 3, "qk_rope_head_dim": 2, "v_head_dim": 5,
          "num_hidden_layers": 1}


def test_latent_attention_cost_by_hand():
    # H=2, r=4, rope=2, nope=3, v=5: a row 6 wide, d_qk 5
    feeds = [(0, 2), (5, 6)]                   # 3 tokens, 8 rows, 9 pairs
    nbytes, fl = flops.latent_attention_cost(LATENT, feeds)
    assert nbytes == 2 * (8 * 6 + 3 * 2 * (5 + 5))
    absorbed = 2 * 2 * (4 + 2 + 4) * 9         # 360
    expanded = 2 * 4 * 2 * (3 + 5) * 8 + 2 * 2 * (5 + 5) * 9   # 1384
    assert fl == min(absorbed, expanded) == 360
    # a long prefill at a wider latent row: many pairs a row, so the
    # expanded form is the lesser
    wide = dict(LATENT, kv_lora_rank=16)
    rows, pairs = 64, 64 * 65 // 2
    absorbed = 2 * 2 * (16 + 2 + 16) * pairs               # 282,880
    expanded = 2 * 16 * 2 * (3 + 5) * rows + 2 * 2 * (5 + 5) * pairs
    assert expanded < absorbed
    assert flops.latent_attention_cost(wide, [(0, 64)])[1] == expanded


@pytest.mark.parametrize("feeds", [[(0, 7)], [(3, 4)], [(0, 5), (9, 10)]])
def test_latent_attention_cost_at_or_under_a_plain_latent_attention(feeds):
    """A plain latent attention over the step's rows, in either form,
    touches at least the bytes and computes at least the FLOPs counted."""
    cfg = dict(LATENT, num_hidden_layers=1)
    H, r, rope, nope, dv = 2, 4, 2, 3, 5
    g = torch.Generator().manual_seed(0)
    nbytes, fl = flops.latent_attention_cost(cfg, feeds)
    wkv_b = torch.randn(r, H, nope + dv, generator=g)
    touched, absorbed_fl, expanded_fl = 0, 0, 0
    for b, a in feeds:
        c = torch.randn(a, r + rope, generator=g)     # the latent rows
        q = torch.randn(a - b, H, nope + rope, generator=g)
        mask = (torch.arange(a)[None, :]
                <= torch.arange(b, a)[:, None])[None]
        with FlopCounterMode(display=False) as fc:    # expanded
            kv = torch.einsum("tr,rhe->the", c[:, :r], wkv_b)
            k = torch.cat([kv[..., :nope],
                           c[:, None, r:].expand(a, H, rope)], -1)
            s = torch.einsum("qhe,the->hqt", q, k).masked_fill(~mask, -1e9)
            o = torch.einsum("hqt,the->qhe", s.softmax(-1), kv[..., nope:])
        expanded_fl += fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:    # absorbed
            qa = torch.einsum("qhe,rhe->qhr", q[..., :nope],
                              wkv_b[..., :nope])
            s = (torch.einsum("qhr,tr->hqt", qa, c[:, :r])
                 + torch.einsum("qhe,te->hqt", q[..., nope:], c[:, r:]))
            p = s.masked_fill(~mask, -1e9).softmax(-1)
            oa = torch.einsum("hqt,tr->qhr", p, c[:, :r])
        # the products over visible pairs only (the step's own queries
        # against their rows): the projections of q and o are the model's
        absorbed_fl += fc.get_total_flops() - 2 * (a - b) * H * nope * r
        touched += 2 * (c.numel() + q.numel() + o.numel())
        assert oa.shape == (a - b, H, r)
    assert nbytes <= touched
    assert fl <= min(absorbed_fl, expanded_fl)
