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
