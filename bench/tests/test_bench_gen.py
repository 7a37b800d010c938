"""The traffic generator: one seed, one set of requests; the warm-up
stream disjoint from the window's; every seed the same sizes and
arrivals, in another order or, where the mix fixes it, in the same."""
import itertools
import json
from collections import Counter

import numpy as np
import pytest

from conftest import ROOT
from bench import gen


def mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def take(traffic, stream, n):
    return list(itertools.islice(traffic.requests(stream), n))


@pytest.mark.parametrize("name", ["rag-zipf", "rag-zipf-s10", "unique-backlog"])
def test_same_seed_same_requests(name):
    a = take(gen.Traffic(mix(name), 152064, 2**31 + 11), "window", 80)
    b = take(gen.Traffic(mix(name), 152064, 2**31 + 11), "window", 80)
    assert [(r.arrival_s, r.prompt, r.max_new) for r in a] == \
        [(r.arrival_s, r.prompt, r.max_new) for r in b]
    c = take(gen.Traffic(mix(name), 152064, 2**31 + 12), "window", 80)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", ["rag-zipf", "rag-zipf-s10", "unique-backlog"])
def test_warmup_stream_is_disjoint(name):
    t = gen.Traffic(mix(name), 152064, 5)
    warm = take(t, "warmup", 200)
    window = take(t, "window", 200)
    tails = {tuple(r.prompt[-32:]) for r in warm}
    assert not tails & {tuple(r.prompt[-32:]) for r in window}
    if t.documents:
        # the documents are the corpus both streams ask about
        docs = {tuple(d) for d in t.documents}
        for r in warm[:20] + window[:20]:
            n = len(t.documents[r.doc])
            assert tuple(r.prompt[:n]) in docs


@pytest.mark.parametrize("name", ["rag-zipf", "rag-zipf-s10", "unique-backlog"])
def test_seeds_share_the_work(name):
    """Every seed offers each block's same multiset of requests (document,
    question length, output length, gap before it), in an order of its
    own, or in the block's own where the mix says ``"order": "block"``;
    the tokens differ."""
    spec = mix(name)
    M = spec["block"]

    def work(seed):
        t = gen.Traffic(spec, 152064, seed)
        reqs = take(t, "window", 3 * M)
        prev, out = 0.0, []
        for r in reqs:
            gap = None
            if r.arrival_s is not None:
                gap, prev = round(r.arrival_s - prev, 9), r.arrival_s
            out.append((r.doc, len(r.prompt) - (len(t.documents[r.doc])
                                                if r.doc >= 0 else 0),
                        r.max_new, gap))
        return out, [r.prompt for r in reqs]

    (a, pa), (b, pb) = work(1), work(987654321987)
    for k in range(3):
        block_a, block_b = a[k * M:(k + 1) * M], b[k * M:(k + 1) * M]
        assert Counter(block_a) == Counter(block_b)
        if spec.get("order", "seed") == "block":
            assert block_a == block_b
        else:
            assert block_a != block_b
    assert all(x != y for x, y in zip(pa, pb))


@pytest.mark.parametrize("name", ["rag-zipf", "rag-zipf-s10"])
def test_poisson_arrivals_bunch_within_the_window(name):
    """A block spans the window, and its requests' order as the harness
    serves it (salt 0: the seed's, or under ``"order": "block"`` the one
    arrangement every seed gets) makes the counts in 1 s and 5 s spread
    as a Poisson process's do (variance near the mean), while the
    window's count stays the block's."""
    spec = mix(name)
    rate = spec["arrival"]["rate_per_s"]
    assert spec["block"] >= rate * 51
    counts = {1.0: [], 5.0: []}
    due = set()
    for seed in range(40):
        t = gen.Traffic(spec, 152064, 2**31 + seed)
        a = np.array([r.arrival_s for r in take(t, "window", spec["block"])])
        for width, c in counts.items():
            c += list(np.histogram(a, bins=np.arange(0.0, 50.0, width))[0])
        due.add(int((a < 51.0).sum()))
    for width, c in counts.items():
        c = np.array(c)
        assert c.mean() == pytest.approx(width * rate, rel=0.05)
        assert 0.6 * c.mean() < c.var() < 1.2 * c.mean()
    assert max(due) - min(due) <= 0.1 * rate * 51


def test_gamma_arrivals_have_the_mix_cv():
    spec = dict(mix("rag-zipf"), block=4096,
                arrival={"kind": "gamma", "rate_per_s": 5.0, "cv": 3.0})
    t = gen.Traffic(spec, 1000, 3)
    a = np.array([r.arrival_s for r in take(t, "window", 4096)])
    g = np.diff(np.concatenate([[0.0], a]))
    assert g.mean() == pytest.approx(0.2, rel=0.05)
    assert g.std() / g.mean() == pytest.approx(3.0, rel=0.1)


def test_lognormal_lengths_follow_their_medians():
    spec = mix("unique-backlog")
    reqs = take(gen.Traffic(spec, 152064, 9), "window", 64 * spec["block"])
    for key, xs in (("question_tokens", [len(r.prompt) for r in reqs]),
                    ("output_tokens", [r.max_new for r in reqs])):
        d = spec[key]
        xs = np.array(xs)
        assert d["min"] <= xs.min() and xs.max() <= d["max"]
        # the trace's median, less what the truncation at the top moves
        assert np.median(xs) == pytest.approx(d["lognormal"]["median"],
                                              rel=0.04)
        # a heavy tail: the mean well above the median
        assert xs.mean() > 1.08 * np.median(xs)


def test_lengths_and_rate_are_the_mix():
    spec = mix("rag-zipf")
    t = gen.Traffic(spec, 152064, 77)
    reqs = take(t, "window", 640)
    q_lo, q_hi = spec["question_tokens"]
    o_lo, o_hi = spec["output_tokens"]
    d_lo, d_hi = spec["documents"]["tokens"]
    assert len(t.documents) == spec["documents"]["count"]
    assert all(d_lo <= len(d) <= d_hi for d in t.documents)
    for r in reqs:
        q = len(r.prompt) - len(t.documents[r.doc])
        assert q_lo <= q <= q_hi and o_lo <= r.max_new <= o_hi
    rate = len(reqs) / reqs[-1].arrival_s
    assert rate == pytest.approx(spec["arrival"]["rate_per_s"], rel=0.05)
    # Zipf(1): the most popular document is asked about most
    counts = Counter(r.doc for r in reqs)
    assert counts.most_common(1)[0][0] == 0
    assert counts[0] / len(reqs) == pytest.approx(
        gen.zipf_cdf(len(t.documents), 1.0)[0], abs=0.02)


def test_backlog_prompts_are_unique():
    t = gen.Traffic(mix("unique-backlog"), 152064, 3)
    reqs = take(t, "window", 256)
    assert all(r.arrival_s is None and r.doc == -1 for r in reqs)
    assert len({tuple(r.prompt[:16]) for r in reqs}) == len(reqs)


def _warmed_backlog(seed):
    """A tiny backlog cell's engine on the CPU, right after its warm-up:
    the step it reached, the requests finished, and what each slot holds
    (prompt length, output length, position, tokens generated)."""
    import torch
    from conftest import tiny_cell
    from bench import harness
    from bench.check import load_reference

    cell = tiny_cell("qwen1.5-110b-s10.unique-backlog")
    cfg, cpu = cell.config, torch.device("cpu")
    weights = load_reference(ROOT / "bench", cfg["reference"]).make_weights(
        cfg, seed, cpu)
    eng = harness.build_engine(cfg, weights, cpu)
    drv = harness.Driver(eng, harness.HostClock())
    slots = cfg["serve"]["max_slots"]
    harness.warm_up(drv, cell.make_traffic(seed), slots, 0.0)
    held = [(len(r.prompt), r.max_new, r.pos, r.n_generated)
            for r in eng.slots if r is not None]
    return eng.steps, drv.finished, held, slots * cell.traffic["arrival"][
        "warmup_per_slot"]


def test_backlog_warm_up_ends_at_one_point_of_the_work_for_every_seed():
    """A backlog's requests come in the block's order and its warm-up ends
    at a count of finished requests, not at a time: two seeds reach the
    window at the same step, with the same requests in the slots."""
    a, b = _warmed_backlog(5), _warmed_backlog(2**32 + 7)
    assert a == b
    steps, finished, held, want = a
    assert finished >= want and held
