"""The serve step captured into CUDA graphs on the card against the same
engine run eagerly (``cuda_graphs=False``): smoke configs in f32 and bf16,
the paged plane (qwen2, and moonshot's MoE layers with the router's
stable-sort top-k; K1 in every step) and the gather plane (gemma2, K2 in
every step). Both engines must give identical tokens, eviction logs and
``metrics()``, with EOS detection on, a cancel mid-decode, a trace
recorder attached, and a pool that grows mid-run; each kernel must have
been launched ``n_layers`` times a step in both, by its wrapper in the
eager steps and by the graphs' kernel nodes in the replayed ones, each
capture recording ``n_layers`` of them; and a capture that meets a host
sync must raise, not run the step eagerly. The paged plane's packed step
(``lm_packed_step``), captured, must equal its own eager run bit for bit
and the dense (B, S) grid's step within bf16's rounding, at qwen2-7b's
head grouping (G=7) and qwen1.5-110b's (G=8), with and without the TP
path on a one-rank group.

These tests need a GPU and nvcc; elsewhere they skip. Run them on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graph.py
"""
import ctypes
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.models import (decode_cache_shapes,  # noqa: E402
                                lm_decode_step, lm_packed_step)
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 paged_decode_attention)
from repro_torch.models import init_params, model_spec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.obs.device import PORT_CATEGORIES  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402
from repro_torch.serve import step_graph  # noqa: E402
from repro_torch.sharding import serve_tp_context  # noqa: E402

pytestmark = pytest.mark.cuda

BT = 8
PROMPT = 32
# (arch, paged, prefill chunk, the kernel of every step's attention)
PLANES = [("qwen2_7b", True, 8, paged_decode_attention),
          ("gemma2_27b", False, 1, decode_attention),
          ("moonshot_v1_16b_a3b", True, 8, paged_decode_attention)]
COUNTED = (paged_decode_attention, decode_attention)
# the device kernel that each wrapper launches once a call, by the names a
# graph's nodes record (K1's split merge, a second kernel of some calls, is
# left out)
KERNEL_NAMES = {"paged_decode_attention": ("paged_mma_kernel",
                                           "paged_simt_kernel"),
                "decode_attention": ("decode_attention_kernel",)}


def _named(kernel, by_name):
    return sum(n for name, n in by_name.items()
               if any(k in name for k in KERNEL_NAMES[kernel.__name__]))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def workload(vocab, n_requests=8, n_families=3, seed=7):
    """Shared-prefix requests of uniform length, repeats of the first and
    the last, and a ragged one (its last prefill chunk is a one-off)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    reqs = [prefixes[i % n_families] + list(rng.integers(0, vocab, BT))
            for i in range(n_requests)]
    return reqs + [list(reqs[0]), list(reqs[-1]), list(range(3, 40))]


def _engine(cfg, params, dev, paged, chunk, cuda_graphs, bounded=True,
            **kw):
    if bounded:
        probe = ServeEngine(cfg, params, max_slots=2, max_seq=64,
                            store=PrefixStore(1 << 30, "lerc",
                                              block_tokens=BT),
                            pool_blocks=1, prefill_chunk=chunk, paged=paged,
                            device=dev, cuda_graphs=False)
        store = PrefixStore(probe._block_nbytes() * 10, "lerc",
                            block_tokens=BT)
    else:
        # the engine's default, unbounded capacity (its default block of
        # 16 tokens would not fit gemma2 smoke's 8-token window): the pool
        # doubles on demand
        store = PrefixStore(1 << 62, "lerc", block_tokens=BT)
        kw["pool_blocks"] = 8
    return ServeEngine(cfg, params, max_slots=2, max_seq=64, store=store,
                       prefill_chunk=chunk, paged=paged, device=dev,
                       cuda_graphs=cuda_graphs, **kw)


def _drive(eng, scenario, max_new):
    """Run ``scenario`` on ``eng``; returns what must match, and the
    trace's events (wall clock dropped) when one is attached, less the
    port-only categories, whose ``program`` spans say how each step ran
    and so differ between a captured engine and an eager one."""
    rec = None
    if scenario == "trace":
        rec = TraceRecorder()
        eng.attach_trace(rec)
    reqs = [eng.submit(p, max_new=max_new)
            for p in workload(eng.cfg.vocab)]
    streamed = None
    if scenario == "cancel":
        while not any(r.n_generated >= 2 for r in reqs):
            eng.step()
        streamed = eng.drain(reqs[0])
        live = [r for r in reqs if r.slot >= 0 and not r.done
                and r.n_generated >= 2]
        assert eng.cancel(live[0]) and eng.cancel(reqs[-1])
    eng.run()
    events = None if rec is None else [
        {k: v for k, v in ev.items() if k not in ("wall", "dur_wall")}
        for ev in rec.events if ev["cat"] not in PORT_CATEGORIES]
    return ([r.generated for r in reqs], streamed,
            [r.cancelled for r in reqs], eng.store.eviction_log,
            eng.metrics(), events)


def _counted_run(eng, scenario, max_new):
    for k in COUNTED:
        k.launches = 0
    out = _drive(eng, scenario, max_new)
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in COUNTED}


@pytest.mark.parametrize("scenario", ["eos", "cancel", "trace", "growth"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,paged,chunk,kernel", PLANES)
def test_captured_engine_matches_eager(dev, arch, paged, chunk, kernel,
                                       dtype, scenario):
    cfg = configs.get(arch, smoke=True).replace(dtype=dtype)
    params = init_params(model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=dtype)
    kw = dict(bounded=scenario != "growth")
    max_new = 8
    if scenario == "eos":
        plain = _drive(_engine(cfg, params, dev, paged, chunk, False, **kw),
                       "plain", max_new)
        kw.update(eos_id=plain[0][2][1], eos_interval=3)
    # K2's merge counters: one buffer per stream of eager launches, none
    # for captured ones
    counters = sys.modules["repro_torch.kernels.decode_attention"]._counters
    streams = set(counters) | {(torch.cuda.current_device(),
                                torch.cuda.current_stream().cuda_stream)}
    runs = []
    for cuda_graphs in (True, False):
        eng = _engine(cfg, params, dev, paged, chunk, cuda_graphs, **kw)
        blocks = eng.pool.num_blocks
        out, launches = _counted_run(eng, scenario, max_new)
        assert set(counters) <= streams, (set(counters), streams)
        prog = eng.step_program
        # the wrapper counts the eager steps' launches and the one it
        # records into a graph at each capture; a replay launches its
        # graph's kernel nodes
        recorded = _named(kernel, prog.captured_kernels)
        eager = launches[kernel.__name__] - recorded
        assert recorded == cfg.n_layers * prog.captures
        assert eager == cfg.n_layers * (eng.steps - prog.replays), \
            (launches, eng.steps, prog.replays)
        assert eager + _named(kernel, prog.replayed_kernels) == \
            cfg.n_layers * eng.steps
        assert sum(launches.values()) == launches[kernel.__name__]
        runs.append(out)
        if cuda_graphs:
            assert prog.captures > 0 and prog.replays > eng.steps // 2, \
                (prog.captures, prog.replays, eng.steps)
        else:
            assert prog.captures == prog.replays == 0
        if scenario == "growth":
            assert eng.pool.num_blocks > blocks
    captured, eager = runs
    if scenario == "eos":
        assert any(len(g) < max_new for g in eager[0]), "no EOS hit"
    if scenario == "trace":
        assert len(eager[5]) > 100
    if scenario != "growth":
        assert eager[4]["evictions"] > 0
    assert captured == eager


@pytest.mark.parametrize("arch,paged,chunk,kernel", PLANES)
def test_capture_meeting_a_host_sync_raises(dev, monkeypatch, arch, paged,
                                            chunk, kernel):
    """A host sync inside the step is allowed in the eager first sighting
    and fails the capture at the second: the step raises, and no step runs
    eagerly in its place."""
    cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    params = init_params(model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=torch.float32)
    # the gather plane's step, and the paged plane's on packed rows
    for name in ("lm_decode_step", "lm_packed_step"):
        def syncing(cfg, params, kv, tok, *a, _step=getattr(step_graph, name),
                    **kw):
            int(tok.sum().item())
            return _step(cfg, params, kv, tok, *a, **kw)
        monkeypatch.setattr(step_graph, name, syncing)
    eng = _engine(cfg, params, dev, paged, chunk, True)
    for p in workload(cfg.vocab):
        eng.submit(p, max_new=4)
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        eng.run()
    # the process is as before the capture: the caller's stream current,
    # no capture under way, the random generators usable
    assert torch.cuda.current_stream() == stream
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.isfinite(torch.randn(4, device=dev)).all()
    torch.cuda.synchronize()
    prog = eng.step_program
    assert prog.captures == prog.replays == 0
    assert eng.steps == len(prog._seen) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_route_captures_and_replays(dev, dtype):
    """The MoE layer, its router's stable descending sort included, records
    into a CUDA graph without raising, and each replay on new inputs gives
    the eager layer's output and top-k ids (ties included)."""
    cfg = configs.get("moonshot_v1_16b_a3b", smoke=True).replace(dtype=dtype)
    params = init_params(model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=dtype)
    prm = {k: v[0] for k, v in params["stack"]["0_M"]["moe"].items()}
    prm["router"][:, 5] = prm["router"][:, 2]         # tied experts
    x = torch.zeros((4, 8, cfg.d_model), dtype=dtype, device=dev)
    moe.moe(cfg, prm, x)                              # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe.moe(cfg, prm, x)
        _, ids = moe._route(cfg, prm["router"], x.reshape(-1, cfg.d_model))
    g = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        want = moe.moe(cfg, prm, x)
        _, want_ids = moe._route(cfg, prm["router"],
                                 x.reshape(-1, cfg.d_model))
        assert torch.equal(ids, want_ids)
        assert torch.equal(out, want)


def test_graph_kernels_counts_a_child_graphs_kernels(dev):
    """``step_graph.graph_kernels`` reads a child-graph node (type 4,
    ``CU_GRAPH_NODE_TYPE_GRAPH``) and counts the kernels inside it: a
    graph of one captured kernel, given a child graph of three through
    libcuda's ``cuGraphAddChildGraphNode``, counts four, the child's by
    their names."""
    x = torch.zeros(1024, device=dev)
    x.add_(1.0)
    x.mul_(2.0)
    torch.cuda.synchronize()
    child = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(child):
        x.add_(1.0)
        x.mul_(2.0)
        x.add_(3.0)
    parent = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(parent):
        x.mul_(2.0)
    own = step_graph.graph_kernels(parent.raw_cuda_graph())
    inner = step_graph.graph_kernels(child.raw_cuda_graph())
    assert sum(own.values()) == 1 and sum(inner.values()) == 3
    cu = ctypes.CDLL("libcuda.so.1")
    node = ctypes.c_void_p()
    assert cu.cuGraphAddChildGraphNode(
        ctypes.byref(node), ctypes.c_void_p(parent.raw_cuda_graph()), None,
        ctypes.c_size_t(0), ctypes.c_void_p(child.raw_cuda_graph())) == 0
    kind = ctypes.c_int()
    assert cu.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0
    assert kind.value == step_graph._CHILD_GRAPH_NODE == 4
    assert step_graph.graph_kernels(parent.raw_cuda_graph()) == own + inner


@pytest.fixture(scope="module")
def tp1():
    """A one-rank NCCL group of this process's own (serve TP at tp=1),
    torn down after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    ctx = serve_tp_context(1, torch.device("cuda"))
    yield ctx
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("tp", [False, True], ids=["plain", "tp1"])
@pytest.mark.parametrize("heads,kv", [(14, 2), (16, 2)], ids=["G7", "G8"])
def test_packed_step_captured_and_against_the_grid(dev, request, heads, kv,
                                                   tp):
    """bf16, D=128, 2 layers, 5 slots of 16-token blocks, a 64-token
    chunk: a decoding slot, a full and a partial chunk, an idle slot and
    an empty one. The packed step captured into a CUDA graph gives its
    eager run's logits bit for bit (the pool's writes repeat the same
    values); against the dense paged ``lm_decode_step`` on the (B, S) grid
    of the same feeds, from the same pool, each fed slot's logits agree
    within bf16's rounding."""
    kv_shard = request.getfixturevalue("tp1") if tp else None
    cfg = configs.get("qwen2_7b", smoke=True).replace(
        n_layers=2, d_model=256, n_heads=heads, n_kv_heads=kv, d_head=128,
        d_ff=512, dtype=torch.bfloat16)
    params = init_params(model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=torch.bfloat16)
    B, bt, nw, chunk = 5, 16, 8, 64
    rng = np.random.default_rng(0)
    tables = np.zeros((B, nw), np.int32)
    tables[:4] = rng.permutation(np.arange(1, 1 + 4 * nw)).reshape(4, nw)
    slot = np.array([0, 1, 2], np.int32)
    pos = np.array([70, 0, 64], np.int32)
    n = np.array([1, 64, 23], np.int32)
    tokens = rng.integers(0, cfg.vocab, int(n.sum())).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = decode_cache_shapes(cfg, 1 + B * nw, bt)
    pool0 = {"stack": {k: {n_: torch.randn(s_, generator=g, device=dev,
                                           dtype=cfg.dtype)
                           for n_, s_ in v.items()}
                       for k, v in shapes["stack"].items()}}

    def fresh():
        return {"stack": {k: {n_: t.clone() for n_, t in v.items()}
                          for k, v in pool0["stack"].items()}}
    feed = step_graph.pack_feed(B, chunk, bt, tables, slot, pos, n,
                                np.zeros(3, bool), np.ones(3, bool),
                                np.zeros(B, bool), tokens)
    assert (feed.T, feed.S) == (128, 64)
    tab = torch.from_numpy(tables).to(dev)
    buf = torch.from_numpy(feed.data).to(dev)
    tok, rows, _, _, _ = step_graph.unpack(buf, B, feed.T, feed.S, tab)
    pool = fresh()
    eager = lm_packed_step(cfg, params, pool, tok[:-1], rows,
                           kv_shard=kv_shard)[0].clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lm_packed_step(cfg, params, pool, tok[:-1], rows,
                             kv_shard=kv_shard)[0]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    grid = np.zeros((B, 64), np.int32)
    grid[0, 0], grid[1], grid[2, :23] = tokens[0], tokens[1:65], tokens[65:]
    dpos, lens = np.zeros(B, np.int32), np.zeros(B, np.int32)
    dpos[slot], lens[slot] = pos, n
    dense, _ = lm_decode_step(
        cfg, params, fresh(), torch.from_numpy(grid).to(dev),
        torch.from_numpy(dpos).to(dev),
        seq_lens=torch.from_numpy(lens).to(dev), paged_tables=tab,
        kv_shard=kv_shard)
    got, want = eager[slot].float(), dense[slot].float()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 0.03 * scale, \
        ((got - want).abs().max().item(), scale)
