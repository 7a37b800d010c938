"""The compressed KV tier ladder on the card: ``TieredKVStore`` under the
engine's captured steps, the pools' transfers against the work queued on
the stream, and the device quantize against its numpy twin.

* A tiered engine with captured steps gives the eager engine's tokens,
  all three eviction logs and ``metrics()`` (lossless, int8, and with a
  disk tier; f32 and bf16), and a promotion between replays leaves the
  capture count unchanged: rows are written in place, so no graph is
  dropped.
* The host pool's buffers are page-locked views of pinned allocations.
* A demotion issued while work is still queued reads the rows that work
  writes; a promotion's copy is taken from its own staging buffer, so
  the host rows it came from can be reused at once.
* The device quantize stores the numpy twin's bytes and scales bit for
  bit (int8 and fp8, f32 and bf16 sources).

These tests need a GPU and nvcc; elsewhere they skip. Run them on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tiered.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.kernels import paged_decode_attention  # noqa: E402
from repro_torch.models import init_params, model_spec  # noqa: E402
from repro_torch.models import tree_paths  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.lm import cache_shapes  # noqa: E402
from repro_torch.serve import (KVBlockPool, PrefixStore,  # noqa: E402
                               ServeEngine, TieredKVStore)

pytestmark = pytest.mark.cuda

BT = 8
PROMPT = 40
MAX_NEW = 4
TIERS = {"lossless": dict(kv_quant=None),
         "int8": dict(kv_quant="int8"),
         "disk": dict(kv_quant=None, disk_blocks=64)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def workload(vocab, n_requests=12, n_families=4, seed=3):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    return [prefixes[i % n_families]
            + list(rng.integers(0, vocab, BT)) for i in range(n_requests)]


def _model(dev, dtype):
    cfg = configs.get("qwen2_7b", smoke=True).replace(dtype=dtype)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype=dtype)
    return cfg, params


def _tiered(cfg, params, dev, cuda_graphs, kv_quant=None, disk_blocks=0,
            host_blocks=3):
    probe = ServeEngine(cfg, params, max_slots=2, max_seq=64,
                        store=PrefixStore(1 << 30, "lerc", block_tokens=BT),
                        pool_blocks=1, paged=True, device=dev,
                        cuda_graphs=False)
    blk = probe._block_nbytes()
    store = TieredKVStore(blk * 8, "lerc", block_tokens=BT,
                          host_capacity_bytes=blk * host_blocks,
                          kv_quant=kv_quant,
                          disk_capacity_bytes=blk * disk_blocks)
    return ServeEngine(cfg, params, max_slots=2, max_seq=64, store=store,
                       prefill_chunk=BT, paged=True, device=dev,
                       cuda_graphs=cuda_graphs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tiered_captured_matches_eager(dev, tier, dtype):
    """Captured against eager, on the paged plane under every tier: the
    same tokens, eviction logs and metrics; promotions happen between
    replays and no signature is captured twice."""
    cfg, params = _model(dev, dtype)
    out = []
    for cuda_graphs in (None, False):
        eng = _tiered(cfg, params, dev, cuda_graphs, **TIERS[tier])
        prog = eng.step_program
        moves = []
        write_rows = eng.pool.write_rows

        def promote(*a, **kw):
            moves.append(prog.replays)
            return write_rows(*a, **kw)

        eng.pool.write_rows = promote
        paged_decode_attention.launches = 0
        rs = [eng.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
        eng.run()
        torch.cuda.synchronize()
        st = eng.store
        m = eng.metrics()
        assert m["promotions"] > 0 and m["demotions"] > 0, m
        if tier == "disk":
            assert m["disk_promotions"] > 0, m
        if tier == "int8":
            assert m["dequantized_promotions"] > 0, m
        if cuda_graphs is None:
            assert prog.captures > 0 and prog.replays > 0
            # promotions between replays did not drop a graph
            assert any(0 < r < prog.replays for r in moves), moves
            assert prog.captures == len(prog._graphs)
            assert prog._kv is eng.pool.buffers
        out.append(([r.generated for r in rs], st.eviction_log,
                    st.host_eviction_log, st.disk_eviction_log, m))
        eng.close()
    assert out[0] == out[1]


def test_promotion_between_replays_keeps_the_capture_count(dev):
    """Once a step signature is captured, promoting a demoted chain (an
    in-place write into the pool rows the graphs read) and stepping the
    same signature again replays the graph: the capture count does not
    move and the buffers are the same tensors at the same addresses."""
    cfg, params = _model(dev, torch.float32)
    eng = _tiered(cfg, params, dev, None, host_blocks=64)
    prog = eng.step_program
    reqs = workload(cfg.vocab)
    for r in reqs[:8]:
        eng.submit(r, max_new=MAX_NEW)
    eng.run()
    assert eng.store.metrics_obj.demotions > 0
    ptrs = [b.data_ptr() for _, b in tree_paths(eng.pool.buffers)]
    captures, graphs = prog.captures, dict(prog._graphs)
    assert captures > 0
    promotions = eng.store.metrics_obj.promotions
    # the same prompts again: their chains promote back from the host tier
    for r in reqs[:8]:
        eng.submit(r, max_new=MAX_NEW)
    eng.run()
    assert eng.store.metrics_obj.promotions > promotions
    # no graph was dropped: a capture since is a signature first seen since
    assert prog.captures - captures == len(prog._graphs) - len(graphs)
    assert all(prog._graphs[k] is v for k, v in graphs.items())
    assert [b.data_ptr() for _, b in tree_paths(eng.pool.buffers)] == ptrs


def test_host_pool_buffers_are_pinned(dev):
    """On the card the host tier's buffers are views of page-locked
    allocations (the disk tier's are file-backed memmaps)."""
    cfg, params = _model(dev, torch.bfloat16)
    for kv_quant in (None, "int8"):
        eng = _tiered(cfg, params, dev, False, kv_quant=kv_quant,
                      disk_blocks=4)
        hp = eng.store.host_pool
        assert hp.pin_memory and len(hp.pinned) == 2
        assert all(t.is_pinned() for t in hp.pinned)
        bufs = [b for _, b in tree_paths(hp.buffers)]
        assert sorted(b.ctypes.data for b in bufs) == \
            sorted(t.data_ptr() for t in hp.pinned)
        assert bufs[0].dtype == (np.int8 if kv_quant else np.uint16)
        assert not eng.store.disk_pool.pinned
        eng.close()


def _pool(dev, dtype=torch.bfloat16, rows=8):
    cfg = configs.get("qwen2_7b", smoke=True).replace(dtype=dtype)
    template = tree_map(lambda s: torch.empty(s, dtype=dtype, device="meta"),
                        cache_shapes(cfg, 1, 8))
    pool = KVBlockPool(template, BT, rows, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _, b in tree_paths(pool.buffers):
        b.copy_(torch.randn(b.shape, generator=gen, device=dev))
    return pool


@pytest.mark.parametrize("quant_name", ["none", "int8"])
def test_demotion_reads_rows_written_by_queued_work(dev, quant_name):
    """The host runs ahead of the card: a row write queued behind a long
    kernel is still pending when ``read_rows`` is called, and the rows it
    returns are the written ones."""
    pool = _pool(dev)
    spec = quant.get_spec(quant_name)
    row = 5
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)              # keep the stream busy
    for _, b in tree_paths(pool.buffers):
        b.select(b.ndim - 4, row).fill_(3.0)
    out = pool.read_rows([row], quant=spec)
    blocks, scales = (out, None) if spec is None else out
    for path, a in tree_paths(blocks):
        got = quant.from_host(np.ascontiguousarray(a)).float()
        if scales is not None:
            sc = torch.from_numpy(dict(tree_paths(scales))[path])
            got = got * sc[..., None, None, None]
        assert torch.all(got == 3.0), path


def test_promotion_copies_from_its_own_staging_buffer(dev):
    """``write_rows`` packs the host rows into a fresh page-locked buffer
    before it returns: overwriting the source arrays at once (as a later
    demotion overwrites a freed host row) does not reach the pool, even
    with the copy still queued behind a long kernel."""
    pool = _pool(dev)
    src = pool.read_rows([1, 2])
    want = {p: a.copy() for p, a in tree_paths(src)}
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pool.write_rows([6, 7], src)
    for _, a in tree_paths(src):
        a[...] = 0
    torch.cuda.synchronize()
    back = dict(tree_paths(pool.read_rows([6, 7])))
    for path, a in want.items():
        np.testing.assert_array_equal(back[path], a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("spec", [quant.INT8, quant.FP8],
                         ids=["int8", "fp8"])
def test_device_quantize_is_numpy_twin_bit_for_bit(dev, spec, dtype):
    rng = np.random.default_rng(4)
    shape = (6, 3, 16, 4, 128)
    x = rng.standard_normal(shape) * (10.0 ** rng.uniform(-3, 2, (6, 3, 1,
                                                                  1, 1)))
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
    q, s = quant.quantize_blocks(xt.to(dev), spec)
    qn, sn = quant.quantize_blocks_np(quant.to_host(xt), spec)
    np.testing.assert_array_equal(quant.to_host(q.cpu()).view(np.uint8),
                                  qn.view(np.uint8))
    np.testing.assert_array_equal(s.cpu().numpy(), sn)
    d = quant.dequantize_blocks(q, s, dtype).cpu()
    dn = quant.dequantize_blocks_np(qn, sn, dtype)
    np.testing.assert_array_equal(quant.to_host(d), dn)
