"""The serve step as one program over static buffers
(``repro_torch.serve.step_graph.StepProgram``), on the CPU.

* Called eagerly, the program gives what the engine's step gave before it
  (``EagerDispatch`` below: fresh tensors every step and, on the paged
  plane, the dense (B, S) grid of the same feeds through
  ``lm_decode_step``, kept here as the reference), over whole engine runs
  on both data planes: identical tokens, eviction logs and ``metrics()``.
* The paged plane's packed step (``lm_packed_step`` on ``pack_feed``'s
  rows) against the dense paged ``lm_decode_step`` on mixes of decoding
  slots, full and partial chunks, idle and empty slots: the fed slots'
  logits, the pool rows real tokens wrote, and nothing else written but
  the junk row; the rows it computes against the grid's; and its step
  signatures against the grid's on a scripted run.
* Its graph bookkeeping, with a stand-in for ``torch.cuda.CUDAGraph``
  (``FakeGraphs``: a capture records the step without running it, as a
  capture launches nothing; a replay runs it on the buffers it was
  recorded on), gives the JAX reference engine's tokens, eviction logs and
  metrics, runs each step signature eagerly on first sight, captures it on
  the second and replays it after; drops every graph when the pool grows;
  and hands each step's tokens out in a tensor of their own.

The card's own captures are held to the eager engine in
``tests/test_torch_cuda_graph.py``."""
from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (decode_cache_shapes, init_params,  # noqa: E402
                                model_spec, tree_paths)
from repro_torch.models import (lm_decode_step, lm_packed_step,  # noqa: E402
                                params_from_numpy)
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402
from repro_torch.serve.step_graph import (StepProgram,  # noqa: E402
                                          pack_feed, packed_rows, unpack)

BT = 8
PROMPT = 32
MAX_NEW = 4
# (arch, paged, prefill chunk): the paged plane at token-at-a-time and
# chunked prefill, the gather plane on rolling-window layers
PLANES = [("qwen2_7b", True, 1), ("qwen2_7b", True, 8),
          ("gemma2_27b", False, 1)]


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen2_7b", "gemma2_27b"):
        jcfg = jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)
        tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
        jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                                  dtype=jnp.float32)
        out[arch] = (jcfg, tcfg, jparams,
                     params_from_numpy(jax.device_get(jparams)))
    return out


def workload(vocab, n_requests=8, n_families=3, seed=7):
    """Shared-prefix requests of uniform length, plus repeats of the first
    and the last (a full-chain hit: copy-on-write on the paged plane)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    reqs = [prefixes[i % n_families] + list(rng.integers(0, vocab, BT))
            for i in range(n_requests)]
    return reqs + [list(reqs[0]), list(reqs[-1])]


def _engine(cls, store_cls, cfg, params, *, policy="lerc", chunk=8,
            paged=True, capacity_blocks=10, **kw):
    """An engine of 2 slots whose store holds ``capacity_blocks`` chain
    blocks (None: unbounded, the engine's default store)."""
    store = None
    if capacity_blocks is not None:
        probe = cls(cfg, params, max_slots=2, max_seq=64,
                    store=store_cls(1 << 30, "lerc", block_tokens=BT),
                    pool_blocks=1, prefill_chunk=chunk, paged=paged, **kw)
        store = store_cls(probe._block_nbytes() * capacity_blocks, policy,
                          block_tokens=BT)
    return cls(cfg, params, max_slots=2, max_seq=64, store=store,
               prefill_chunk=chunk, paged=paged, **kw)


def _outcome(eng, reqs):
    return ([r.generated for r in reqs], eng.store.eviction_log,
            eng.metrics())


def _run(eng, prompts, max_new=MAX_NEW):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run()
    return _outcome(eng, reqs)


def dense_grid(feed, B):
    """The (B, S) grid and (5, B) meta of a packed feed: each slot's rows
    as one right-padded row of the grid, as the engine built its step
    before the rows were packed."""
    T, S = feed.T, feed.S
    d = feed.data
    last, route, emit, reset = d[B * S:B * S + 4 * B].reshape(4, B)
    pos, _, _, tile, _ = d[B * S + 4 * B:-T - 1].reshape(5, T)
    real = tile < B * S
    slot, col = tile[real] // S, tile[real] % S
    lens = np.bincount(slot, minlength=B)
    tokens = np.zeros((B, lens.max()), np.int32)
    tokens[slot, col] = d[-T - 1:-1][real]
    meta = np.zeros((5, B), np.int32)
    meta[0, slot[col == 0]] = pos[real][col == 0]
    meta[1] = lens
    meta[2] = route < T
    meta[3], meta[4] = emit, reset
    return tokens, meta


class EagerDispatch:
    """The engine's step as it ran before ``StepProgram``: the host arrays
    uploaded into fresh tensors every step, the previous argmax and the EOS
    mask carried as fresh tensors, and on the paged plane the dense (B, S)
    grid of the step's feeds through ``lm_decode_step``."""

    def __init__(self, eng):
        self.eng = eng
        self.prev = torch.zeros((eng.B,), dtype=torch.int32)
        self.done = torch.zeros((eng.B,), dtype=torch.bool)
        self.tables = None

    def __call__(self, kv, feed, tables=None):
        eng = self.eng
        if tables is not None:
            self.tables = torch.from_numpy(tables).to(eng.device)
        tokens, meta = (dense_grid(feed, eng.B) if eng.paged
                        else (feed.tokens, feed.meta))
        t = torch.from_numpy(tokens).to(eng.device)
        meta_d = torch.from_numpy(meta).to(eng.device)
        pos, lens, use_prev = meta_d[0], meta_d[1], meta_d[2].bool()
        t[:, 0] = torch.where(use_prev, self.prev, t[:, 0])
        logits, _ = lm_decode_step(eng.cfg, eng.params, kv, t, pos,
                                   seq_lens=lens,
                                   paged_tables=self.tables if eng.paged
                                   else None)
        out = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        if eng.eos_id >= 0:
            emit, reset = meta_d[3].bool(), meta_d[4].bool()
            self.done = ((self.done & ~reset)
                         | (emit & (out == eng.eos_id)))
        self.prev = out
        return out


class FakeGraphs:
    """Stands in for CUDA graph capture on the CPU (patched over
    ``StepProgram._record``): a capture records the step and runs nothing;
    a replay runs it, and fails if the engine's KV buffers are no longer
    the ones it was recorded on. Each graph lists one kernel node,
    ``step``."""

    def __init__(self, monkeypatch, eng):
        self.eng = eng
        self.recorded = []          # the KV tree of each capture
        monkeypatch.setattr(StepProgram, "_record",
                            lambda prog, fn: self.record(fn))
        eng.step_program.capture = True

    def _kv(self):
        return self.eng.pool.buffers if self.eng.paged else self.eng.cache

    def record(self, fn):
        kv = self._kv()
        self.recorded.append(kv)

        def replay():
            assert kv is self._kv(), "replayed a graph on replaced KV"
            fn()
        return SimpleNamespace(replay=replay), Counter(step=1)


def _signatures(monkeypatch, eng):
    """Log each step's signature as the program sees it, and on the paged
    plane the signature the dense (B, S) grid of the same feeds had:
    (S, NW)."""
    seen, dense = [], []
    call = StepProgram.__call__

    def logged(prog, kv, feed, tables=None):
        out = call(prog, kv, feed, tables)
        seen.append(prog.key)
        if prog.paged:
            dense.append((dense_grid(feed, prog.B)[0].shape[1],
                          prog.tables.shape[1]))
        return out
    monkeypatch.setattr(StepProgram, "__call__", logged)
    return seen, dense


@pytest.mark.parametrize("policy", ["lru", "lrc", "lerc"])
@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_step_program_matches_eager_dispatch(models, arch, paged, chunk,
                                             policy):
    """Whole engine runs, EOS detection on: the program called eagerly
    against the step as it ran before it."""
    _, tcfg, _, tparams = models[arch]
    prompts = workload(tcfg.vocab)
    kw = dict(policy=policy, chunk=chunk, paged=paged, device="cpu")
    plain = _run(_engine(ServeEngine, PrefixStore, tcfg, tparams, **kw),
                 prompts, max_new=8)
    eos = plain[0][2][1]
    ref = _engine(ServeEngine, PrefixStore, tcfg, tparams, eos_id=eos,
                  eos_interval=3, **kw)
    ref.step_program = EagerDispatch(ref)
    want = _run(ref, prompts, max_new=8)
    eng = _engine(ServeEngine, PrefixStore, tcfg, tparams, eos_id=eos,
                  eos_interval=3, **kw)
    assert isinstance(eng.step_program, StepProgram)
    assert not eng.step_program.capture            # eager on the CPU
    got = _run(eng, prompts, max_new=8)
    assert any(len(g) < 8 for g in want[0]), "no EOS hit"
    assert want[2]["evictions"] > 0
    assert got == want


@pytest.mark.parametrize("policy", ["lru", "lrc", "lerc"])
@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_captured_steps_match_reference(models, monkeypatch, arch, paged,
                                        chunk, policy):
    """The graph bookkeeping (eager first sight, capture, replays) gives
    the JAX engine's tokens, eviction log and metrics, and replays most
    steps."""
    jcfg, tcfg, jparams, tparams = models[arch]
    kw = dict(policy=policy, chunk=chunk, paged=paged)
    want = _run(_engine(JaxEngine, JaxStore, jcfg, jparams, **kw),
                workload(jcfg.vocab))
    eng = _engine(ServeEngine, PrefixStore, tcfg, tparams, device="cpu",
                  **kw)
    FakeGraphs(monkeypatch, eng)
    got = _run(eng, workload(tcfg.vocab))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    prog = eng.step_program
    assert prog.captures > 0
    assert prog.replays + len(prog._seen) == eng.steps


@pytest.mark.parametrize("arch,paged,chunk", PLANES)
def test_signature_eager_then_capture_then_replay(models, monkeypatch, arch,
                                                  paged, chunk):
    """A signature, (T, S, NW) paged and (S,) gather, runs eagerly when
    first seen, is captured when seen again and replays from then on; a
    signature seen once is never captured."""
    _, tcfg, _, tparams = models[arch]
    eng = _engine(ServeEngine, PrefixStore, tcfg, tparams, chunk=chunk,
                  paged=paged, device="cpu")
    fakes = FakeGraphs(monkeypatch, eng)
    seen, _ = _signatures(monkeypatch, eng)
    prog = eng.step_program
    order = []
    record = fakes.record
    monkeypatch.setattr(StepProgram, "_record",
                        lambda p, fn: order.append(p.key) or record(fn))
    # a ragged last prompt: its last chunk is 2 tokens wide, and a step
    # that feeds it alone is a one-off (2 rows, K1's tile 8 wide)
    _run(eng, workload(tcfg.vocab) + [list(range(3, 37))])
    counts = {k: seen.count(k) for k in seen}
    assert all(len(k) == (3 if paged else 1) for k in seen)
    assert prog._seen == set(seen)
    # captured exactly at each signature's second sighting
    second = [k for i, k in enumerate(seen) if seen[:i].count(k) == 1]
    assert order == second
    assert prog.captures == sum(n >= 2 for n in counts.values())
    assert prog.replays == len(seen) - len(counts)
    # each capture's kernel nodes, and each replay's launches of them
    assert prog.captured_kernels == Counter(step=prog.captures)
    assert prog.replayed_kernels == Counter(step=prog.replays)
    if chunk > 1:
        assert any(n == 1 for n in counts.values()), \
            "no one-off signature in the workload"


@pytest.mark.parametrize("paged", [True, False])
def test_pool_growth_drops_graphs(models, monkeypatch, paged):
    """Under the default unbounded store the pool doubles mid-run; every
    graph taken on the old buffers is dropped and its signature captured
    again on the new ones, with the eager engine's results."""
    _, tcfg, _, tparams = models["qwen2_7b"]
    prompts = workload(tcfg.vocab, n_requests=12, n_families=12, seed=3)
    kw = dict(chunk=8, paged=paged, capacity_blocks=None, device="cpu",
              pool_blocks=16)
    want = _run(_engine(ServeEngine, PrefixStore, tcfg, tparams, **kw),
                prompts)
    eng = _engine(ServeEngine, PrefixStore, tcfg, tparams, **kw)
    fakes = FakeGraphs(monkeypatch, eng)
    grown = []
    grow = type(eng.pool)._grow

    def logged_grow(pool):
        grown.append(eng.steps)
        grow(pool)
    monkeypatch.setattr(type(eng.pool), "_grow", logged_grow)
    got = _run(eng, prompts)
    assert got == want
    assert eng.pool.num_blocks > 16 and grown
    if paged:
        # graphs were taken on the first buffers and on the grown ones,
        # and no replay ran on buffers the pool had replaced
        assert len({id(kv) for kv in fakes.recorded}) >= 2
        assert fakes.recorded[-1] is eng.pool.buffers
    else:
        # the gather plane's step reads the per-slot caches, which the
        # pool's growth leaves in place: its graphs are kept
        assert all(kv is eng.cache for kv in fakes.recorded)
        assert eng.step_program.captures == len(fakes.recorded)


def test_each_step_hands_out_its_own_tokens(models, monkeypatch):
    """Replays write every step's argmax into the same ``out``; the tokens
    a request has not drained yet are each step's own."""
    _, tcfg, _, tparams = models["qwen2_7b"]
    prompt = workload(tcfg.vocab)[0]
    kw = dict(chunk=8, paged=True, device="cpu")
    eager = _engine(ServeEngine, PrefixStore, tcfg, tparams, **kw)
    (want,), _, _ = _run(eager, [prompt], max_new=12)
    eng = _engine(ServeEngine, PrefixStore, tcfg, tparams, **kw)
    FakeGraphs(monkeypatch, eng)
    req = eng.submit(prompt, max_new=12)
    while len(req._lazy_out) < 11:
        eng.step()
    assert eng.step_program.replays >= 8
    lazy = list(req._lazy_out)
    assert len({t.data_ptr() for t in lazy}) == len(lazy)
    assert [int(t[req.slot]) for t in lazy] == want[:11]
    assert len(set(want)) > 1, "every step gave the same token"
    assert eng.drain(req) == want[:11]


def test_cuda_graphs_on_the_cpu():
    """None means eager on the CPU; False is eager everywhere; True on the
    CPU raises."""
    cfg = configs.get("qwen2_7b", smoke=True)
    for flag in (None, False):
        eng = ServeEngine(cfg, {}, max_slots=1, max_seq=16, device="cpu",
                          cuda_graphs=flag)
        assert eng.step_program.capture is False
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        ServeEngine(cfg, {}, max_slots=1, max_seq=16, device="cpu",
                    cuda_graphs=True)
    with pytest.raises(NotImplementedError, match="captured CUDA graph"):
        ServeEngine(cfg, {}, max_slots=1, max_seq=16,
                    device="cpu").step_hlo()


# ------------------------------------------------ the packed rows' step
# mixes of B = 5 slots, bt = chunk = 8: (position, tokens fed, context
# already in the pool) a slot, None for a slot with no table; a slot fed 0
# tokens holds a table and idles (preempted)
MIXES = {
    "decode only": [(13, 1), (20, 1), (5, 1), (30, 1), (9, 1)],
    "decode, empty slot": [(13, 1), None, (5, 1), (30, 1), (9, 1)],
    "chunks beside decode": [(13, 1), (8, 8), (16, 3), (24, 0), None],
    "one short chunk alone": [None, None, (16, 2), (24, 0), None],
    "short chunks past B rows": [(8, 3), (16, 3), (0, 3), None, (3, 0)],
    "every slot prefilling": [(0, 8), (8, 8), (16, 8), (24, 5), (32, 7)],
}
NW = 6


def _mix_inputs(vocab, mix, seed=0):
    """Block tables (row 0 the junk row, no two slots sharing a row) and
    the fed slots' arrays of a mix."""
    rng = np.random.default_rng(seed)
    B = len(mix)
    tables = np.zeros((B, NW), np.int32)
    free = list(rng.permutation(np.arange(1, 1 + B * NW)))
    for b, m in enumerate(mix):
        if m is not None:
            tables[b] = [free.pop() for _ in range(NW)]
    fed = [(b, p, n) for b, m in enumerate(mix) if m is not None
           for p, n in [m] if n > 0]
    slot = np.array([f[0] for f in fed], np.int32)
    pos = np.array([f[1] for f in fed], np.int32)
    n = np.array([f[2] for f in fed], np.int32)
    tokens = rng.integers(0, vocab, int(n.sum())).astype(np.int32)
    return tables, slot, pos, n, tokens


def _random_pool(cfg, n_blocks, seed=1):
    g = torch.Generator().manual_seed(seed)
    shapes = decode_cache_shapes(cfg, n_blocks, BT)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return torch.randn(t, generator=g, dtype=cfg.dtype)
    return walk(shapes)


@pytest.fixture(scope="module")
def moe_model():
    cfg = configs.get("moonshot_v1_16b_a3b",
                      smoke=True).replace(dtype=torch.float32)
    return cfg, init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                            "cpu", dtype=torch.float32)


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("arch", ["qwen2_7b", "moonshot_v1_16b_a3b"])
def test_packed_step_matches_dense_paged_step(models, moe_model, arch, mix):
    """``lm_packed_step`` on ``pack_feed``'s rows against the dense paged
    ``lm_decode_step`` on the (B, S) grid of the same feeds, from the same
    pool, on qwen2's G layers and moonshot's MoE (M) layers: each fed
    slot's logits (f32), the pool rows and offsets each real token writes
    (equal), and no other pool entry written but the junk row's."""
    tcfg, tparams = (models[arch][1::2] if arch in models else moe_model)
    B = len(MIXES[mix])
    tables, slot, pos, n, tokens = _mix_inputs(tcfg.vocab, MIXES[mix])
    pool0 = _random_pool(tcfg, 1 + B * NW)
    # the dense grid: each slot's feed right-padded to the widest
    W = int(n.max())
    grid = np.zeros((B, W), np.int32)
    start = np.cumsum(n) - n
    for b, s0, k in zip(slot, start, n):
        grid[b, :k] = tokens[s0:s0 + k]
    dpos, lens = np.zeros(B, np.int32), np.zeros(B, np.int32)
    dpos[slot], lens[slot] = pos, n
    dense_pool = {k: v for k, v in torch.utils._pytree.tree_map(
        torch.clone, pool0).items()}
    want, _ = lm_decode_step(tcfg, tparams, dense_pool,
                             torch.from_numpy(grid), torch.from_numpy(dpos),
                             seq_lens=torch.from_numpy(lens),
                             paged_tables=torch.from_numpy(tables))
    feed = pack_feed(B, 8, BT, tables, slot, pos, n,
                     np.zeros(len(slot), bool), np.ones(len(slot), bool),
                     np.zeros(B, bool), tokens)
    assert feed.real == n.sum() and feed.T <= B * W
    assert (feed.T == B) == (n.sum() <= B)
    assert (feed.S == 1) == (W == 1)
    tok, rows, _, _, _ = unpack(torch.from_numpy(feed.data), B, feed.T,
                                feed.S, torch.from_numpy(tables))
    packed_pool = torch.utils._pytree.tree_map(torch.clone, pool0)
    got, _ = lm_packed_step(tcfg, tparams, packed_pool, tok[:-1], rows)
    assert got.shape == want.shape == (B, 1, tcfg.vocab)
    np.testing.assert_allclose(got[slot].numpy(), want[slot].numpy(),
                               rtol=1e-5, atol=1e-5)
    # the entries real tokens write: (pool row, offset) of each
    tslot = np.repeat(slot, n)
    tpos = np.repeat(pos, n) + np.arange(n.sum()) - np.repeat(start, n)
    real = np.zeros((1 + B * NW, BT), bool)
    real[tables[tslot, tpos // BT], tpos % BT] = True
    assert not real[0].any()
    for (path, p0), (_, pd), (_, pp) in zip(tree_paths(pool0),
                                           tree_paths(dense_pool),
                                           tree_paths(packed_pool)):
        r = torch.from_numpy(real)
        assert torch.equal(pp[..., r, :, :], pd[..., r, :, :]), path
        # nothing else written: every entry but the real ones and the junk
        # row's is the pool's first content
        untouched = ~r
        untouched[0] = False
        assert torch.equal(pp[..., untouched, :, :], p0[..., untouched, :, :])
        assert not torch.equal(pp[..., 0, :, :, :], p0[..., 0, :, :, :]) \
            or feed.T == feed.real


def test_packed_rows_never_exceed_the_grid():
    """Over every feed of up to B = 6 slots of 1-8 tokens (chunk 8): T is B
    when the step feeds at most B tokens, else a multiple of the chunk or
    the grid's own B x S; never more than the grid's B x S rows; and K1's
    tile is one wide exactly when every slot feeds one token."""
    B, chunk = 6, 8
    rng = np.random.default_rng(0)
    for _ in range(2000):
        n = rng.integers(1, chunk + 1, rng.integers(1, B + 1))
        if rng.random() < 0.3:
            n[:] = 1
        T, S = packed_rows(B, chunk, n)
        widest = int(n.max())
        assert n.sum() <= T <= B * widest
        assert T == B if n.sum() <= B else (T % chunk == 0
                                             or T == B * widest)
        assert (S == 1) == (widest == 1) and S in (1, chunk)


def test_engine_rows_and_signatures(models, monkeypatch):
    """A scripted backlog on 4 slots (ragged prompts, a request joining
    whenever the queue runs dry): every step computes at most the rows of
    the dense (B, S) grid of its feeds, and a step whose every slot feeds
    one token exactly B; the program counts the rows; the packed step's
    signatures stay within its row buckets (B, multiples of the chunk, or
    the grid's B x S)."""
    _, tcfg, _, tparams = models["qwen2_7b"]
    eng = ServeEngine(tcfg, tparams, max_slots=4, max_seq=64,
                      prefill_chunk=8, paged=True, device="cpu",
                      store=PrefixStore(1 << 30, "lerc", block_tokens=BT))
    FakeGraphs(monkeypatch, eng)
    seen, dense = _signatures(monkeypatch, eng)
    rng = np.random.default_rng(4)
    for _ in range(12):
        eng.submit(list(rng.integers(0, tcfg.vocab, rng.integers(9, 41))),
                   max_new=int(rng.integers(8, 17)))
        while eng.queue:
            eng.step()
    eng.run()
    assert len(seen) == len(dense) == eng.steps
    for (T, S, nw), (width, dnw) in zip(seen, dense):
        assert nw == dnw and T <= eng.B * width
        assert (S == 1) == (width == 1)
        if width == 1:
            assert T == eng.B
        assert T == eng.B or T % 8 == 0 or T == eng.B * width
    rows = eng.step_rows()
    assert rows["rows_real"] == \
        eng.prefill_tokens + eng.decoded_tokens
    assert rows["rows_run"] == sum(k[0] for k in seen)
    assert rows["rows_run"] < sum(eng.B * w for w, _ in dense)
    assert any(S > 1 for _, S, _ in seen) and any(S == 1 for _, S, _ in seen)
