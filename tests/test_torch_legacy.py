"""The port's frozen token-at-a-time baseline, ``LegacyServeEngine``:
against the reference's (``repro.serve.legacy``) on the same weights and
workload (tokens, eviction log and ``metrics()`` identical), and the
port's ``ServeEngine`` held to it as the reference holds its engine
(``tests/test_engine_equivalence.py``: ``test_pooled_chunked_engine_
matches_legacy`` and ``test_continuous_batching_matches_legacy``), on the
qwen2-7b smoke config in f32 with the reference's weights carried over by
the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import LegacyServeEngine as JaxLegacy  # noqa: E402
from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serve import (LegacyServeEngine, PrefixStore,  # noqa: E402
                               ReferencePrefixStore, ServeEngine)

BT = 8          # block_tokens
PROMPT = 32     # uniform prompt length (4 blocks)
MAX_NEW = 4


class ShadowStore:
    """Forwards every store op to the pooled incremental store AND the
    brute-force reference, asserting identical behaviour after each op
    (the port of the reference test's ``ShadowStore``)."""

    def __init__(self, inc: PrefixStore, ref: ReferencePrefixStore):
        self.inc, self.ref = inc, ref
        self.block_tokens = inc.block_tokens
        self.capacity = inc.capacity

    @property
    def evict_payload(self):
        return self.inc.evict_payload

    @evict_payload.setter
    def evict_payload(self, fn):
        self.inc.evict_payload = fn

    def _check(self):
        assert self.inc.eviction_log == self.ref.eviction_log

    def register_request(self, tokens):
        rid = self.inc.register_request(tokens)
        assert rid == self.ref.register_request(tokens)
        self._check()
        return rid

    def lookup(self, tokens):
        a = self.inc.lookup(tokens)
        b = self.ref.lookup(tokens)
        assert [n.uid for n in a] == [n.uid for n in b]
        self._check()
        return a

    def insert(self, tokens, payloads, nbytes_per_block):
        self.inc.insert(tokens, payloads, nbytes_per_block)
        self.ref.insert(tokens, lambda i, n: None, nbytes_per_block)
        self._check()
        rc, erc = self.ref._ref_counts()
        for bid in self.inc._nodes:
            assert self.inc.state.ref_count.get(bid, 0) == rc.get(bid, 0)
            assert self.inc.state.eff_ref_count.get(bid, 0) == \
                erc.get(bid, 0)

    def complete_request(self, rid):
        self.inc.complete_request(rid)
        self.ref.complete_request(rid)
        self._check()

    def metrics(self):
        m = self.inc.metrics()
        assert m == self.ref.metrics()
        return m


@pytest.fixture(scope="module")
def model():
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


def workload(vocab, n_requests=8, n_families=3, seed=7):
    """Shared-prefix requests with uniform lengths."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    return [prefixes[i % n_families]
            + list(rng.integers(0, vocab, BT)) for i in range(n_requests)]


def capacity(cfg, params):
    probe = ServeEngine(cfg, params, max_slots=2, max_seq=64,
                        store=PrefixStore(1 << 30, "lerc", block_tokens=BT),
                        pool_blocks=1, device="cpu")
    return probe._block_nbytes() * 10           # < working set -> evictions


def _legacy(cfg, params, cap, slots):
    legacy = LegacyServeEngine(
        cfg, params, max_slots=slots, max_seq=64,
        store=PrefixStore(cap, "lerc", block_tokens=BT), device="cpu")
    lreqs = [legacy.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
    legacy.run()
    return legacy, lreqs


@pytest.mark.parametrize("slots", [1, 2])
def test_legacy_engine_matches_reference(model, slots):
    """Same weights and workload: identical tokens, eviction log, prefix
    reuse, steps and metrics; the block size the store is charged is the
    reference's."""
    jcfg, tcfg, np_params, tparams = model
    cap = capacity(tcfg, tparams)
    jeng = JaxLegacy(jcfg, np_params, max_slots=slots, max_seq=64,
                     store=JaxStore(cap, "lerc", block_tokens=BT))
    jreqs = [jeng.submit(r, max_new=MAX_NEW) for r in workload(jcfg.vocab)]
    jeng.run()
    teng, treqs = _legacy(tcfg, tparams, cap, slots)
    assert jeng.store.evictions > 0, "workload produced no pressure"
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.store.eviction_log == jeng.store.eviction_log
    assert [r.prefill_skipped for r in treqs] == \
        [r.prefill_skipped for r in jreqs]
    assert teng._block_nbytes() == jeng._block_nbytes()
    assert teng.steps == jeng.steps
    assert teng.metrics() == jeng.metrics()
    # payloads are host arrays holding the slot's KV
    node = next(n for n in teng.store._nodes.values() if n.resident)
    assert all(isinstance(a, np.ndarray) for a in node.payload.values())


def test_pooled_chunked_engine_matches_legacy(model):
    """Single slot: the store-op stream is strictly sequential (lookup →
    insert → complete per request), so it is chunk-invariant —
    generations AND eviction logs must be identical across prefill_chunk
    and vs the legacy engine."""
    _, cfg, _, params = model
    cap = capacity(cfg, params)
    legacy, lreqs = _legacy(cfg, params, cap, 1)
    assert legacy.store.evictions > 0, "workload produced no pressure"

    for chunk in (1, 4, 8):
        inc = PrefixStore(cap, "lerc", block_tokens=BT)
        ref = ReferencePrefixStore(cap, "lerc", block_tokens=BT)
        eng = ServeEngine(cfg, params, max_slots=1, max_seq=64,
                          store=ShadowStore(inc, ref), prefill_chunk=chunk,
                          device="cpu")
        ereqs = [eng.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
        eng.run()

        assert [r.generated for r in ereqs] == \
            [r.generated for r in lreqs], f"prefill_chunk={chunk}"
        assert inc.eviction_log == legacy.store.eviction_log, \
            f"prefill_chunk={chunk}"
        assert inc.eviction_log == ref.eviction_log
        assert [r.prefill_skipped for r in ereqs] == \
            [r.prefill_skipped for r in lreqs]
        # the hit/insert path never leaves the device: payloads are pool
        # indices, not host arrays
        for node in inc._nodes.values():
            if node.resident:
                assert isinstance(node.payload, int)
        assert eng.prefill_tokens == legacy.prefill_tokens
        if chunk > 1:
            assert eng.steps < legacy.steps


def test_continuous_batching_matches_legacy(model):
    """Multi-slot. At chunk=1 the engines are dispatch-for-dispatch
    identical, so the full store trace must match. At chunk>1 the timing
    of store ops across slots shifts, so eviction decisions may differ —
    but generations are KV-exact and must stay token-identical."""
    _, cfg, _, params = model
    cap = capacity(cfg, params)
    legacy, lreqs = _legacy(cfg, params, cap, 2)

    for chunk in (1, 8):
        st = PrefixStore(cap, "lerc", block_tokens=BT)
        eng = ServeEngine(cfg, params, max_slots=2, max_seq=64, store=st,
                          prefill_chunk=chunk, device="cpu")
        ereqs = [eng.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
        eng.run()
        assert [r.generated for r in ereqs] == \
            [r.generated for r in lreqs], f"prefill_chunk={chunk}"
        if chunk == 1:
            assert st.eviction_log == legacy.store.eviction_log
            assert [r.prefill_skipped for r in ereqs] == \
                [r.prefill_skipped for r in lreqs]
            assert eng.steps == legacy.steps


def test_legacy_engine_defaults_to_the_gpu(model):
    """No device means the card, as for every entry point of the port."""
    _, cfg, _, params = model
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LegacyServeEngine(cfg, params, max_slots=1, max_seq=16)
