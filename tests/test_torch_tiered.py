"""The port's compressed KV tier ladder (``TieredKVStore`` with the host and
disk pools, ``KVBlockPool.read_rows``/``write_rows``) against the
reference's, on the CPU, qwen2-7b smoke in f32 with the reference's
weights carried over by the bridge.

Each case is written once against a namespace of the package's classes
and runs on the reference and on the port; its assertions are the
reference case's, and it returns what it observed — generated tokens,
``eviction_log``, ``host_eviction_log``, ``disk_eviction_log`` and the
full ``metrics()`` where the reference case holds them — which must be
equal across packages. The cases are ``tests/test_tiered_store.py``'s
bar the sharded one (tier disabled, promotion without recompute,
``kv_quant="none"``, the int8 budget, the disk tier),
``test_paged_tiered_promotion_into_block_tables``
(``tests/test_engine_equivalence.py``) and the tiered cases of
``tests/test_faults.py`` (empty plan, disk quarantine, write failures,
promotion stalls and timeouts, a cancel racing a promotion, the disk
pool's teardown). In int8 the port's tokens equal the reference's here
too. Then the pools alone: the device pool's row transfers and the host
pool's rows equal the reference's bit for bit (f32 and bf16; lossless,
int8, fp8), rows are written in place, and a bf16 tier keeps 2-byte rows
and restores them exactly.
"""
import os
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.faults  # noqa: E402
import repro.serve  # noqa: E402
import repro.serve.host_pool  # noqa: E402
import repro.serve.kv_pool  # noqa: E402
import repro_torch.faults  # noqa: E402
import repro_torch.serve  # noqa: E402
import repro_torch.serve.host_pool  # noqa: E402
import repro_torch.serve.kv_pool  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro import quant as rq  # noqa: E402
from repro.models import init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import quant as pq  # noqa: E402
from repro_torch.models import init_params, model_spec  # noqa: E402
from repro_torch.models import params_from_numpy, tree_paths  # noqa: E402
from repro_torch.models.common import tree_map, unflatten  # noqa: E402
from repro_torch.models.lm import cache_shapes  # noqa: E402

BT = 8          # block_tokens
PROMPT = 40     # uniform prompt length (5 blocks: 4 prefix + 1 suffix)
MAX_NEW = 4
EQ_PROMPT = 32  # tests/test_engine_equivalence.py's prompt length


@pytest.fixture(scope="module")
def pkgs():
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                              dtype=jnp.float32)
    tparams = params_from_numpy(jax.device_get(jparams))
    ref = SimpleNamespace(name="ref", serve=repro.serve,
                          faults=repro.faults, cfg=jcfg, params=jparams,
                          kw={})
    port = SimpleNamespace(name="port", serve=repro_torch.serve,
                           faults=repro_torch.faults, cfg=tcfg,
                           params=tparams, kw={"device": "cpu"})
    return ref, port


def _both(pkgs, case, **kw):
    """Run ``case`` on the reference's classes and on the port's; their
    observations must be equal."""
    out = [case(pkg, **kw) for pkg in pkgs]
    assert out[1] == out[0]
    return out[1]


def _engine(pkg, store, **kw):
    return pkg.serve.ServeEngine(pkg.cfg, pkg.params, store=store,
                                 **{"max_slots": 1, "max_seq": 64,
                                    "prefill_chunk": BT, **kw, **pkg.kw})


def _blk(pkg):
    probe = _engine(pkg, pkg.serve.PrefixStore(1 << 30, "lerc",
                                               block_tokens=BT),
                    max_slots=2, pool_blocks=1)
    return probe._block_nbytes()


def workload(vocab, n_requests=12, n_families=4, seed=3,
             prompt=PROMPT):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, prompt - BT))
                for _ in range(n_families)]
    return [prefixes[i % n_families]
            + list(rng.integers(0, vocab, BT)) for i in range(n_requests)]


def _serve(eng, reqs):
    out = [eng.submit(r, max_new=MAX_NEW) for r in reqs]
    eng.run()
    return out


def _logs(store):
    return (store.eviction_log, store.host_eviction_log,
            store.disk_eviction_log)


# ---------------------------------------------------------------------------
# tests/test_tiered_store.py
# ---------------------------------------------------------------------------

def test_host_tier_disabled_is_bit_identical(pkgs):
    """host_capacity 0 (the --host-cache-kb 0 path): every op — tokens,
    eviction log, counters — identical to the single-tier engine."""
    def case(pkg):
        S = pkg.serve
        reqs = workload(pkg.cfg.vocab)
        cap = _blk(pkg) * 8                      # < working set: evictions
        plain = _engine(pkg, S.PrefixStore(cap, "lerc", block_tokens=BT))
        tiered = _engine(pkg, S.TieredKVStore(cap, "lerc", block_tokens=BT,
                                              host_capacity_bytes=0))
        preqs = _serve(plain, reqs)
        treqs = _serve(tiered, reqs)
        assert plain.store.evictions > 0, "workload produced no pressure"
        assert [r.generated for r in treqs] == [r.generated for r in preqs]
        assert tiered.store.eviction_log == plain.store.eviction_log
        assert [r.prefill_skipped for r in treqs] == \
            [r.prefill_skipped for r in preqs]
        pm, tm = plain.metrics(), tiered.metrics()
        assert all(tm[k] == pm[k] for k in pm
                   if k not in ("host_blocks", "host_blocks_in_use",
                                "host_high_water"))
        assert tm["demotions"] == tm["promotions"] == tm["tier1_hits"] == 0
        return [r.generated for r in treqs], _logs(tiered.store), tm, pm

    _both(pkgs, case)


def test_promotion_serves_evicted_prefix_without_recompute(pkgs):
    """After device pressure demotes a family's chain, re-referencing it
    is served by promotion: the engine skips prefill for every demoted
    block and the generated tokens equal the recompute path's."""
    def case(pkg):
        S = pkg.serve
        blk = _blk(pkg)
        rng = np.random.default_rng(17)
        vocab = pkg.cfg.vocab
        fam_a = list(rng.integers(0, vocab, PROMPT - BT))
        others = [list(rng.integers(0, vocab, PROMPT)) for _ in range(3)]
        suffix1 = list(rng.integers(0, vocab, BT))
        suffix2 = list(rng.integers(0, vocab, BT))

        def run_engine(host_blocks):
            store = S.TieredKVStore(blk * 6, "lerc", block_tokens=BT,
                                    host_capacity_bytes=blk * host_blocks) \
                if host_blocks else \
                S.PrefixStore(blk * 6, "lerc", block_tokens=BT)
            eng = _engine(pkg, store)
            _serve(eng, [fam_a + suffix1])           # warm family A
            _serve(eng, others)                      # pressure demotes A
            pre_prefill = eng.prefill_tokens
            req = _serve(eng, [fam_a + suffix2])[0]  # re-reference A
            return eng, req, eng.prefill_tokens - pre_prefill

        tiered, treq, trecompute = run_engine(host_blocks=64)
        m = tiered.metrics()
        assert m["demotions"] > 0, "no device pressure"
        assert m["promotions"] >= 4, "prefix chain was not promoted"
        assert m["tier1_hits"] >= 4
        assert treq.prefill_skipped == PROMPT - BT
        assert trecompute == BT
        plain, preq, precompute = run_engine(host_blocks=0)
        assert precompute > BT, "recompute baseline unexpectedly warm"
        assert treq.generated == preq.generated
        return treq.generated, _logs(tiered.store), m, plain.metrics()

    _both(pkgs, case)


def test_kv_quant_none_is_bit_identical(pkgs):
    """kv_quant="none" takes the exact pre-quant paths: tokens, both
    eviction logs, and the FULL metrics dict match a default-constructed
    tiered store."""
    def case(pkg):
        S = pkg.serve
        reqs = workload(pkg.cfg.vocab)
        blk = _blk(pkg)
        cap, host_cap = blk * 8, blk * 10
        base = _engine(pkg, S.TieredKVStore(cap, "lerc", block_tokens=BT,
                                            host_capacity_bytes=host_cap))
        loss = _engine(pkg, S.TieredKVStore(cap, "lerc", block_tokens=BT,
                                            host_capacity_bytes=host_cap,
                                            kv_quant="none"))
        breqs = _serve(base, reqs)
        lreqs = _serve(loss, reqs)
        assert base.store.metrics_obj.demotions > 0, "no tier traffic"
        assert base.store.metrics_obj.promotions > 0
        assert [r.generated for r in lreqs] == [r.generated for r in breqs]
        assert loss.store.eviction_log == base.store.eviction_log
        assert loss.store.host_eviction_log == base.store.host_eviction_log
        assert loss.metrics() == base.metrics()
        assert loss.metrics()["quantized_demotions"] == 0
        assert "kv_quant" not in loss.metrics()
        return [r.generated for r in lreqs], _logs(loss.store), loss.metrics()

    _both(pkgs, case)


def _agree(a, b):
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n / max(len(a), 1)


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantized_promotion_within_divergence_budget(pkgs, kv_quant):
    """Quantized demotion is lossy by design; the reference's gate is a
    measured token-quality budget: mean leading-token agreement with the
    lossless engine >= 0.5, with the transcode path exercised. Across
    packages the logs and metrics are equal, and so are the tokens: the
    port's quantize stores the reference's bytes on these rows."""
    def case(pkg):
        S = pkg.serve
        reqs = workload(pkg.cfg.vocab)
        blk = _blk(pkg)
        cap, host_cap = blk * 8, blk * 10

        def run(q):
            eng = _engine(pkg, S.TieredKVStore(cap, "lerc", block_tokens=BT,
                                               host_capacity_bytes=host_cap,
                                               kv_quant=q))
            return eng, _serve(eng, reqs)

        lossless, lreqs = run(None)
        quantized, qreqs = run(kv_quant)
        m = quantized.metrics()
        assert m["quantized_demotions"] > 0, "nothing was transcoded"
        assert m["dequantized_promotions"] > 0, "no quantized chain promoted"
        assert m["host_compression_ratio"] > 1.5
        scores = [_agree(q.generated, l.generated)
                  for q, l in zip(qreqs, lreqs)]
        assert sum(scores) / len(scores) >= 0.5, scores
        return [r.generated for r in qreqs], _logs(quantized.store), m

    _both(pkgs, case)


def test_disk_tier_promotion_is_lossless_and_disk_evicts(pkgs):
    """Blocks that fell two rungs (device -> host -> memmap file) promote
    straight back to the device pool and generate exactly the big-cache
    tokens; an undersized disk rung exercises the third eviction index."""
    def case(pkg):
        S = pkg.serve
        reqs = workload(pkg.cfg.vocab)
        blk = _blk(pkg)
        big = _engine(pkg, S.PrefixStore(1 << 30, "lerc", block_tokens=BT))
        breqs = _serve(big, reqs)
        disk = _engine(pkg, S.TieredKVStore(blk * 8, "lerc", block_tokens=BT,
                                            host_capacity_bytes=blk * 3,
                                            disk_capacity_bytes=blk * 64))
        dreqs = _serve(disk, reqs)
        m = disk.metrics()
        assert m["disk_demotions"] > 0, "host pressure never reached disk"
        assert m["disk_promotions"] > 0, "no chain came back from disk"
        assert m["tier2_hits"] > 0
        assert [r.generated for r in dreqs] == [r.generated for r in breqs]
        tiny = _engine(pkg, S.TieredKVStore(blk * 8, "lerc", block_tokens=BT,
                                            host_capacity_bytes=blk * 3,
                                            disk_capacity_bytes=blk * 4))
        _serve(tiny, reqs)
        tm = tiny.metrics()
        assert tm["disk_evictions"] > 0
        assert len(tiny.store.disk_eviction_log) == tm["disk_evictions"]
        out = ([r.generated for r in dreqs], _logs(disk.store), m,
               _logs(tiny.store), tm)
        disk.close()
        tiny.close()
        return out

    _both(pkgs, case)


# ---------------------------------------------------------------------------
# tests/test_engine_equivalence.py
# ---------------------------------------------------------------------------

def test_paged_tiered_promotion_into_block_tables(pkgs):
    """TieredKVStore under the paged plane: demoted chains promote back
    into pool rows that prefix hits then reference via block tables —
    token-identical to the gather plane with the same tier config, same
    eviction/demotion/promotion stream."""
    def case(pkg):
        S = pkg.serve
        reqs = workload(pkg.cfg.vocab, n_requests=10, n_families=2, seed=3,
                        prompt=EQ_PROMPT)
        blk = _blk(pkg)
        results = {}
        for paged in (False, True):
            st = S.TieredKVStore(blk * 6, "lerc", block_tokens=BT,
                                 host_capacity_bytes=blk * 64)
            eng = _engine(pkg, st, max_slots=2, prefill_chunk=8, paged=paged)
            results[paged] = (_serve(eng, reqs), st, eng.metrics())
        (grs, gst, _), (prs, pst, pm) = results[False], results[True]
        assert pst.metrics_obj.promotions > 0, "no promotion exercised"
        assert [r.generated for r in prs] == [r.generated for r in grs]
        assert pst.eviction_log == gst.eviction_log
        assert pst.host_eviction_log == gst.host_eviction_log
        assert pst.metrics_obj.demotions == gst.metrics_obj.demotions
        assert pst.metrics_obj.promotions == gst.metrics_obj.promotions
        return [r.generated for r in prs], _logs(pst), pm

    _both(pkgs, case)


# ---------------------------------------------------------------------------
# tests/test_faults.py, the tiered cases
# ---------------------------------------------------------------------------

def test_empty_plan_bit_identity_tiered(pkgs):
    """A tiered engine carrying an empty-plan injector is op-for-op the
    healthy engine: tokens, all three eviction logs, full metrics dict."""
    def case(pkg):
        S = pkg.serve
        blk = _blk(pkg)
        reqs = workload(pkg.cfg.vocab)

        def run(injector):
            store = S.TieredKVStore(6 * blk, "lerc", block_tokens=BT,
                                    host_capacity_bytes=3 * blk,
                                    disk_capacity_bytes=64 * blk)
            store.faults = injector
            eng = _engine(pkg, store)
            rs = [eng.submit(r, max_new=MAX_NEW) for r in reqs]
            eng.run()
            m = eng.metrics()
            eng.close()
            return [r.generated for r in rs], store, m

        base_toks, base_st, base_m = run(None)
        toks, st, m = run(pkg.faults.FaultPlan().injector())
        assert base_st.evictions > 0, "workload produced no pressure"
        assert toks == base_toks
        assert _logs(st) == _logs(base_st)
        assert m == base_m
        return toks, _logs(st), m

    _both(pkgs, case)


def test_disk_quarantine_graceful(pkgs):
    """Every disk read fails: after ``quarantine_after`` consecutive
    errors the tier is fenced, the run completes with zero uncaught
    exceptions, and the store degrades to two-tier semantics."""
    def case(pkg):
        S = pkg.serve
        blk = _blk(pkg)
        store = S.TieredKVStore(8 * blk, "lerc", block_tokens=BT,
                                host_capacity_bytes=3 * blk,
                                disk_capacity_bytes=64 * blk)
        store.faults = pkg.faults.FaultPlan(disk_read_error_p=1.0,
                                            quarantine_after=2).injector()
        eng = _engine(pkg, store, max_seq=96)
        rng = np.random.default_rng(5)
        prefixes = [list(rng.integers(0, pkg.cfg.vocab, 32))
                    for _ in range(3)]
        suffix = list(rng.integers(0, pkg.cfg.vocab, BT))
        done, toks = 0, []
        for pfx in prefixes:                     # warm: demote down
            r = eng.submit(pfx + suffix, max_new=MAX_NEW)
            eng.run()
            done += r.done
            toks.append(r.generated)
        for pfx in prefixes:                     # re-reference: reads fail
            r = eng.submit(list(pfx), max_new=MAX_NEW)
            eng.run()
            done += r.done
            toks.append(r.generated)
        m = eng.metrics()
        eng.close()
        assert done == 2 * len(prefixes), "degraded engine dropped requests"
        assert m["disk_quarantines"] == 1
        assert m["disk_io_errors"] >= 2
        assert store.disk_quarantined and not store.disk_tiered
        return toks, _logs(store), m

    _both(pkgs, case)


def test_disk_write_failures_count_but_reads_reset(pkgs):
    """The consecutive-error counter resets only on a successful disk
    read: a disk that accepts demotion writes but fails every promote
    quarantines anyway."""
    def case(pkg):
        S = pkg.serve
        blk = _blk(pkg)
        store = S.TieredKVStore(6 * blk, "lerc", block_tokens=BT,
                                host_capacity_bytes=2 * blk,
                                disk_capacity_bytes=64 * blk)
        store.faults = pkg.faults.FaultPlan(disk_read_error_p=1.0,
                                            quarantine_after=3).injector()
        eng = _engine(pkg, store, max_seq=96)
        rng = np.random.default_rng(9)
        prefixes = [list(rng.integers(0, pkg.cfg.vocab, 32))
                    for _ in range(4)]
        toks = []
        for i in range(2):
            for pfx in prefixes:
                toks.append(_serve(eng, [pfx + [i]])[0].generated)
                toks.append(_serve(eng, [list(pfx)])[0].generated)
        m = eng.metrics()
        eng.close()
        assert m["disk_quarantines"] == 1
        assert m["disk_demotions"] > 0, "no successful writes interleaved"
        return toks, _logs(store), m

    _both(pkgs, case)


def _promotion_workload(pkg, blk, plan):
    store = pkg.serve.TieredKVStore(6 * blk, "lerc", block_tokens=BT,
                                    host_capacity_bytes=64 * blk)
    if plan is not None:
        store.faults = plan.injector()
    eng = _engine(pkg, store)
    rs = _serve(eng, workload(pkg.cfg.vocab))
    return eng, store, [r.generated for r in rs]


def test_promotion_stall_charged_to_clock_exactly(pkgs):
    """Every promotion stalls 2.0 virtual-seconds: tokens unchanged, and
    the engine clock lands exactly ``stalls * 2.0`` past the clean run's
    (the stall drains into ``now`` once per step, after compute)."""
    def case(pkg):
        blk = _blk(pkg)
        clean_eng, clean_st, clean_toks = _promotion_workload(pkg, blk, None)
        assert clean_st.metrics_obj.promotions > 0
        eng, st, toks = _promotion_workload(
            pkg, blk, pkg.faults.FaultPlan(promotion_stall_p=1.0,
                                           promotion_stall=2.0))
        stalls = st.metrics_obj.promotion_stalls
        assert stalls > 0
        assert toks == clean_toks
        assert st.metrics_obj.promotions == clean_st.metrics_obj.promotions
        assert eng.now == pytest.approx(clean_eng.now + 2.0 * stalls)
        return toks, _logs(st), eng.metrics(), clean_eng.now

    _both(pkgs, case)


def test_promotion_timeout_abandons_and_recomputes(pkgs):
    """Stall (2.0) past the timeout (1.0): every promotion is abandoned
    before any index/payload mutation — the chain recomputes through
    prefill, tokens unchanged, and no stall is charged."""
    def case(pkg):
        blk = _blk(pkg)
        _, clean_st, clean_toks = _promotion_workload(pkg, blk, None)
        eng, st, toks = _promotion_workload(
            pkg, blk, pkg.faults.FaultPlan(promotion_stall_p=1.0,
                                           promotion_stall=2.0,
                                           promotion_timeout=1.0))
        m = st.metrics_obj
        assert m.promotion_timeouts > 0
        assert m.promotion_stalls == 0
        assert toks == clean_toks
        assert m.promotions < clean_st.metrics_obj.promotions
        assert eng.prefill_tokens > 0
        return toks, _logs(st), eng.metrics()

    _both(pkgs, case)


def test_cancel_racing_promotion(pkgs):
    """Cancel a request whose chain was just promoted from the host tier,
    mid-prefill: rows return to the pool, the store's pending references
    retire, and the engine keeps serving. Repeats with the promotion
    abandoned by timeout."""
    def case(pkg):
        S = pkg.serve
        blk = _blk(pkg)
        obs = []
        for plan in (None,
                     pkg.faults.FaultPlan(promotion_stall_p=1.0,
                                          promotion_stall=2.0,
                                          promotion_timeout=1.0)):
            store = S.TieredKVStore(6 * blk, "lerc", block_tokens=BT,
                                    host_capacity_bytes=64 * blk)
            if plan is not None:
                store.faults = plan.injector()
            eng = _engine(pkg, store, max_slots=2)
            rng = np.random.default_rng(2)
            vocab = pkg.cfg.vocab
            fam = list(rng.integers(0, vocab, PROMPT - BT))
            eng.submit(fam + list(rng.integers(0, vocab, BT)),
                       max_new=MAX_NEW)
            eng.run()
            for _ in range(8):
                eng.submit(list(rng.integers(0, vocab, PROMPT)),
                           max_new=MAX_NEW)
                eng.run()
            mo = store.metrics_obj
            base = mo.promotions + mo.promotion_timeouts
            victim = eng.submit(fam + list(rng.integers(0, vocab, BT)),
                                max_new=MAX_NEW)
            eng.step()                     # promotion (or timeout) fires
            assert (mo.promotions + mo.promotion_timeouts) > base
            assert not victim.done
            assert eng.cancel(victim)
            assert victim.cancelled and not eng.cancel(victim)
            other = eng.submit(fam + list(rng.integers(0, vocab, BT)),
                               max_new=MAX_NEW)
            eng.run()
            assert other.done and len(other.generated) == MAX_NEW
            resident = sum(1 for n in store._nodes.values() if n.resident)
            assert eng.pool.blocks_in_use <= resident + 1
            assert eng.metrics()["cancellations"] == 1
            obs.append((victim.generated, other.generated, _logs(store),
                        eng.metrics(), eng.pool.blocks_in_use))
        return obs

    _both(pkgs, case)


def test_disk_pool_close_unlinks_files(pkgs):
    def case(pkg):
        S = pkg.serve
        blk = _blk(pkg)
        with tempfile.TemporaryDirectory() as d:
            store = S.TieredKVStore(6 * blk, "lerc", block_tokens=BT,
                                    host_capacity_bytes=2 * blk,
                                    disk_capacity_bytes=64 * blk,
                                    disk_dir=d)
            eng = _engine(pkg, store, max_seq=96)
            for r in workload(pkg.cfg.vocab, n_requests=6):
                eng.submit(r, max_new=MAX_NEW)
                eng.run()
            pool = store.disk_pool
            assert pool._paths and all(os.path.exists(p)
                                       for p in pool._paths)
            paths = list(pool._paths)
            names = sorted(os.path.basename(p) for p in paths)
            m = eng.metrics()
            eng.close()                # cascades store.close -> pool.close
            assert pool.closed
            assert not any(os.path.exists(p) for p in paths)
            eng.close()                # idempotent
        return names, _logs(store), m

    _both(pkgs, case)


# ---------------------------------------------------------------------------
# the pools alone
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    """The bytes of a host array or a CPU tensor of either package, as
    unsigned integers of the element's width."""
    a = pq.to_host(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _pools(dtype, num_blocks=6):
    """A reference and a port device pool over qwen2-7b smoke's KV tree in
    ``dtype`` ("float32" or "bfloat16"), holding the same random rows."""
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(
        dtype=jnp.dtype(dtype))
    tcfg = configs.get("qwen2_7b", smoke=True).replace(
        dtype=getattr(torch, dtype))
    jtemplate = init_decode_cache(jcfg, 1, 8)
    ttemplate = tree_map(
        lambda s: torch.empty(s, dtype=tcfg.dtype, device="meta"),
        cache_shapes(tcfg, 1, 8))
    jpool = repro.serve.kv_pool.KVBlockPool(jtemplate, BT, num_blocks)
    tpool = repro_torch.serve.kv_pool.KVBlockPool(ttemplate, BT, num_blocks,
                                                  "cpu")
    rng = np.random.default_rng(0)
    fill = {}
    for path, buf in tree_paths(tpool.buffers):
        vals = rng.standard_normal(tuple(buf.shape)) * 3.0
        jarr = jnp.asarray(vals, jnp.dtype(dtype))
        fill[path] = jarr
        buf.copy_(pq.from_host(_bits(jarr).copy().view(
            pq.storage_dtype(buf.dtype))))
    jpool.buffers = jax.tree_util.tree_map_with_path(
        lambda p, _: fill[tuple(k.key for k in p)], jpool.buffers)
    return jpool, tpool, jtemplate, ttemplate


def _assert_trees_equal(port_tree, ref_tree, rtol=None):
    """Equal bit for bit, or, with ``rtol``, in value within it."""
    ref = dict(tree_paths(jax.device_get(ref_tree)))
    got = dict(tree_paths(port_tree))
    assert got.keys() == ref.keys()
    for path in got:
        if rtol is None:
            np.testing.assert_array_equal(_bits(got[path]),
                                          _bits(ref[path]),
                                          err_msg=str(path))
        else:
            np.testing.assert_allclose(got[path], ref[path], rtol=rtol,
                                       err_msg=str(path))


def _port_host(tree):
    """The reference's host rows (``ml_dtypes`` bf16/fp8 arrays) in the
    port's host storage dtypes, bits unchanged."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name in ("bfloat16", "float8_e4m3fn"):
            return _bits(a).copy()
        return a
    return unflatten({p: conv(a) for p, a in tree_paths(tree)})


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_pool_row_transfers_match_reference(dtype, quant):
    """``read_rows`` returns the reference's stacked rows (and scales)
    bit for bit, in host storage dtypes; ``write_rows`` of the same host
    rows (and scales) leaves the reference's pool contents; both write
    into the existing buffers (same tensors, same storage)."""
    jpool, tpool, _, _ = _pools(dtype)
    idxs = [4, 1, 3]
    rspec, pspec = rq.get_spec(quant), pq.get_spec(quant)
    want = jpool.read_rows(idxs, quant=rspec)
    got = tpool.read_rows(idxs, quant=pspec)
    if quant is None:
        _assert_trees_equal(got, want)
    else:
        # the reference's own bar for its jnp path against a division
        # (tests/test_quant.py): identical bytes, scales within 2e-7
        _assert_trees_equal(got[0], want[0])
        _assert_trees_equal(got[1], want[1], rtol=2e-7)
    before = [(b, b.data_ptr()) for _, b in tree_paths(tpool.buffers)]
    dst = [0, 5, 2]
    if quant is None:
        jpool.write_rows(dst, want)
        tpool.write_rows(dst, _port_host(want))
    else:
        jpool.write_rows(dst, want[0], want[1])
        tpool.write_rows(dst, _port_host(want[0]), _port_host(want[1]))
    _assert_trees_equal(tpool.buffers, jpool.buffers)
    after = [(b, b.data_ptr()) for _, b in tree_paths(tpool.buffers)]
    assert all(a[0] is b[0] and a[1] == b[1] for a, b in zip(before, after))


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_pool_rows_match_reference(dtype, quant):
    """The host pool stores and returns the reference's bytes: a bf16 pool
    keeps 2-byte ``uint16`` rows (never widened: its block prices the
    reference's bytes), an int8 pool 1-byte rows and f32 scales."""
    jpool, tpool, jtemplate, ttemplate = _pools(dtype)
    rspec, pspec = rq.get_spec(quant), pq.get_spec(quant)
    jhost = repro.serve.host_pool.HostBlockPool.for_device_pool(
        jtemplate, jpool, 10 * jpool.block_nbytes, quant=rspec)
    thost = repro_torch.serve.host_pool.HostBlockPool.for_device_pool(
        ttemplate, tpool, 10 * tpool.block_nbytes, quant=pspec)
    assert thost.num_blocks == jhost.num_blocks
    assert thost.block_nbytes == jhost.block_nbytes
    for _, buf in tree_paths(thost.buffers):
        assert buf.dtype == (pspec.storage if quant
                             else pq.storage_dtype(getattr(torch, dtype)))
    src, dst = [5, 0, 2], [7, 3, 9]
    # the same device rows (the reference's read) into both host pools
    out = jpool.read_rows(src, quant=rspec)
    if quant is None:
        jhost.write_rows(dst, out)
        thost.write_rows(dst, _port_host(out))
    else:
        jhost.write_rows(dst, out[0], out[1])
        thost.write_rows(dst, _port_host(out[0]), _port_host(out[1]))
    _assert_trees_equal(thost.buffers, jhost.buffers)
    got, want = thost.read_rows([9, 7]), jhost.read_rows([9, 7])
    if quant is None:
        _assert_trees_equal(got, want)
    else:
        _assert_trees_equal(got[0], want[0])
        _assert_trees_equal(got[1], want[1])
        _assert_trees_equal(thost.scales, jhost.scales)


def test_bf16_tiers_restore_rows_exactly():
    """bf16 (the configs' dtype) through a lossless host tier and a disk
    tier: a promotion restores the demoted rows' exact bytes, so the
    engine generates the unbounded store's tokens in the same steps; an
    int8 tier holds ~2x the blocks of the same host budget."""
    cfg = configs.get("qwen2_7b", smoke=True)          # bf16
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype=cfg.dtype)
    S = repro_torch.serve
    reqs = workload(cfg.vocab)

    def run(store):
        eng = S.ServeEngine(cfg, params, max_slots=1, max_seq=64,
                            store=store, prefill_chunk=BT, paged=True,
                            device="cpu")
        rs = _serve(eng, reqs)
        return eng, [r.generated for r in rs]

    big, big_toks = run(S.PrefixStore(1 << 30, "lerc", block_tokens=BT))
    blk = big.pool.block_nbytes
    tiered, toks = run(S.TieredKVStore(blk * 8, "lerc", block_tokens=BT,
                                       host_capacity_bytes=blk * 3,
                                       disk_capacity_bytes=blk * 64))
    m = tiered.metrics()
    assert m["promotions"] > 0 and m["disk_promotions"] > 0
    assert tiered.steps == big.steps
    assert toks == big_toks
    hp = tiered.store.host_pool
    assert all(b.dtype == np.uint16 for _, b in tree_paths(hp.buffers))
    assert hp.block_nbytes == blk
    tiered.close()
    q, _ = run(S.TieredKVStore(blk * 8, "lerc", block_tokens=BT,
                               host_capacity_bytes=blk * 3, kv_quant="int8"))
    assert q.store.host_pool.num_blocks == \
        blk * 3 // q.store.host_pool.block_nbytes >= 5
