"""The port's sharded serve tier (``ShardedFrontend``, ``route_prefix``)
against the reference's, on the CPU, qwen2-7b smoke in f32 with the
reference's weights carried over by the bridge.

Each case is written once against a namespace of the package's classes and
runs on the reference and on the port; its assertions are the reference
case's, and it returns what it observed — generated tokens, prefill skipped,
each shard's eviction logs and engine steps, the replicas' eviction logs
where they are recorded, and the full ``metrics()`` — which must be equal
across packages. The cases are ``tests/test_sharded_serve.py``'s four,
``test_paged_sharded_matches_gather_sharded``
(``tests/test_engine_equivalence.py``), ``test_tiered_sharded_matches_single``
(``tests/test_tiered_store.py``), the frontend cases of
``tests/test_faults.py`` (an empty plan, a shard crash under a lossy status
channel, a lossy channel alone) and the ``"sharded"`` case of
``tests/test_obs.py`` (tracing off against on, and the trace itself against
the reference's).

One difference is inherent to the port: pickle names a class by its
module, so every bus message that carries the DAG's dataclasses (a peer
profile, a resync snapshot with the DAG) is ``PROFILE_EXTRA`` (6) bytes
larger in the port's wire-size estimate. The ``msg_*`` byte counts are
compared less exactly that per such message; every other field is equal.
"""
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.faults  # noqa: E402
import repro.obs  # noqa: E402
import repro.serve  # noqa: E402
import repro_torch.faults  # noqa: E402
import repro_torch.obs  # noqa: E402
from repro_torch.obs.device import PORT_CATEGORIES  # noqa: E402
import repro_torch.serve  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.core import BlockMeta as JaxBlockMeta  # noqa: E402
from repro.core.coordination import payload_nbytes as jax_nbytes  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.sim import poisson_arrivals  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import BlockMeta  # noqa: E402
from repro_torch.core.coordination import LERC_KINDS  # noqa: E402
from repro_torch.core.coordination import payload_nbytes  # noqa: E402
from repro_torch.models import params_from_numpy, tree_paths  # noqa: E402

BT = 8          # block_tokens
MAX_NEW = 4
DEADLINE = 60.0

PROFILE_EXTRA = (payload_nbytes((BlockMeta("b", 1, "d", 0),))
                 - jax_nbytes((JaxBlockMeta("b", 1, "d", 0),)))
DAG_MODULE = BlockMeta.__module__.encode()


@pytest.fixture(scope="module")
def pkgs():
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                              dtype=jnp.float32)
    tparams = params_from_numpy(jax.device_get(jparams))
    ref = SimpleNamespace(name="ref", serve=repro.serve, faults=repro.faults,
                          obs=repro.obs, cfg=jcfg, params=jparams, kw={})
    port = SimpleNamespace(name="port", serve=repro_torch.serve,
                           faults=repro_torch.faults, obs=repro_torch.obs,
                           cfg=tcfg, params=tparams, kw={"device": "cpu"})
    return ref, port


def _both(pkgs, case, **kw):
    """Run ``case`` on the reference's classes and on the port's; their
    observations must be equal."""
    out = [case(P, **kw) for P in pkgs]
    assert out[1] == out[0]
    return out[1]


def workload(vocab, n_requests=12, n_families=4, seed=7, prompt=32):
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, prompt - BT))
                for _ in range(n_families)]
    return [prefixes[i % n_families]
            + list(rng.integers(0, vocab, BT)) for i in range(n_requests)]


def _blk(P):
    probe = P.serve.ServeEngine(
        P.cfg, P.params, max_slots=2, max_seq=64,
        store=P.serve.PrefixStore(1 << 30, "lerc", block_tokens=BT),
        pool_blocks=1, **P.kw)
    return probe._block_nbytes()


def _frontend(P, n_shards, **kw):
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_seq", 64)
    kw.setdefault("policy", "lerc")
    fe = P.serve.ShardedFrontend(P.cfg, P.params, n_shards,
                                 block_tokens=BT, **kw, **P.kw)
    if P.name == "port":
        _count_dag_messages(fe.bus)
    return fe


def _count_dag_messages(bus):
    """Count the messages whose payload pickles the DAG's dataclasses (a
    peer profile; a resync snapshot of a non-empty DAG), all of them and
    those on the LERC channel: each weighs ``PROFILE_EXTRA`` bytes more in
    the port."""
    send = bus.send
    bus.dag_messages = {"all": 0, "lerc": 0}

    def counting_send(msg):
        if DAG_MODULE in pickle.dumps(msg.payload,
                                      protocol=pickle.HIGHEST_PROTOCOL):
            bus.dag_messages["all"] += 1
            bus.dag_messages["lerc"] += msg.kind in LERC_KINDS
        send(msg)

    bus.send = counting_send


def _single(P, store, reqs, **kw):
    eng = P.serve.ServeEngine(P.cfg, P.params, max_slots=1, max_seq=64,
                              store=store, **kw, **P.kw)
    rs = [eng.submit(r, max_new=MAX_NEW) for r in reqs]
    eng.run()
    return eng, rs


def _metrics(P, fe):
    """``fe.metrics()``, the port's ``msg_*`` bytes less ``PROFILE_EXTRA``
    for each message that carried the DAG's dataclasses: on the LERC
    channel exactly the peer profiles, one to every shard a broadcast."""
    m = fe.metrics()
    if P.name == "port":
        n = fe.bus.dag_messages
        assert n["lerc"] == fe.bus.stats.peer_profile_broadcasts * fe.n_shards
        m["msg_lerc_bytes"] -= PROFILE_EXTRA * n["lerc"]
        m["msg_payload_bytes"] -= PROFILE_EXTRA * n["all"]
    return m


def _observe(P, fe, rs):
    return {"tokens": [r.generated for r in rs],
            "skipped": [r.prefill_skipped for r in rs],
            "logs": [e.store.eviction_log for e in fe.shards],
            "host_logs": [getattr(e.store, "host_eviction_log", None)
                          for e in fe.shards],
            "steps": [e.steps for e in fe.shards],
            "replica_logs": [tr.eviction_log for tr in fe.trackers],
            "metrics": _metrics(P, fe)}


def _by_key(requests):
    """Cross-run token comparison key. rids are per-shard counters (they
    collide across shards), so identity is (prompt, arrival)."""
    return {(tuple(r.prompt), r.arrival): list(r.generated)
            for r in requests}


def _timed_trace(P, n_requests=12, rate=1.5, seed=3):
    reqs = workload(P.cfg.vocab, n_requests, seed=3, prompt=40)
    times = poisson_arrivals(n_requests, rate=rate, seed=seed)
    return [P.serve.TracedRequest(t=t, prompt=p, max_new=MAX_NEW,
                                  deadline=DEADLINE)
            for t, p in zip(times, reqs)]


# ------------------------------------------------------------ route_prefix

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("block_tokens", [1, 8, 16])
def test_route_prefix_matches_reference(n_shards, block_tokens):
    """The port's router is the reference's on seeded token lists, short
    prompts (routed on the whole prompt) and numpy integers included."""
    rng = np.random.default_rng(n_shards * 100 + block_tokens)
    lists = [list(rng.integers(0, 152_064, int(n)))
             for n in rng.integers(1, 40, 64)]
    got = [repro_torch.serve.route_prefix(t, n_shards, block_tokens)
           for t in lists]
    assert got == [repro.serve.route_prefix(t, n_shards, block_tokens)
                   for t in lists]
    assert set(got) <= set(range(n_shards))


# ------------------------------------------------ tests/test_sharded_serve.py

@pytest.fixture(scope="module")
def singles(pkgs):
    """The single engine of ``test_shards_token_identical`` and of the
    protocol-level case, on both packages (built once)."""
    out = {}
    for P in pkgs:
        reqs = workload(P.cfg.vocab)
        cap = _blk(P) * 10                     # < working set -> evictions
        for policy in ("lerc", "lru"):
            eng, rs = _single(P, P.serve.PrefixStore(cap, policy,
                                                     block_tokens=BT), reqs)
            out[P.name, policy] = (eng, rs)
    assert out["ref", "lerc"][0].store.evictions > 0, \
        "workload produced no pressure"
    return out


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shards_token_identical(pkgs, singles, n_shards):
    """--shards {1,2,4} produce the single engine's tokens; at K=1 the
    frontend is op-for-op the single engine (same eviction log and prefix
    reuse), and every run leaves all replicas coherent."""
    def case(P):
        single, sreqs = singles[P.name, "lerc"]
        reqs = workload(P.cfg.vocab)
        fe = _frontend(P, n_shards, capacity_bytes=_blk(P) * 10)
        rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
        fe.run()
        assert [r.generated for r in rs] == [r.generated for r in sreqs]
        fe.verify_replicas()
        if n_shards == 1:
            assert fe.shards[0].store.eviction_log == \
                single.store.eviction_log
            assert [r.prefill_skipped for r in rs] == \
                [r.prefill_skipped for r in sreqs]
            assert fe.shards[0].steps == single.steps
        return _observe(P, fe, rs)

    _both(pkgs, case)


def test_per_shard_eviction_logs_match_replicas(pkgs):
    """Each shard's eviction log appears, namespaced and in order, in every
    tracker's replica log; replica counters equal each shard's own state;
    one broadcast per report."""
    def case(P):
        reqs = workload(P.cfg.vocab, n_requests=16, seed=11)
        fe = _frontend(P, 2, capacity_bytes=_blk(P) * 10 // 2,
                       record_eviction_log=True)
        rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
        fe.run()
        total = 0
        for k, eng in enumerate(fe.shards):
            log = [f"s{k}:{b}" for b in eng.store.eviction_log]
            total += len(log)
            for tr in fe.trackers:
                assert [b for b in tr.eviction_log
                        if b.startswith(f"s{k}:")] == log
        assert total > 0, "workload produced no pressure"
        fe.verify_replicas()
        s = fe.bus.stats
        assert s.eviction_broadcasts == s.eviction_reports
        assert s.eviction_broadcasts <= total
        assert s.peer_profile_broadcasts == len(reqs)
        assert s.lerc_bytes > 0 and s.payload_bytes > s.lerc_bytes
        return _observe(P, fe, rs)

    _both(pkgs, case)


@pytest.mark.parametrize("policy", ["lru", "lrc"])
def test_protocol_level_follows_store_policy(pkgs, singles, policy):
    """A DAG-oblivious tier (lru) ships no LERC traffic and stays
    residency-coherent over the status channel; a DAG-aware but
    completeness-oblivious one (lrc) ships profiles and no reports."""
    def case(P):
        reqs = workload(P.cfg.vocab)
        fe = _frontend(P, 2, capacity_bytes=_blk(P) * 10, policy=policy)
        rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
        fe.run()
        s = fe.bus.stats
        assert s.eviction_reports == 0 and s.eviction_broadcasts == 0
        if policy == "lru":
            assert s.peer_profile_broadcasts == 0 and s.lerc_bytes == 0
            assert s.point_to_point > 0 and s.payload_bytes > 0
            assert sum(e.store.evictions for e in fe.shards) > 0
            assert [r.generated for r in rs] == \
                [r.generated for r in singles[P.name, "lru"][1]]
        else:
            assert s.peer_profile_broadcasts == len(reqs)
        fe.verify_replicas()
        return _observe(P, fe, rs)

    _both(pkgs, case)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_affinity_routing_preserves_prefix_reuse(pkgs, n_shards):
    """Same-family requests land on one shard: with ample capacity the
    skipped prefill tokens equal the single engine's at every K."""
    def case(P):
        reqs = workload(P.cfg.vocab)
        single, _ = _single(P, P.serve.PrefixStore(1 << 30, "lerc",
                                                   block_tokens=BT), reqs)
        fe = _frontend(P, n_shards, capacity_bytes=1 << 30)
        rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
        fe.run()
        assert sum(e.prefill_tokens_skipped for e in fe.shards) == \
            single.prefill_tokens_skipped
        assert [fe.shard_of(r) for r in reqs] == \
            [P.serve.route_prefix(r, n_shards, BT) for r in reqs]
        return _observe(P, fe, rs)

    _both(pkgs, case)


# ------------------------------------------ the planes and the tier ladder

_PLANES = {}


@pytest.mark.parametrize("paged", [False, True], ids=["gather", "paged"])
def test_paged_sharded_matches_gather_sharded(pkgs, paged):
    """2-shard frontend on each plane: the reference's tokens, per-shard
    eviction logs and metrics, replicas coherent; the port's paged shards
    give its gather shards' tokens and eviction logs."""
    def case(P):
        reqs = workload(P.cfg.vocab, n_requests=10, seed=5)
        fe = _frontend(P, 2, max_slots=2, capacity_bytes=_blk(P) * 10,
                       prefill_chunk=8, paged=paged)
        rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
        fe.run()
        fe.verify_replicas()
        assert all(e.paged == paged for e in fe.shards)
        return _observe(P, fe, rs)

    _PLANES[paged] = _both(pkgs, case)
    if len(_PLANES) == 2:
        assert _PLANES[True]["tokens"] == _PLANES[False]["tokens"]
        assert _PLANES[True]["logs"] == _PLANES[False]["logs"]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_tiered_sharded_matches_single(pkgs, n_shards):
    """Tiered shards (a host tier smaller than the spilled working set)
    give the single tiered engine's tokens, K=1 op for op (both eviction
    logs), and leave every replica coherent."""
    def case(P):
        reqs = workload(P.cfg.vocab, n_requests=16, seed=11, prompt=40)
        blk = _blk(P)
        cap, host_cap = blk * 8, blk * 10
        single, sreqs = _single(
            P, P.serve.TieredKVStore(cap, "lerc", block_tokens=BT,
                                     host_capacity_bytes=host_cap),
            reqs, prefill_chunk=BT)
        sm = single.store.metrics_obj
        assert sm.demotions > 0 and sm.promotions > 0
        assert sm.host_evictions > 0, "host tier produced no final evictions"
        fe = _frontend(P, n_shards, capacity_bytes=cap, prefill_chunk=BT,
                       host_capacity_bytes=host_cap)
        rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
        fe.run()
        assert [r.generated for r in rs] == [r.generated for r in sreqs]
        fe.verify_replicas()
        if n_shards == 1:
            assert fe.shards[0].store.eviction_log == \
                single.store.eviction_log
            assert fe.shards[0].store.host_eviction_log == \
                single.store.host_eviction_log
            assert [r.prefill_skipped for r in rs] == \
                [r.prefill_skipped for r in sreqs]
        return _observe(P, fe, rs)

    _both(pkgs, case)


# -------------------------------------------------- tests/test_faults.py

@pytest.mark.parametrize("door", ["trace", "paged"])
def test_empty_plan_bit_identity_sharded(pkgs, door):
    """A 2-shard frontend over ``FaultPlan()`` is bit-identical to one with
    no plan: through ``play_trace`` (tokens, latency stats, metrics with
    every fault counter zero) and on the paged plane's batch loop."""
    def case(P):
        blk = _blk(P)

        def run(faults):
            if door == "trace":
                fe = _frontend(P, 2, max_slots=2, capacity_bytes=10 * blk,
                               prefill_chunk=BT, max_queue=64, faults=faults)
                report = P.serve.play_trace(fe, _timed_trace(P))
                out = (_by_key(report.requests),
                       P.serve.latency_stats(report))
            else:
                fe = _frontend(P, 2, capacity_bytes=10 * blk, paged=True,
                               record_eviction_log=True, faults=faults)
                rs = [fe.submit(r, max_new=MAX_NEW)[1]
                      for r in workload(P.cfg.vocab, seed=3, prompt=40)]
                fe.run()
                out = ([r.generated for r in rs],
                       [e.store.eviction_log for e in fe.shards])
            fe.verify_replicas()
            m = _metrics(P, fe)
            fe.close()
            return out + (m,)

        base = run(None)
        empty = run(P.faults.FaultPlan())
        assert empty == base
        m = empty[-1]
        assert m["shard_crashes"] == 0 and m["failover_retries"] == 0
        assert m["msg_dropped"] == 0 and m["msg_resyncs"] == 0
        return empty

    _both(pkgs, case)


def test_shard_crash_failover(pkgs):
    """Shard 0 killed mid-trace under a lossy status channel: the crash
    fires once, every request finishes with the clean run's tokens
    (keyed by prompt and arrival), retries and drops are counted, and the
    anti-entropy resync restores the replicas' bit-identity proof."""
    def case(P):
        blk = _blk(P)
        plan = P.faults.FaultPlan(
            seed=7, shard_crashes=((5.0, 0),),
            bus_faults=(P.faults.BusFault(channel="status", drop_p=0.2),))

        def run(faults):
            fe = _frontend(P, 2, max_slots=2, capacity_bytes=48 * blk,
                           prefill_chunk=BT, max_queue=64, faults=faults)
            return fe, P.serve.play_trace(fe, _timed_trace(P))

        clean_fe, clean = run(None)
        clean_fe.verify_replicas()
        clean_fe.close()
        fe, report = run(plan)
        params = fe._params
        m = _metrics(P, fe)
        assert m["shard_crashes"] == 1, "scheduled crash did not fire"
        assert fe.faults.counters.get("fault.shard_crash") == 1
        assert all(r.cancelled or r.finished_at is not None
                   for r in report.requests)
        assert _by_key(report.requests) == _by_key(clean.requests)
        assert m["failover_retries"] >= 1 and m["msg_dropped"] > 0
        if P.name == "port":
            # the rebuilt shard serves from the frontend's own tensors
            want = [t for _, t in tree_paths(params)]
            for eng in fe.shards:
                assert all(a is b for a, b in
                           zip((t for _, t in tree_paths(eng.params)), want))
        fe.resync_replicas()
        fe.verify_replicas()
        after = _metrics(P, fe)
        assert after["msg_resyncs"] >= 1
        retries = sorted((r.prompt[:2], r.arrival, r.retries)
                         for r in report.requests)
        fe.close()
        return (_by_key(report.requests), m, after, retries,
                [e.steps for e in fe.shards], dict(fe.faults.counters))

    _both(pkgs, case)


def test_bus_drop_resync_converges(pkgs):
    """A lossy status channel alone: drops are counted, not raised, and one
    anti-entropy round restores the bit-identity proof."""
    def case(P):
        fe = _frontend(P, 2, capacity_bytes=10 * _blk(P),
                       faults=P.faults.FaultPlan(seed=11, bus_faults=(
                           P.faults.BusFault(channel="status",
                                             drop_p=0.3),)))
        rs = [fe.submit(r, max_new=MAX_NEW)[1]
              for r in workload(P.cfg.vocab, seed=3, prompt=40)]
        fe.run()
        assert all(r.done for r in rs)
        assert fe.bus.stats.dropped > 0, "lossy channel dropped nothing"
        fe.resync_replicas()
        fe.verify_replicas()
        assert fe.bus.stats.resyncs >= fe.n_shards
        out = _observe(P, fe, rs)
        fe.close()
        return out

    _both(pkgs, case)


# ------------------------------------------------------ tests/test_obs.py

_SHARDED_EVENTS = {"step", "store.lookup", "req", "bus.status",
                   "bus.status_report", "bus.peer_profile"}


def test_tracing_off_bit_identity_sharded(pkgs):
    """Tracing observes and never participates: a traced 2-shard run
    equals the untraced one (tokens, eviction logs, metrics), every
    instrumentation site fires, and the port's trace is the reference's
    event for event (wall clocks aside; a peer profile's bytes less
    ``PROFILE_EXTRA``), once the categories only the port emits are set
    aside."""
    def case(P):
        reqs = workload(P.cfg.vocab, n_requests=10, n_families=2, seed=3)
        blk = P.serve.ServeEngine(
            P.cfg, P.params, max_slots=2, max_seq=64,
            store=P.serve.PrefixStore(1 << 30, "lerc", block_tokens=BT),
            pool_blocks=1, paged=True, **P.kw)._block_nbytes()

        def run(recorder):
            fe = _frontend(P, 2, max_slots=2, capacity_bytes=blk * 5,
                           prefill_chunk=8, paged=True)
            if recorder is not None:
                fe.attach_trace(recorder)
            rs = [fe.submit(r, max_new=MAX_NEW)[1] for r in reqs]
            fe.run()
            return ([r.generated for r in rs],
                    [e.store.eviction_log for e in fe.shards],
                    _metrics(P, fe))

        base = run(None)
        assert any(base[1]), "workload produced no eviction pressure"
        rec = P.obs.TraceRecorder()
        assert run(rec) == base
        names = {e["name"] for e in rec.events}
        assert not _SHARDED_EVENTS - names
        events = []
        for ev in rec.events:
            if ev["cat"] in PORT_CATEGORIES:
                continue
            ev = {k: v for k, v in ev.items() if k not in ("wall",
                                                           "dur_wall")}
            if P.name == "port" and ev["name"] == "bus.peer_profile":
                ev["args"] = dict(ev["args"],
                                  bytes=ev["args"]["bytes"] - PROFILE_EXTRA)
            events.append(ev)
        return base, events

    _both(pkgs, case)
