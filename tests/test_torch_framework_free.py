"""The port's verbatim copies of the reference's framework-free modules.

* Every copy equals its original bar the module docstring: the two ASTs,
  docstrings removed, dump identically.
* The reference's own cases run against the copies and give outputs
  identical to the reference's on the same inputs: the data pipeline
  (``tests/test_data.py``'s four pipeline cases: outputs, metrics dicts,
  ``ExecStats``), the coordination plane (``tests/test_coordination.py``,
  the five cases that need no ``route_prefix``: ``MessageStats`` and bus
  logs), the cluster simulator (``tests/test_system.py``, all seven, and
  ``tests/test_faults.py``'s simulator and oracle cases: makespans,
  metrics and message dicts) and the prefix-store oracle
  (``tests/test_prefix_oracle.py``, all six, with the port's
  ``ReferencePrefixStore``: eviction logs, counters, metrics).

Each case is written once against a namespace of modules and run on the
reference's and on the port's; its assertions are the reference case's,
and it returns what it observed, which must be equal across packages.
One difference is inherent to a copy: pickle names a class by its module,
so the bus's wire-size estimate of a peer-profile message, which carries
``BlockMeta`` and ``TaskSpec``, is ``PROFILE_EXTRA`` (6) bytes larger in
the port; the byte counts are compared less exactly that.
"""
import ast
import dataclasses
import json
import random
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core  # noqa: E402
import repro.core.coordination  # noqa: E402
import repro.data  # noqa: E402
import repro.faults  # noqa: E402
import repro.serve.prefix_store  # noqa: E402
import repro.serve.reference  # noqa: E402
import repro.sim  # noqa: E402
import repro_torch.core  # noqa: E402
import repro_torch.core.coordination  # noqa: E402
import repro_torch.data  # noqa: E402
import repro_torch.faults  # noqa: E402
import repro_torch.serve  # noqa: E402
import repro_torch.serve.prefix_store  # noqa: E402
import repro_torch.serve.reference  # noqa: E402
import repro_torch.sim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

COPIES = [
    # copies made with the port's earlier slices
    "core/dag.py", "core/eviction_index.py", "core/metrics.py",
    "core/policies.py", "obs/trace.py", "serve/prefix_store.py",
    "serve/scheduler.py", "data/loader.py",
    # the framework-free rest of the reference
    "core/block_store.py", "core/coordination.py", "faults.py",
    "data/pipeline.py", "sim/workloads.py", "sim/cluster.py",
    "sim/__init__.py", "serve/reference.py",
]

REF = SimpleNamespace(core=repro.core, coordination=repro.core.coordination,
                      data=repro.data, faults=repro.faults, sim=repro.sim,
                      PrefixStore=repro.serve.prefix_store.PrefixStore,
                      ReferencePrefixStore=(
                          repro.serve.reference.ReferencePrefixStore))
PORT = SimpleNamespace(
    core=repro_torch.core, coordination=repro_torch.core.coordination,
    data=repro_torch.data, faults=repro_torch.faults, sim=repro_torch.sim,
    PrefixStore=repro_torch.serve.prefix_store.PrefixStore,
    ReferencePrefixStore=repro_torch.serve.ReferencePrefixStore)


def _ast_without_docstring(path: Path) -> str:
    tree = ast.parse(path.read_text(), str(path))
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        tree.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original_bar_docstring(rel):
    port = ROOT / "src" / "repro_torch" / rel
    text = port.read_text()
    assert text.startswith(f'"""Mirrors ``src/repro/{rel}`` verbatim') \
        or rel == "data/loader.py", "the copy's docstring names its original"
    assert _ast_without_docstring(port) == \
        _ast_without_docstring(ROOT / "src" / "repro" / rel)


def _both(case, tmp_path=None, **kw):
    """Run ``case`` on the reference's modules and on the port's; their
    observations must be equal."""
    args = {}
    out = []
    for name, pkg in (("ref", REF), ("port", PORT)):
        if tmp_path is not None:
            d = tmp_path / name
            d.mkdir()
            args = {"tmp_path": d}
        out.append(case(pkg, **args, **kw))
    assert out[1] == out[0]
    return out[1]


def _exec_stats(stats):
    """``ExecStats`` bar its wall-clock field."""
    d = dataclasses.asdict(stats)
    d.pop("io_seconds")
    return d


# pickle names a payload's dataclasses by module, and the port's module
# path (``repro_torch.core.dag``) is longer than the reference's
# (``repro.core.dag``): a message that carries ``BlockMeta`` or
# ``TaskSpec`` (a peer profile) weighs this many bytes more in the port's
# wire-size estimate. Every other count and byte is the reference's.
PROFILE_EXTRA = (
    PORT.coordination.payload_nbytes((PORT.core.BlockMeta("b", 1, "d", 0),))
    - REF.coordination.payload_nbytes((REF.core.BlockMeta("b", 1, "d", 0),)))


def test_profile_extra_is_the_module_path():
    assert PROFILE_EXTRA == len("repro_torch.core.dag") - len("repro.core.dag")


def _message_stats(P, stats, n_profiles):
    """``MessageStats`` as a dict, the port's byte counts less
    ``PROFILE_EXTRA`` for each of ``n_profiles`` peer-profile messages."""
    d = stats.as_dict()
    if P is PORT:
        for key in ("payload_bytes", "lerc_bytes"):
            d[key] -= PROFILE_EXTRA * n_profiles
    return d


# ------------------------------------------- tests/test_data.py (pipeline)


def _zip_pipeline(P, n_blocks=8, block=512):
    rng = np.random.default_rng(0)
    A = [rng.integers(0, 100, block).astype(np.int32)
         for _ in range(n_blocks)]
    B = [rng.integers(0, 100, block).astype(np.int32)
         for _ in range(n_blocks)]
    pipe = P.data.Pipeline("t")
    ra = pipe.source(A, "A")
    rb = pipe.source(B, "B")
    rz = pipe.zip_([ra, rb], lambda a, b: a + b, "Z")
    return pipe, ra, rb, rz, A, B


def _pipeline_correctness_under_pressure(P, tmp_path):
    pipe, ra, rb, rz, A, B = _zip_pipeline(P)
    nbytes = A[0].nbytes
    ex = P.data.Executor(pipe, cache_bytes=5 * nbytes, policy="lerc",
                         spill_dir=str(tmp_path))
    ex.load_sources(ra)
    ex.load_sources(rb)
    outs = ex.materialize(rz)
    for i in range(8):
        np.testing.assert_array_equal(outs[i], A[i] + B[i])
    assert ex.stats.disk_writes > 0          # pressure forced spills
    assert ex.metrics.evictions > 0
    return ([o.tolist() for o in outs], ex.metrics.as_dict(),
            _exec_stats(ex.stats))


def test_pipeline_correctness_under_pressure(tmp_path):
    _both(_pipeline_correctness_under_pressure, tmp_path)


def _pipeline_all_policies_correct(P, tmp_path, policy):
    pipe, ra, rb, rz, A, B = _zip_pipeline(P, n_blocks=6)
    ex = P.data.Executor(pipe, cache_bytes=4 * A[0].nbytes, policy=policy,
                         spill_dir=str(tmp_path))
    ex.load_sources(ra)
    ex.load_sources(rb)
    outs = ex.materialize(rz)
    for i in range(6):
        np.testing.assert_array_equal(outs[i], A[i] + B[i])
    return ([o.tolist() for o in outs], ex.metrics.as_dict(),
            _exec_stats(ex.stats))


@pytest.mark.parametrize("policy", ["lru", "lrc", "lerc"])
def test_pipeline_all_policies_correct(tmp_path, policy):
    """Eviction policy must never affect RESULTS, only performance."""
    _both(_pipeline_all_policies_correct, tmp_path, policy=policy)


def _lerc_beats_lru_on_effective_hits(P, tmp_path):
    results, seen = {}, {}
    for policy in ("lru", "lerc"):
        pipe, ra, rb, rz, A, B = _zip_pipeline(P, n_blocks=10)
        ex = P.data.Executor(pipe, cache_bytes=10 * A[0].nbytes,
                             policy=policy, spill_dir=str(tmp_path / policy))
        ex.load_sources(ra)
        ex.load_sources(rb)
        ex.materialize(rz)
        results[policy] = ex.metrics.effective_hit_ratio
        seen[policy] = (ex.metrics.as_dict(), _exec_stats(ex.stats))
    assert results["lerc"] >= results["lru"]
    assert results["lerc"] > 0
    return seen


def test_lerc_beats_lru_on_effective_hits(tmp_path):
    _both(_lerc_beats_lru_on_effective_hits, tmp_path)


def _map_and_coalesce(P, tmp_path):
    rng = np.random.default_rng(1)
    X = [rng.normal(size=64).astype(np.float32) for _ in range(8)]
    pipe = P.data.Pipeline("m")
    rx = pipe.source(X, "X")
    r2 = pipe.map(rx, lambda a: a * 2, "D")
    rc = pipe.coalesce(r2, 4, name="C")
    ex = P.data.Executor(pipe, cache_bytes=1 << 20, spill_dir=str(tmp_path))
    ex.load_sources(rx)
    outs = ex.materialize(rc)
    np.testing.assert_allclose(outs[0], np.concatenate([x * 2
                                                        for x in X[:4]]))
    assert len(outs) == 2
    return ([o.tolist() for o in outs], ex.metrics.as_dict(),
            _exec_stats(ex.stats))


def test_map_and_coalesce(tmp_path):
    _both(_map_and_coalesce, tmp_path)


# ---------------------------- tests/test_coordination.py (coordination)


def _job(P, job_id, tasks):
    dag = P.core.JobDAG()
    seen = set()
    for i, (name, inputs, output) in enumerate(tasks):
        for b in list(inputs) + [output]:
            if b not in seen:
                dag.add_block(P.core.BlockMeta(b, 1, job_id, len(seen)))
                seen.add(b)
        dag.add_task(P.core.TaskSpec(f"{job_id}.{name}", tuple(inputs),
                                     output, job=job_id))
    return dag


def _bus_seen(P, bus):
    profiles = [m.kind == "peer_profile" for m in bus.log]
    extra = PROFILE_EXTRA if P is PORT else 0
    return (_message_stats(P, bus.stats, sum(profiles)),
            [(m.kind, m.src, m.dst, m.nbytes - extra * prof)
             for m, prof in zip(bus.log, profiles)])


def _peer_profile_is_incremental_delta(P):
    master, workers, bus = P.core.build_cluster(n_workers=2)
    master.submit_job(_job(P, "j1", [("t0", ["a", "b"], "x")]))
    master.submit_job(_job(P, "j2", [("t0", ["a", "x"], "y")]))
    profiles = [m for m in bus.log if m.kind == "peer_profile"]
    assert len(profiles) == 2 * 2                    # 2 jobs x 2 workers
    blocks2, tasks2 = profiles[-1].payload
    assert {b.id for b in blocks2} == {"y"}          # delta only
    assert {t.id for t in tasks2} == {"j2.t0"}
    oracle = P.core.DagState(master.dag)
    for w in workers:
        for b in master.dag.blocks:
            assert w.state.ref_count.get(b, 0) == oracle.ref_count[b]
            assert w.state.eff_ref_count.get(b, 0) == oracle.eff_ref_count[b]
        assert set(w.dag.blocks) == set(master.dag.blocks)
        assert set(w.dag.tasks) == set(master.dag.tasks)
    return _bus_seen(P, bus), [dict(w.state.eff_ref_count) for w in workers]


def _replica_exists_before_any_job(P):
    _, workers, bus = P.core.build_cluster(n_workers=1)
    assert workers[0].state.ref_count == {}
    assert not workers[0].dag.blocks
    return _bus_seen(P, bus)


def _bus_byte_accounting(P):
    master, workers, bus = P.core.build_cluster(n_workers=3)
    master.submit_job(_job(P, "j", [("t", ["a", "b"], "x")]))
    for b in ("a", "b"):
        workers[0].report_status("materialized", b)
    workers[0].local_eviction("a")
    kinds = P.coordination.LERC_KINDS
    assert bus.stats.payload_bytes == sum(m.nbytes for m in bus.log)
    assert bus.stats.lerc_bytes == sum(m.nbytes for m in bus.log
                                       if m.kind in kinds)
    assert 0 < bus.stats.lerc_bytes < bus.stats.payload_bytes
    assert bus.stats.point_to_point == len(bus.log)
    nb = P.coordination.payload_nbytes
    assert nb(("evicted", "a")) == nb(("evicted", "a"))
    return _bus_seen(P, bus), nb(("evicted", "a"))


def _eviction_protocol_rearms_after_reload(P):
    master, workers, bus = P.core.build_cluster(n_workers=2)
    master.submit_job(_job(P, "j", [("t", ["a", "b"], "x")]))
    w0 = workers[0]
    for b in ("a", "b"):
        w0.report_status("materialized", b)
    assert w0.local_eviction("a")              # complete -> flip
    assert bus.stats.eviction_broadcasts == 1
    assert not w0.local_eviction("b")          # already incomplete: silent
    assert bus.stats.eviction_broadcasts == 1
    for b in ("a", "b"):
        w0.report_status("materialized", b)    # reload: complete again
    assert w0.local_eviction("b")              # flip again
    assert bus.stats.eviction_broadcasts == 2
    assert bus.stats.eviction_reports == 2
    return _bus_seen(P, bus)


def _status_relay_covers_silent_evictions(P):
    master, workers, bus = P.core.build_cluster(n_workers=3)
    master.submit_job(_job(P, "j", [("t", ["b", "c"], "x")]))
    w0 = workers[0]
    for blk in ("b", "c"):
        w0.report_status("materialized", blk)
    w0.local_eviction("c")                     # flip: b,c group breaks
    w0.local_eviction("b")                     # silent on the LERC channel
    w0.report_status("materialized", "c")      # reload c only
    oracle = P.core.DagState(master.dag, materialized={"b", "c"},
                             cached={"c"})
    for w in workers:
        for blk in master.dag.blocks:
            assert w.state.eff_ref_count.get(blk, 0) == \
                oracle.eff_ref_count[blk]
        assert w.state.cached == {"c"}
    assert bus.stats.eviction_broadcasts == 1
    return _bus_seen(P, bus)


@pytest.mark.parametrize("case", [
    _peer_profile_is_incremental_delta, _replica_exists_before_any_job,
    _bus_byte_accounting, _eviction_protocol_rearms_after_reload,
    _status_relay_covers_silent_evictions],
    ids=lambda f: f.__name__.strip("_"))
def test_coordination_cases(case):
    _both(case)


# --------------------------------- tests/test_system.py (the simulator)


def _sim_seen(P, res, n_workers):
    """A run's makespan, metrics, messages (every peer profile broadcast
    to each of ``n_workers``) and per-job and per-task times."""
    n_profiles = res.messages.peer_profile_broadcasts * n_workers
    return (res.makespan, res.metrics.as_dict(),
            _message_stats(P, res.messages, n_profiles),
            res.per_job_finish, res.task_runtimes)


def _run(P, policy, cache_gb=5.3, n_jobs=4, n_blocks=40):
    hw = P.sim.HardwareModel(cache_bytes=int(cache_gb * 2 ** 30) // 20,
                             disk_bw=25e6)
    sim = P.sim.ClusterSim(20, hw, policy=policy)
    for dag, _ in P.sim.multi_tenant_zip(n_jobs=n_jobs, n_blocks=n_blocks,
                                         n_workers=20):
        sim.submit(dag)
    sim.run(stages={0})
    return sim.run(stages={1})


def _paper_headline_ordering(P):
    res = {p: _run(P, p, cache_gb=2.0) for p in ("lru", "lrc", "lerc")}
    assert res["lerc"].makespan <= res["lrc"].makespan <= res["lru"].makespan
    assert res["lerc"].makespan < res["lru"].makespan  # strict win
    return {p: _sim_seen(P, r, 20) for p, r in res.items()}


def _effective_ratio_tracks_runtime_better(P):
    res = {p: _run(P, p, cache_gb=2.0) for p in ("lru", "lrc", "lerc")}
    ehr = {p: r.metrics.effective_hit_ratio for p, r in res.items()}
    mk = {p: r.makespan for p, r in res.items()}
    order_by_ehr = sorted(ehr, key=lambda p: -ehr[p])
    order_by_mk = sorted(mk, key=lambda p: mk[p])
    assert order_by_ehr[0] == order_by_mk[0] == "lerc"
    assert res["lrc"].metrics.hit_ratio >= 0.9 * res["lerc"].metrics.hit_ratio
    assert ehr["lerc"] > ehr["lrc"]
    return ehr, mk


def _sim_message_accounting(P):
    res = _run(P, "lerc", cache_gb=2.0)
    assert res.messages.eviction_broadcasts == res.messages.eviction_reports
    assert res.messages.eviction_broadcasts <= res.metrics.evictions
    assert res.messages.payload_bytes > res.messages.lerc_bytes > 0
    return _sim_seen(P, res, 20)


def _message_stats_are_real_bus_traffic(P):
    hw = P.sim.HardwareModel(cache_bytes=int(2.0 * 2 ** 30) // 20,
                             disk_bw=25e6)
    sim = P.sim.ClusterSim(20, hw, policy="lru")
    assert sim.messages is sim.bus.stats
    for dag, _ in P.sim.multi_tenant_zip(n_jobs=2, n_blocks=20,
                                         n_workers=20):
        sim.submit(dag)
    sim.run(stages={0})
    res = sim.run(stages={1})
    assert res.messages.peer_profile_broadcasts == 0
    assert res.messages.eviction_reports == 0
    assert res.messages.eviction_broadcasts == 0
    assert res.messages.lerc_bytes == 0
    assert res.messages.point_to_point > 0
    assert res.messages.payload_bytes > 0
    return _sim_seen(P, res, 20)


def _sim_replicas_bit_identical(P):
    res = _run(P, "lerc", cache_gb=1.0)
    assert res.metrics.evictions > 0
    hw = P.sim.HardwareModel(cache_bytes=int(1.0 * 2 ** 30) // 20,
                             disk_bw=25e6)
    sim = P.sim.ClusterSim(20, hw, policy="lerc")
    for dag, _ in P.sim.multi_tenant_zip(n_jobs=3, n_blocks=30,
                                         n_workers=20):
        sim.submit(dag)
    sim.run(stages={0})
    res2 = sim.run(stages={1})
    sim.verify_replicas()
    ms = sim.master.state
    for tr in sim.trackers:
        assert tr.state.cached == ms.cached
        for b in sim.master.dag.blocks:
            assert tr.state.eff_ref_count.get(b, 0) == \
                ms.eff_ref_count.get(b, 0)
    return (_sim_seen(P, res, 20), _sim_seen(P, res2, 20),
            sorted(ms.cached))


def _belady_optimizes_the_wrong_metric(P):
    n_jobs, n_blocks = 3, 30
    trace = P.sim.zip_access_trace(n_jobs, n_blocks)
    hw = P.sim.HardwareModel(cache_bytes=int(1.5 * 2 ** 30) // 20,
                             disk_bw=25e6)

    def run_with(policy):
        sim = P.sim.ClusterSim(20, hw, policy=policy)
        for dag, _ in P.sim.multi_tenant_zip(n_jobs=n_jobs,
                                             n_blocks=n_blocks,
                                             n_workers=20):
            sim.submit(dag)
        sim.run(stages={0})
        return sim.run(stages={1}, belady_trace=trace)

    lerc = run_with("lerc")
    belady = run_with("belady")
    assert belady.metrics.hit_ratio >= lerc.metrics.hit_ratio * 0.999
    assert lerc.makespan <= belady.makespan * 1.05
    return _sim_seen(P, lerc, 20), _sim_seen(P, belady, 20)


def _msg_latency_charges_bus_delay(P):
    assert P.sim.HardwareModel().msg_latency == 0.0

    def chain_job(n=5, size=10 * 2 ** 20):
        dag = P.core.JobDAG()
        prev = dag.add_source("src", 0, size=size).id
        for i in range(n):
            dag.add_block(P.core.BlockMeta(id=f"b{i}", size=size,
                                           dataset="d", index=i))
            dag.add_task(P.core.TaskSpec(id=f"t{i}", inputs=(prev,),
                                         output=f"b{i}", job="j"))
            prev = f"b{i}"
        return dag

    def run(latency):
        sim = P.sim.ClusterSim(2, P.sim.HardwareModel(msg_latency=latency),
                               policy="lerc")
        sim.submit(chain_job())
        return sim.run()

    base = run(0.0)
    delayed = run(0.5)
    assert delayed.makespan == pytest.approx(base.makespan + 4 * 0.5)
    assert delayed.metrics.hits == base.metrics.hits
    assert delayed.metrics.evictions == base.metrics.evictions
    return _sim_seen(P, base, 2), _sim_seen(P, delayed, 2)


@pytest.mark.parametrize("case", [
    _paper_headline_ordering, _effective_ratio_tracks_runtime_better,
    _sim_message_accounting, _message_stats_are_real_bus_traffic,
    _sim_replicas_bit_identical, _belady_optimizes_the_wrong_metric,
    _msg_latency_charges_bus_delay], ids=lambda f: f.__name__.strip("_"))
def test_system_cases(case):
    _both(case)


# ------------------- tests/test_faults.py (simulator and oracle cases)

SIZE = 10 * 2 ** 20


def _chain_dag(P, n_tasks, block_size):
    dag = P.core.JobDAG()
    dag.add_block(P.core.BlockMeta("src", block_size, "src", 0))
    prev = "src"
    for i in range(n_tasks):
        out = f"b{i}"
        dag.add_block(P.core.BlockMeta(out, block_size, "chain", i))
        dag.add_task(P.core.TaskSpec(id=f"t{i}", inputs=(prev,), output=out,
                                     job="chain"))
        prev = out
    return dag


def _sim_empty_plan_identical(P):
    hw = P.sim.HardwareModel(cache_bytes=8 * SIZE)
    results = []
    for faults in (None, P.faults.FaultPlan()):
        sim = P.sim.ClusterSim(2, hw, faults=faults)
        sim.submit(_chain_dag(P, 6, SIZE))
        results.append(sim.run())
    base, empty = results
    assert empty.makespan == base.makespan
    assert empty.metrics.as_dict() == base.metrics.as_dict()
    assert empty.messages.as_dict() == base.messages.as_dict()
    assert empty.task_runtimes == base.task_runtimes
    return _sim_seen(P, base, 2), _sim_seen(P, empty, 2)


def _sim_worker_crash_exact_makespan_delta(P):
    hw = P.sim.HardwareModel(cache_bytes=8 * SIZE)
    sim = P.sim.ClusterSim(1, hw)
    sim.submit(_chain_dag(P, 4, SIZE))
    clean = sim.run()
    crash_t = clean.makespan / 2
    sim_f = P.sim.ClusterSim(1, hw, faults=P.faults.FaultPlan(
        worker_crashes=((crash_t, 0),)))
    sim_f.submit(_chain_dag(P, 4, SIZE))
    fault = sim_f.run()
    assert sim_f.worker_crashes_fired == 1
    assert fault.makespan == pytest.approx(crash_t + clean.makespan)
    assert sim_f.faults.counters["fault.worker_crash"] == 1
    assert sim_f.faults.counters["recover.lost_blocks"] > 0
    return (_sim_seen(P, clean, 1), _sim_seen(P, fault, 1),
            dict(sim_f.faults.counters))


def _sim_crash_out_of_range_worker_never_fires(P):
    hw = P.sim.HardwareModel(cache_bytes=8 * SIZE)
    sim = P.sim.ClusterSim(1, hw)
    sim.submit(_chain_dag(P, 4, SIZE))
    clean = sim.run()
    sim_f = P.sim.ClusterSim(1, hw, faults=P.faults.FaultPlan(
        worker_crashes=((0.1, 7),)))
    sim_f.submit(_chain_dag(P, 4, SIZE))
    fault = sim_f.run()
    assert sim_f.worker_crashes_fired == 0
    assert fault.makespan == clean.makespan
    return _sim_seen(P, clean, 1), _sim_seen(P, fault, 1)


def _on_lost_matches_rebuild_oracle(P):
    dag = _chain_dag(P, 4, 1)
    state = P.core.DagState(dag)
    seen = []

    def check():
        oracle = P.core.DagState(dag, materialized=set(state.materialized),
                                 cached=set(state.cached),
                                 done_tasks=set(state.done_tasks))
        assert state.ref_count == oracle.ref_count
        assert state.eff_ref_count == oracle.eff_ref_count
        assert {t: m for t, m in state.missing.items()
                if oracle.missing.get(t) != m} == {}
        seen.append((dict(state.ref_count), dict(state.eff_ref_count),
                     sorted(state.done_tasks)))

    state.on_materialized("src")
    check()
    for i in range(4):
        state.on_materialized(f"b{i}")
        check()
    for b in ("b1", "b2"):
        state.on_lost(b)
        check()
    assert "t1" not in state.done_tasks and "t2" not in state.done_tasks
    for b in ("b1", "b2"):
        state.on_materialized(b)
        check()
    assert state.done_tasks == {f"t{i}" for i in range(4)}
    return seen


@pytest.mark.parametrize("case", [
    _sim_empty_plan_identical, _sim_worker_crash_exact_makespan_delta,
    _sim_crash_out_of_range_worker_never_fires,
    _on_lost_matches_rebuild_oracle], ids=lambda f: f.__name__.strip("_"))
def test_fault_sim_cases(case):
    _both(case)


def test_fault_plan_and_injector_match(tmp_path):
    """A ``FaultPlan`` read from json, and its ``FaultInjector``'s
    decisions from the plan's seed, are the same in both packages."""
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({
        "seed": 3, "worker_crashes": [[1.5, 0]], "disk_read_error_p": 0.2,
        "bus_faults": [{"channel": "*", "drop_p": 0.1, "delay_p": 0.2,
                        "dup_p": 0.1}]}))

    def case(P):
        plan = P.faults.FaultPlan.from_json(str(path))
        assert not plan.empty
        inj = plan.injector()
        draws = [(inj.bus_action("status"), inj.disk_read_fails())
                 for _ in range(64)]
        return (dataclasses.astuple(plan), draws,
                [plan.backoff(r) for r in range(6)])
    _both(case)


# ------------------- tests/test_prefix_oracle.py (the brute-force oracle)

PAYLOAD = {"kv": None}


def random_trace(inc, ref, seed, n_ops=300, vocab=60, bt=4):
    rng = random.Random(seed)
    families = [[rng.randrange(vocab) for _ in range(12)] for _ in range(5)]
    live = []

    def toks():
        fam = rng.choice(families)
        t = fam[:rng.randrange(bt, len(fam) + 1)]
        t += [rng.randrange(vocab) for _ in range(rng.randrange(0, bt + 1))]
        return t

    for op in range(n_ops):
        r = rng.random()
        if r < 0.3:
            t = toks()
            rid = inc.register_request(t)
            assert rid == ref.register_request(t)
            live.append((rid, t))
        elif r < 0.5 and live:
            rid, _ = live.pop(rng.randrange(len(live)))
            inc.complete_request(rid)
            ref.complete_request(rid)
        elif r < 0.75:
            t = toks()
            a = inc.lookup(t)
            b = ref.lookup(t)
            assert [n.uid for n in a] == [n.uid for n in b]
        else:
            t = toks()
            n = len(t) // bt
            inc.insert(t, [PAYLOAD] * n, nbytes_per_block=50)
            ref.insert(t, [PAYLOAD] * n, nbytes_per_block=50)
        assert inc.eviction_log == ref.eviction_log, \
            f"eviction order diverged at op {op}"
    assert inc.metrics() == ref.metrics()


def _eviction_order_matches_bruteforce(P, policy, seed):
    inc = P.PrefixStore(capacity_bytes=450, policy=policy, block_tokens=4)
    ref = P.ReferencePrefixStore(capacity_bytes=450, policy=policy,
                                 block_tokens=4)
    random_trace(inc, ref, seed)
    assert inc.evictions > 0, "trace produced no eviction pressure"
    return ref.eviction_log, ref.metrics()


@pytest.mark.parametrize("policy", ["lru", "lrc", "lerc"])
@pytest.mark.parametrize("seed", range(5))
def test_eviction_order_matches_bruteforce(policy, seed):
    _both(_eviction_order_matches_bruteforce, policy=policy, seed=seed)


def _erc_values_match_bruteforce(P, seed):
    inc = P.PrefixStore(capacity_bytes=450, policy="lerc", block_tokens=4)
    ref = P.ReferencePrefixStore(capacity_bytes=450, policy="lerc",
                                 block_tokens=4)
    random_trace(inc, ref, seed + 100)
    rc, erc = ref._ref_counts()
    for bid in inc._nodes:
        assert inc.state.ref_count.get(bid, 0) == rc.get(bid, 0)
        assert inc.state.eff_ref_count.get(bid, 0) == erc.get(bid, 0)
    oracle = P.core.DagState(inc.dag, materialized=set(inc.state.materialized),
                             cached=set(inc.state.cached),
                             done_tasks=set(inc.state.done_tasks))
    for bid in inc.dag.blocks:
        assert inc.state.ref_count.get(bid, 0) == oracle.ref_count[bid]
        assert inc.state.eff_ref_count.get(bid, 0) == \
            oracle.eff_ref_count[bid]
    return rc, erc, ref.eviction_log


@pytest.mark.parametrize("seed", range(5))
def test_erc_values_match_bruteforce(seed):
    _both(_erc_values_match_bruteforce, seed=seed)


def _depth_weighting_prefers_leaves(P):
    st = P.PrefixStore(capacity_bytes=10_000, policy="lerc", block_tokens=1)
    toks = list(range(6))
    st.insert(toks, [PAYLOAD] * 6, nbytes_per_block=1)
    st.register_request(toks)
    chain = st._walk(toks)
    rcs = [st.state.ref_count[n.block_id] for n in chain]
    ercs = [st.state.eff_ref_count[n.block_id] for n in chain]
    assert rcs == sorted(rcs, reverse=True)
    assert ercs == sorted(ercs, reverse=True)
    assert rcs[0] == 6 and rcs[-1] == 1        # depth-weighted
    assert ercs == rcs
    return rcs, ercs


def test_depth_weighting_prefers_leaves():
    _both(_depth_weighting_prefers_leaves)


def _unreferenced_chain_evicts_leaf_first(P, policy):
    st = P.PrefixStore(capacity_bytes=6, policy=policy, block_tokens=1)
    toks = list(range(6))
    st.insert(toks, [PAYLOAD] * 6, nbytes_per_block=1)
    st.insert([100], [PAYLOAD], nbytes_per_block=1)   # forces one eviction
    chain = st._walk(toks)
    assert st.eviction_log == [chain[-1].block_id], \
        f"{policy} must evict the leaf, got {st.eviction_log}"
    assert len(st.lookup(toks)) == 5                  # prefix intact
    return st.eviction_log, st.metrics()


@pytest.mark.parametrize("policy", ["lru", "fifo", "lfu", "lerc"])
def test_unreferenced_chain_evicts_leaf_first(policy):
    _both(_unreferenced_chain_evicts_leaf_first, policy=policy)


def _completed_requests_are_garbage_collected(P):
    st = P.PrefixStore(capacity_bytes=10_000, policy="lerc", block_tokens=2)
    n_tasks0 = len(st.dag.tasks)
    rids = [st.register_request(list(range(i, i + 8))) for i in range(10)]
    grown = len(st.dag.tasks)
    assert grown > n_tasks0
    for rid in rids:
        st.complete_request(rid)
    assert len(st.dag.tasks) == n_tasks0
    assert not st.state.missing
    assert not st.state.done_tasks
    assert st._nodes == {}
    assert st.root.children == {}
    assert not st.state.ref_count and not st.state.eff_ref_count
    return n_tasks0, grown, st.metrics()


def test_completed_requests_are_garbage_collected():
    _both(_completed_requests_are_garbage_collected)


def _skeleton_gc_respects_sharing_and_residency(P):
    st = P.PrefixStore(capacity_bytes=10_000, policy="lerc", block_tokens=2)
    r1 = st.register_request(list(range(8)))              # 4 nodes
    r2 = st.register_request(list(range(4)) + [9] * 4)    # shares 2, +2
    assert len(st._nodes) == 6
    st.complete_request(r1)
    assert len(st._nodes) == 4
    st.complete_request(r2)
    assert st._nodes == {} and st.root.children == {}
    assert not st.dag.blocks and not st.dag.tasks
    rid = st.register_request(list(range(6)))
    st.insert(list(range(6)), [PAYLOAD] * 3, nbytes_per_block=10)
    st.complete_request(rid)
    assert len(st.lookup(list(range(6)))) == 3
    assert len(st._nodes) == 3
    return sorted(st._nodes), st.metrics()


def test_skeleton_gc_respects_sharing_and_residency():
    _both(_skeleton_gc_respects_sharing_and_residency)
