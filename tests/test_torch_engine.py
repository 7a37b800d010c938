"""The port's ServeEngine (on the CPU) against the reference's, on both data
planes, in f32 with the reference's weights carried over by the bridge:
the paged plane on the qwen2-7b smoke config, and the gather plane
(``paged=False``) on the gemma2-27b smoke config (rolling-window L layers,
softcaps, prefill recomputed: no restore) and on qwen2-7b smoke (prefix
hits restored by a gather pool→slot).

The workload is ``tests/test_engine_equivalence.py``'s (shared-prefix,
uniform lengths, byte pressure) with its duplicate of the first prompt
appended, and a duplicate of the last, whose chain is still resident when
it arrives: the copy-on-write path of the paged plane runs under every
policy. Both engines must give identical generated tokens, a bit-identical
eviction log, identical ERC counters, prefix reuse, step counts and
``metrics()``; the port's pool must hold exactly the store's resident rows
(plus the paged plane's junk row) afterwards, and on the gather plane the
pool and the per-slot caches must hold what the reference's hold. The
launcher must print what the reference launcher prints."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.launch.serve import serve_main as jax_serve_main  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.models import params_from_numpy, tree_paths  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402

BT = 8          # block_tokens
PROMPT = 32     # uniform prompt length (4 blocks)
MAX_NEW = 4


def _model(arch):
    jcfg = jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                              dtype=jnp.float32)
    return jcfg, tcfg, jparams, params_from_numpy(jax.device_get(jparams))


@pytest.fixture(scope="module")
def model():
    return _model("qwen2_7b")


@pytest.fixture(scope="module")
def gemma2():
    return _model("gemma2_27b")


def workload(vocab, n_requests=8, n_families=3, seed=7):
    """Shared-prefix requests with uniform lengths, plus duplicates of the
    first and the last (a full-chain hit -> copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    reqs = [prefixes[i % n_families] + list(rng.integers(0, vocab, BT))
            for i in range(n_requests)]
    return reqs + [list(reqs[0]), list(reqs[-1])]


def _engine(engine_cls, store_cls, cfg, params, policy, chunk, scheduler,
            paged=True, **kw):
    probe = engine_cls(cfg, params, max_slots=2, max_seq=64,
                       store=store_cls(1 << 30, "lerc", block_tokens=BT),
                       pool_blocks=1, prefill_chunk=chunk, paged=paged, **kw)
    cap = probe._block_nbytes() * 10            # < working set -> evictions
    st = store_cls(cap, policy, block_tokens=BT)
    eng = engine_cls(cfg, params, max_slots=2, max_seq=64, store=st,
                     prefill_chunk=chunk, paged=paged, scheduler=scheduler,
                     **kw)
    return eng, st


def _run(engine_cls, store_cls, cfg, params, policy, chunk, scheduler,
         max_new=MAX_NEW, **kw):
    eng, st = _engine(engine_cls, store_cls, cfg, params, policy, chunk,
                      scheduler, **kw)
    rs = [eng.submit(r, max_new=max_new) for r in workload(cfg.vocab)]
    eng.run()
    return eng, st, rs


def _assert_kv_close(tree, jtree):
    """Same KV contents, to 2e-4 of each leaf's scale: the f32 drift of
    the layers below a cache entry (see test_torch_gather_decode.py)."""
    ref = dict(tree_paths(jax.device_get(jtree)))
    for path, t in tree_paths(tree):
        want = np.asarray(ref[path])
        np.testing.assert_allclose(t.numpy(), want,
                                   atol=2e-4 * np.abs(want).max(),
                                   err_msg=str(path))


def _assert_same(model, policy, chunk, scheduler=None, paged=True):
    jcfg, tcfg, jparams, tparams = model
    jeng, jst, jrs = _run(JaxEngine, JaxStore, jcfg, jparams, policy, chunk,
                          scheduler, paged=paged)
    teng, tst, trs = _run(ServeEngine, PrefixStore, tcfg, tparams, policy,
                          chunk, scheduler, paged=paged, device="cpu")
    assert jst.evictions > 0, "workload produced no pressure"
    assert jeng.transfer_dispatches > 0, "no copy-on-write or scatter"
    assert teng.paged == jeng.paged == paged
    assert [r.generated for r in trs] == [r.generated for r in jrs]
    assert tst.eviction_log == jst.eviction_log
    assert [r.prefill_skipped for r in trs] == \
        [r.prefill_skipped for r in jrs]
    assert tst.state.ref_count == jst.state.ref_count
    assert tst.state.eff_ref_count == jst.state.eff_ref_count
    assert teng.steps == jeng.steps
    assert teng.transfer_dispatches == jeng.transfer_dispatches
    assert teng.metrics() == jeng.metrics()
    assert teng.pool.blocks_in_use == \
        sum(1 for n in tst._nodes.values() if n.resident) + paged  # junk row
    if not paged:
        _assert_kv_close(teng.pool.buffers, jeng.pool.buffers)
        _assert_kv_close(teng.cache, jeng.cache)
    return jeng, teng


@pytest.mark.parametrize("policy", ["lru", "lrc", "lerc"])
@pytest.mark.parametrize("chunk", [1, 8])
def test_paged_engine_matches_reference(model, policy, chunk):
    _assert_same(model, policy, chunk)


def test_budgeted_scheduler_matches_reference(model):
    _assert_same(model, "lerc", 8, scheduler="budgeted")


@pytest.mark.parametrize("arch", ["codeqwen1_5_7b", "qwen1_5_110b"])
def test_qwen1_5_paged_engine_matches_reference(arch):
    """The qwen1.5 configs on the paged plane: codeqwen1.5-7b's MHA (every
    query head its own KV head) and qwen1.5-110b's GQA, the reference's
    tokens, eviction log and metrics."""
    _assert_same(_model(arch), "lerc", 8)


@pytest.mark.parametrize("policy", ["lru", "lrc", "lerc"])
def test_gather_engine_matches_reference_on_rolling_layers(gemma2, policy):
    """gemma2 smoke: L caches 8 slots wide under 32-token prompts, so every
    publish scatters clamped blocks out of them; hits are counted, no
    prefill is skipped (restore is off for rolling layers)."""
    jeng, _ = _assert_same(gemma2, policy, 1, paged=False)
    m = jeng.metrics()
    assert m["hits"] > 0 and m["prefill_tokens_skipped"] == 0


@pytest.mark.parametrize("chunk", [1, 8])
def test_gather_engine_matches_reference(model, chunk):
    """qwen2 smoke on the gather plane: prefix hits restored by a gather
    pool→slot, chunks through ``_sdpa``, decode through flash-decoding."""
    jeng, _ = _assert_same(model, "lerc", chunk, paged=False)
    assert jeng.metrics()["prefill_tokens_skipped"] > 0


def test_budgeted_scheduler_matches_reference_on_gather_plane(model):
    _assert_same(model, "lerc", 8, scheduler="budgeted", paged=False)


def test_default_plane_and_fallback_warnings():
    """The reference's defaults: the gather plane unless asked for the
    paged one; a rolling-window pattern clamps the chunk to 1 and falls
    back from paged to gather, with the reference's warnings."""
    gcfg = configs.get("gemma2_27b", smoke=True)
    qcfg = configs.get("qwen2_7b", smoke=True)
    assert not ServeEngine(qcfg, {}, max_slots=1, max_seq=16,
                           device="cpu").paged
    assert JaxEngine(jax_configs.get("qwen2_7b", smoke=True), {},
                     max_slots=1, max_seq=16).paged is False
    said = []
    for cls, cfg, kw in ((JaxEngine, jax_configs.get("gemma2_27b",
                                                     smoke=True), {}),
                         (ServeEngine, gcfg, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            eng = cls(cfg, {}, max_slots=1, max_seq=16, paged=True,
                      prefill_chunk=8, **kw)
        assert not eng.paged and eng.prefill_chunk == 1
        assert not eng.restore_prefix
        said.append([str(w.message) for w in rec
                     if issubclass(w.category, UserWarning)])
    assert len(said[0]) == 2 and said[1] == said[0]
    assert "clamping prefill_chunk to 1" in said[1][0]
    assert "falling back to the gather engine" in said[1][1]


LAUNCH_ARGS = ["--smoke", "--requests", "4", "--slots", "2", "--max-seq",
               "32", "--shared-prefix", "16", "--max-new", "2", "--cache-kb",
               "8", "--block-tokens", "4"]


def _launch_both(capsys, args):
    """Run both launchers on ``args``; returns their metric lines and
    their header lines (the run's flags, wall time stripped)."""
    out = []
    for main, extra in ((jax_serve_main, []),
                        (serve_main, ["--device", "cpu"])):
        assert main(args + extra) == 0
        lines = capsys.readouterr().out.splitlines()
        out.append(([ln for ln in lines if ln.startswith("  ")],
                    [ln for ln in lines if ln.startswith("policy=")]))
    return out


def test_launcher_prints_reference_metrics(capsys):
    """Same flags, same printed metrics, key for key and value for value:
    the store and engine counters do not depend on the weights."""
    (ref, _), (got, _) = _launch_both(capsys,
                                      ["--arch", "qwen2_7b"] + LAUNCH_ARGS)
    assert [ln.split()[0] for ln in got] == [ln.split()[0] for ln in ref]
    assert got == ref


@pytest.mark.parametrize("arch,flags", [
    ("gemma2_27b", []),
    ("qwen2_7b", ["--no-paged-attention"]),
])
def test_launcher_gather_plane_prints_reference_metrics(capsys, arch, flags):
    """The gather plane through both launchers: gemma2 takes it by default
    (with ``--prefill-chunk`` clamped to 1), qwen2 when
    ``--no-paged-attention`` asks for it; both say ``paged=off``."""
    (ref, ref_head), (got, head) = _launch_both(
        capsys, ["--arch", arch] + LAUNCH_ARGS + flags)
    assert got == ref
    assert "paged=off" in head[0] and "paged=off" in ref_head[0]


@pytest.mark.parametrize("flags,moved", [
    (["--host-cache-kb", "64", "--kv-quant", "int8"], None),
    (["--host-cache-kb", "64", "--kv-quant", "int8", "--cache-kb", "1",
      "--requests", "8"], "dequantized_promotions"),
    (["--host-cache-kb", "64", "--disk-cache-mb", "1"], None),
    (["--host-cache-kb", "1", "--disk-cache-mb", "1", "--cache-kb", "1",
      "--requests", "8"], "disk_promotions"),
    (["--arrival", "poisson", "--arrival-rate", "2", "--deadline-ms", "50",
      "--max-queue", "4", "--retry-rejected", "1"], None),
    (["--arrival", "poisson", "--arrival-rate", "50", "--deadline-ms", "50",
      "--max-queue", "1", "--retry-rejected", "1", "--requests", "12",
      "--host-cache-kb", "16", "--cache-kb", "1"], "n_retried"),
    (["--shards", "2", "--requests", "8"], "msg_peer_profile_broadcasts"),
    (["--shards", "2", "--requests", "8", "--host-cache-kb", "64",
      "--cache-kb", "2"], "demotions"),
    (["--shards", "2", "--arrival", "poisson", "--arrival-rate", "2",
      "--deadline-ms", "50", "--max-queue", "4"], "msg_point_to_point"),
], ids=["int8", "int8-pressure", "disk", "disk-pressure", "arrival",
        "arrival-shed", "shards", "shards-host", "shards-arrival"])
def test_launcher_tier_and_front_door_flags_print_reference_metrics(
        capsys, flags, moved):
    """The tier flags (``--host-cache-kb``, ``--kv-quant``,
    ``--disk-cache-mb``) and the front door (``--arrival``,
    ``--arrival-rate``, ``--deadline-ms``, ``--max-queue``,
    ``--retry-rejected``) through both launchers: the same metric lines.
    The flags as given, and again under a store of one KB, where chains
    demote, come back from the int8 host tier and from the disk tier, and
    a queue of one sheds arrivals that a retry takes back. With
    ``--shards 2`` the frontend's lines, the bus's among them: the port's
    byte counts less ``PROFILE_EXTRA`` a peer-profile message (pickle
    names the DAG's classes by the port's longer module path; see
    ``tests/test_torch_sharded.py``)."""
    (ref, ref_head), (got, head) = _launch_both(
        capsys, ["--arch", "qwen2_7b"] + LAUNCH_ARGS + flags)
    assert [ln.split()[0] for ln in got] == [ln.split()[0] for ln in ref]
    if "--shards" in flags:
        got = _less_profile_extra(got, int(flags[flags.index("--shards")
                                                 + 1]))
        assert "shards=2" in head[0] and "shards=2" in ref_head[0]
    assert got == ref
    for flag in ("host_cache_kb", "kv_quant", "disk_cache_mb"):
        assert head[0].split(flag)[1].split()[0] == \
            ref_head[0].split(flag)[1].split()[0]
    if moved is not None:
        value = {ln.split()[0]: ln.split()[1] for ln in got}[moved]
        assert float(value) > 0, (moved, value)


def _less_profile_extra(lines, n_shards):
    """The port's metric lines with ``msg_payload_bytes`` and
    ``msg_lerc_bytes`` less ``PROFILE_EXTRA`` for each peer-profile
    message (one to every shard a broadcast); a run without resyncs
    sends no other message that carries the DAG's classes."""
    from repro.core import BlockMeta as JaxBlockMeta
    from repro.core.coordination import payload_nbytes as jax_nbytes
    from repro_torch.core import BlockMeta
    from repro_torch.core.coordination import payload_nbytes

    extra = (payload_nbytes((BlockMeta("b", 1, "d", 0),))
             - jax_nbytes((JaxBlockMeta("b", 1, "d", 0),)))
    vals = {ln.split()[0]: ln.split()[1] for ln in lines}
    assert int(vals["msg_resyncs"]) == 0
    n = int(vals["msg_peer_profile_broadcasts"]) * n_shards
    out = []
    for ln in lines:
        key = ln.split()[0]
        if key in ("msg_payload_bytes", "msg_lerc_bytes"):
            ln = f"  {key:26s} {int(vals[key]) - extra * n}"
        out.append(ln)
    return out


BAD_FLAG_COMBOS = [
    ["--disk-cache-mb", "16"],                  # disk rung without host tier
    ["--disk-dir", "/tmp/nope"],                # dir without a disk tier
    ["--kv-quant", "int8"],                     # transcode without a tier
    ["--prefill-budget", "16"],                 # budget without the scheduler
    ["--fault-seed", "3"],                      # seed without a plan
    ["--fault-plan", "/nonexistent/plan.json"],  # unreadable plan
    ["--tp", "2", "--no-paged-attention"],      # TP needs the paged plane
]


@pytest.mark.parametrize("extra", BAD_FLAG_COMBOS,
                         ids=[" ".join(c) for c in BAD_FLAG_COMBOS])
def test_launch_rejects_bad_flag_combos(extra):
    """``tests/test_faults.py``'s combinations, every one: validation runs
    before any device or model is touched, so a bad combo exits 2 at
    once, here without ``--device cpu`` too."""
    argv = ["--arch", "qwen2_7b", "--smoke", "--requests", "2",
            "--slots", "1", "--max-seq", "32", "--cache-kb", "64",
            "--max-new", "2", "--policy", "lerc"] + extra
    with pytest.raises(SystemExit) as exc:
        serve_main(argv)
    assert exc.value.code == 2


def test_launch_refuses_a_shard_crash(tmp_path, capsys):
    """The reference's check: a plan that crashes a shard outside
    ``0..--shards-1`` is refused with the reference's message before any
    device is touched, the same plan is taken at ``--shards 2`` (the crash
    fires once, the replicas resync and verify), and a plan of disk faults
    alone is taken."""
    plan = tmp_path / "plan.json"
    plan.write_text('{"seed": 7, "shard_crashes": [[4.0, 1]]}')
    argv = ["--arch", "qwen2_7b", "--smoke", "--fault-plan", str(plan)]
    said = []
    for main in (jax_serve_main, serve_main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        said.append(capsys.readouterr().err.splitlines()[-1])
    assert said[1] == said[0]
    assert said[1].endswith("fault plan crashes shard 1 but --shards is 1 "
                            "(valid: 0..0)")
    assert serve_main(argv + LAUNCH_ARGS[1:] + [
        "--device", "cpu", "--shards", "2", "--requests", "8"]) == 0
    lines = {ln.split()[0]: ln.split()[1]
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("  ")}
    assert int(lines["shard_crashes"]) == 1
    assert int(lines["fault.shard_crash"]) == 1
    assert int(lines["msg_resyncs"]) >= 1
    plan.write_text('{"seed": 7, "disk_read_error_p": 1.0, '
                    '"quarantine_after": 1}')
    assert serve_main(argv + LAUNCH_ARGS[1:] + [
        "--device", "cpu", "--host-cache-kb", "1", "--disk-cache-mb", "1",
        "--cache-kb", "1", "--requests", "8"]) == 0
    lines = {ln.split()[0]: ln.split()[1]
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("  ")}
    assert int(lines["disk_quarantines"]) == 1


def test_scheduled_fcfs_matches_reference_run_loop(model):
    """The front door on the port's engine: driven through ``play_trace``
    under an explicit FCFS scheduler (all arrivals at t=0), it must give
    the reference's plain run loop, token for token and eviction for
    eviction."""
    from repro_torch.serve import FCFSScheduler, TracedRequest, play_trace

    jcfg, tcfg, jparams, tparams = model
    jeng, jst, jrs = _run(JaxEngine, JaxStore, jcfg, jparams, "lerc", 8,
                          None)
    st = PrefixStore(jst.capacity, "lerc", block_tokens=BT)
    eng = ServeEngine(tcfg, tparams, max_slots=2, max_seq=64, store=st,
                      prefill_chunk=8, paged=True, scheduler=FCFSScheduler(),
                      device="cpu")
    trace = [TracedRequest(t=0.0, prompt=r, max_new=MAX_NEW)
             for r in workload(tcfg.vocab)]
    report = play_trace(eng, trace)
    assert [r.generated for r in report.requests] == \
        [r.generated for r in jrs]
    assert st.eviction_log == jst.eviction_log
    assert [r.prefill_skipped for r in report.requests] == \
        [r.prefill_skipped for r in jrs]
    assert eng.steps == jeng.steps


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_backoff_readmission_matches_reference(model, paged):
    """Failover re-admission: requests whose ``not_before`` lies ahead of
    the clock wait while the others compete, and when everything queued
    backs off the clock jumps to the earliest ``not_before``. Both engines
    admit in the same order at the same virtual times, jump to the same
    times, and give the same tokens, steps, eviction log and metrics."""
    jcfg, tcfg, jparams, tparams = model
    not_before = [1.5, 4.0, 1.5, 9.0, 4.0, 1.5, 9.0, 4.0, 200.0, 200.0]
    out = []
    for cls, store_cls, cfg, params, kw in (
            (JaxEngine, JaxStore, jcfg, jparams, {}),
            (ServeEngine, PrefixStore, tcfg, tparams, {"device": "cpu"})):
        eng, st = _engine(cls, store_cls, cfg, params, "lerc", 8, None,
                          paged=paged, **kw)
        rs = [eng.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
        for r, t in zip(rs, not_before):
            r.not_before = t
        seen = []
        while eng.queue or any(s is not None for s in eng.slots):
            eng.step()
            seen.append((eng.now, eng.steps,
                         [s.rid if s is not None else None
                          for s in eng.slots]))
        out.append((seen, [r.generated for r in rs], st.eviction_log,
                    eng.metrics()))
    assert out[1] == out[0]
    seen = out[0][0]
    assert seen[0] == (1.5, 0, [None, None])      # all backing off: a jump
    assert any(now == 200.0 and slots == [None, None]
               for now, _, slots in seen)            # the jump past the rest
    late = {rs[8].rid, rs[9].rid}
    assert all(now >= 200.0 for now, _, slots in seen if late & set(slots))
    assert st.evictions > 0


def test_cancel_and_drain_match_reference(model):
    """Mid-run streaming reads and cancellations (one request mid-prefill
    or decode, one still queued) leave both engines with the same tokens,
    evictions and metrics."""
    jcfg, tcfg, jparams, tparams = model
    out = []
    for cls, store_cls, cfg, params, kw in (
            (JaxEngine, JaxStore, jcfg, jparams, {}),
            (ServeEngine, PrefixStore, tcfg, tparams, {"device": "cpu"})):
        eng, st = _engine(cls, store_cls, cfg, params, "lerc", 8, None, **kw)
        rs = [eng.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
        for _ in range(5):
            eng.step()
        streamed = eng.drain(rs[0])
        assert eng.cancel(rs[1]) and eng.cancel(rs[-1])
        assert not eng.cancel(rs[-1])              # already done
        eng.run()
        out.append((streamed, [r.generated for r in rs],
                    [r.cancelled for r in rs], st.eviction_log,
                    eng.metrics()))
    assert out[1] == out[0]
    assert out[0][4]["cancellations"] == 2


def test_eos_detection_matches_reference(model):
    """Device-side EOS: with an EOS id the workload really emits early in
    long generations, synced every 3 steps, both engines stop the same
    requests at the same step and token, with the same readback counts."""
    jcfg, tcfg, jparams, tparams = model
    max_new = 12
    _, _, plain = _run(JaxEngine, JaxStore, jcfg, jparams, "lerc", 8, None,
                       max_new=max_new)
    eos = plain[2].generated[1]
    kw = dict(eos_id=eos, eos_interval=3, max_new=max_new)
    jeng, jst, jrs = _run(JaxEngine, JaxStore, jcfg, jparams, "lerc", 8,
                          None, **kw)
    teng, tst, trs = _run(ServeEngine, PrefixStore, tcfg, tparams, "lerc", 8,
                          None, device="cpu", **kw)
    assert any(len(r.generated) < max_new - 3 for r in jrs), "no EOS hit"
    assert [r.generated for r in trs] == [r.generated for r in jrs]
    assert tst.eviction_log == jst.eviction_log
    assert teng.metrics() == jeng.metrics()


def test_trace_events_match_reference(model):
    """The port's engine emits the reference's trace: the same events, in
    the same order, with the same virtual times and arguments (only the
    wall clock differs), once the categories only the port emits are set
    aside."""
    from repro.obs import TraceRecorder as JaxRecorder
    from repro_torch.obs import TraceRecorder
    from repro_torch.obs.device import PORT_CATEGORIES

    jcfg, tcfg, jparams, tparams = model
    traces = []
    for cls, store_cls, cfg, params, rec, kw in (
            (JaxEngine, JaxStore, jcfg, jparams, JaxRecorder(), {}),
            (ServeEngine, PrefixStore, tcfg, tparams, TraceRecorder(),
             {"device": "cpu"})):
        eng, _ = _engine(cls, store_cls, cfg, params, "lerc", 8, None, **kw)
        eng.attach_trace(rec)
        for r in workload(cfg.vocab):
            eng.submit(r, max_new=MAX_NEW)
        eng.run()
        if cls is ServeEngine:
            assert eng.flush_trace() == eng.steps
        traces.append([{k: v for k, v in ev.items()
                        if k not in ("wall", "dur_wall")}
                       for ev in rec.events
                       if ev["cat"] not in PORT_CATEGORIES])
    assert len(traces[0]) > 100
    assert traces[1] == traces[0]
