"""Serve tensor parallelism of the port (``repro_torch.sharding``: the
rules, ``KVShardCtx``, ``serve_tp_context``; the head-sharded paged pool
and tiers; ``--tp``) against the reference, on the CPU in f32.

The engines run the reference's TP config (``tests/test_engine_
equivalence.py``'s ``TP_CFG``: 8 heads over 4 KV heads) on the
reference's weights, carried over by the bridge. The port's tp=2 runs as
two gloo ranks, one process each (``repro_torch.launch.ranks``), all of
its cases in one spawn; its tp=1 in this process on a one-rank group of
its own. The reference's meshless engine runs here, and its tp=2 engine
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``) and its launcher
at tp=2 in one subprocess: this file run as a script. Every run must give
the reference meshless engine's tokens, eviction, host-eviction and disk
logs, ERC counts, prefill skipped, steps and ``metrics()`` (bar
``serve_tp`` and ``device_kv_bytes``, which must be the global bytes over
tp), and at tp=2 the reference's tp=2 engine's ``metrics()`` whole; both
ranks must see the same. The cases are the reference's TP tests
(``tests/test_engine_equivalence.py:390, :416, :450, :495``,
``tests/test_faults.py:172``), a sharded frontend of two tiered shards on
``tests/test_tiered_store.py:130``'s workload (on the paged plane, which
TP needs), a lossless host tier over an int8 disk tier (the host-side
quantize takes its amax over the group) and the rules of
``tests/test_sharding.py``. Every spawned process has a deadline and is
killed past it; a rank that fails fails its test at once.
"""
import contextlib
import io
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.faults  # noqa: E402
import repro.serve  # noqa: E402
import repro.sharding  # noqa: E402
import repro_torch.faults  # noqa: E402
import repro_torch.serve  # noqa: E402
import torch_tp_ranks  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from repro.core import BlockMeta as JaxBlockMeta  # noqa: E402
from repro.core.coordination import payload_nbytes as jax_nbytes  # noqa
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models.common import ModelConfig as JaxConfig  # noqa: E402
from repro.models.common import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import MeshContext as JaxMeshContext  # noqa: E402
from repro_torch.core import BlockMeta  # noqa: E402
from repro_torch.core.coordination import payload_nbytes  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models import ModelConfig, params_from_numpy  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.sharding import (MeshContext, PartitionSpec,  # noqa: E402
                                  local_context, serve_tp_context)

ROOT = Path(__file__).resolve().parents[1]
TP_FIELDS = dict(arch="tp_smoke", family="dense", n_layers=2, d_model=32,
                 n_heads=8, n_kv_heads=4, d_head=8, d_ff=64, vocab=256,
                 act="swiglu", layer_pattern="G")
BT = 8
MAX_NEW = 4
DEADLINE = 180.0            # seconds for any spawned process
# the launchers' flags (README's --tp example at smoke size: qwen1.5-110b
# smoke has 2 KV heads; qwen2-7b smoke has 1, which tp=2 refuses)
LAUNCH = ["--smoke", "--requests", "4", "--slots", "2", "--max-seq", "32",
          "--shared-prefix", "16", "--max-new", "2", "--cache-kb", "8",
          "--block-tokens", "4", "--tp", "2"]
# pickle names the DAG's classes by module: a peer profile weighs this
# much more in the port (tests/test_torch_sharded.py)
PROFILE_EXTRA = (payload_nbytes((BlockMeta("b", 1, "d", 0),))
                 - jax_nbytes((JaxBlockMeta("b", 1, "d", 0),)))


def workload(vocab, n_requests=8, n_families=3, seed=7, prompt=32):
    """The reference tests' shared-prefix requests of uniform length."""
    rng = np.random.default_rng(seed)
    prefixes = [list(map(int, rng.integers(0, vocab, prompt - BT)))
                for _ in range(n_families)]
    return [prefixes[i % n_families]
            + list(map(int, rng.integers(0, vocab, BT)))
            for i in range(n_requests)]


def _engine_case(name, store, requests, chunk=8, **kw):
    return dict(name=name, kind="engine", store=store, requests=requests,
                max_new=MAX_NEW, engine=dict(max_slots=2, max_seq=64,
                                             prefill_chunk=chunk,
                                             paged=True), **kw)


def cases(blk, vocab):
    """Every case, as data (``tests/torch_tp_ranks.py``); byte budgets in
    multiples of the global block ``blk``."""
    out = [_engine_case("mesh1", dict(tiered=False,
                                      capacity_bytes=blk * 10,
                                      policy="lerc", block_tokens=BT),
                        workload(vocab))]
    for policy in ("lru", "lerc"):
        for tiered in (False, True):
            store = (dict(tiered=True, capacity_bytes=blk * 6,
                          policy=policy, block_tokens=BT,
                          host_capacity_bytes=blk * 64) if tiered else
                     dict(tiered=False, capacity_bytes=blk * 10,
                          policy=policy, block_tokens=BT))
            out.append(_engine_case(
                f"{policy}-{'tiered' if tiered else 'paged'}", store,
                workload(vocab, n_requests=10, n_families=2, seed=3)))
    # the reference's case in bf16 (2 and 64 of its blocks), here in f32:
    # the same byte budgets are 1 and 32 f32 blocks, so the int8 tiers
    # hold as many transcoded blocks as there
    out.append(_engine_case(
        "disk-int8", dict(tiered=True, capacity_bytes=blk * 6,
                          policy="lerc", block_tokens=BT,
                          host_capacity_bytes=blk, kv_quant="int8",
                          disk_capacity_bytes=blk * 32),
        workload(vocab, n_requests=12, n_families=3, seed=5)))
    out.append(_engine_case(
        "host-lossless-disk-int8",
        dict(tiered=True, capacity_bytes=blk * 6, policy="lerc",
             block_tokens=BT, host_capacity_bytes=blk * 2,
             disk_capacity_bytes=blk * 64, disk_quant="int8"),
        workload(vocab, n_requests=12, n_families=3, seed=5)))
    plan_store = dict(tiered=True, capacity_bytes=6 * blk, policy="lerc",
                      block_tokens=BT, host_capacity_bytes=64 * blk)
    plan_reqs = workload(vocab, n_requests=10, n_families=2, seed=5,
                         prompt=40)
    out.append(_engine_case("plan", plan_store, plan_reqs, chunk=BT,
                            faults=True))
    out.append(_engine_case("no-plan", plan_store, plan_reqs, chunk=BT))
    out.append(dict(name="frontend", kind="frontend", shards=2,
                    max_new=MAX_NEW,
                    requests=workload(vocab, n_requests=16, n_families=4,
                                      seed=11, prompt=40),
                    engine=dict(max_slots=1, max_seq=64,
                                capacity_bytes=blk * 8, policy="lerc",
                                block_tokens=BT, prefill_chunk=BT,
                                host_capacity_bytes=blk * 10,
                                paged=True, record_eviction_log=True)))
    out.append(dict(name="refuse", kind="refuse", arch="qwen2_7b",
                    engine=dict(max_slots=2, max_seq=64, paged=True)))
    return out


# ------------------------------------------------- the runs, started once


def _jax_model():
    jcfg = JaxConfig(**TP_FIELDS, dtype=jnp.float32)
    jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                              dtype=jnp.float32)
    return jcfg, jparams


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), **kw)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return env


def _finish(proc, what):
    """Wait for ``proc`` to its deadline (killed past it); its output."""
    try:
        out, err = proc.communicate(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{what} passed its deadline of {DEADLINE} s:\n{err}")
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every out-of-process run at once: the port's tp=2 ranks on
    every case, the reference's tp=2 subprocess (engines and launcher),
    the port's launcher at ``--tp 2`` and at a refused ``--tp 2``; then
    wait for all of them."""
    jobdir = tmp_path_factory.mktemp("tp")
    jcfg, jparams = _jax_model()
    probe = repro.serve.ServeEngine(
        jcfg, jparams, max_slots=2, max_seq=64,
        store=repro.serve.PrefixStore(1 << 30, "lerc", block_tokens=BT),
        pool_blocks=1, paged=True)
    job = {"cfg": TP_FIELDS, "params": jax.device_get(jparams),
           "cases": cases(probe._block_nbytes(), jcfg.vocab)}
    with open(jobdir / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = _env(OMP_NUM_THREADS="1")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, __file__, str(jobdir)], text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                     JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "launch": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "qwen1_5_110b", *LAUNCH, "--device", "cpu"], text=True,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        "refused": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "qwen2_7b", *LAUNCH, "--device", "cpu"], text=True, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)}
    rc = {}
    spawner = threading.Thread(target=lambda: rc.update(ranks=ranks.spawn(
        ["-m", "repro_torch.launch.ranks", "torch_tp_ranks:main",
         str(jobdir)], 2, timeout=DEADLINE, env=env)))
    spawner.start()
    done = {name: _finish(p, name) for name, p in procs.items()}
    spawner.join(DEADLINE)
    assert not spawner.is_alive(), "the ranks' spawner passed its deadline"
    assert rc["ranks"] == 0, f"a rank of the port failed: {rc}"
    assert done["jax"][0] == 0, done["jax"][2]
    with open(jobdir / "jax_tp2.pkl", "rb") as f:
        jax_tp2 = pickle.load(f)
    ranks_out = []
    for r in (0, 1):
        with open(jobdir / f"rank{r}.pkl", "rb") as f:
            ranks_out.append(pickle.load(f))
    return {"job": job, "ranks": ranks_out, "jax_tp2": jax_tp2,
            "launch": done["launch"], "refused": done["refused"]}


@pytest.fixture(scope="module")
def tp1():
    """The port's tp=1 context: a one-rank gloo group of this process's
    own, torn down after the module."""
    ctx = serve_tp_context(1, "cpu")
    yield ctx
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = _jax_model()
    tcfg = ModelConfig(**TP_FIELDS, dtype=torch.float32)
    return jcfg, jparams, tcfg, params_from_numpy(jax.device_get(jparams))


def _case(runs, name):
    return next(c for c in runs["job"]["cases"] if c["name"] == name)


def _jax_meshless(models, case):
    jcfg, jparams, _, _ = models
    return torch_tp_ranks.run(repro.serve, jcfg, jparams, case,
                              repro.faults)


def _port(models, case, **kw):
    _, _, tcfg, tparams = models
    return torch_tp_ranks.run(repro_torch.serve, tcfg, tparams, case,
                              repro_torch.faults, device="cpu", **kw)


def _as_meshless(obs):
    """``obs`` with the per-device byte split folded back: what a meshless
    engine reports (checked: ``device_kv_bytes`` is the global bytes over
    tp)."""
    m = dict(obs["metrics"])
    tp = m["serve_tp"]
    assert m["device_kv_bytes"] * tp == m["kv_bytes_global"]
    assert obs["pool_nbytes_per_device"] * tp == obs["pool_nbytes"]
    assert obs["tp"] == tp
    m["serve_tp"] = 1
    m["device_kv_bytes"] = m["kv_bytes_global"]
    return {**obs, "metrics": m, "tp": 1,
            "pool_nbytes_per_device": obs["pool_nbytes"]}


def _tiers(obs):
    """(``obs`` without its tiers' bytes, the tiers' bytes)."""
    obs = dict(obs)
    return obs, obs.pop("tiers", None)


def _assert_tier_slices(slices, want):
    """The ranks' host and disk tiers hold, side by side on the KV-head
    axis, the bytes of the port's meshless engine's tiers (``want``), and
    every rank its scales, bit for bit."""
    for tier, ref in want.items():
        if ref is None:
            assert all(s[tier] is None for s in slices)
            continue
        bufs, scales = ref
        for path, buf in bufs.items():
            got = np.concatenate([s[tier][0][path] for s in slices],
                                 axis=-2)
            np.testing.assert_array_equal(got, np.asarray(buf),
                                          err_msg=f"{tier} {path}")
        for s in slices:
            assert (s[tier][1] is None) == (scales is None)
            for path, sc in (scales or {}).items():
                np.testing.assert_array_equal(s[tier][1][path], sc)


def _assert_tp2(runs, models, name):
    """The port's tp=2 ranks agree with each other, with the reference's
    meshless engine and with its tp=2 engine; their tiers' rows are the
    head slices of the port's meshless tiers. Returns the observation."""
    got, slices = zip(*(_tiers(r[name]) for r in runs["ranks"]))
    assert got[1] == got[0], "the ranks disagree"
    assert got[0]["tp"] == 2
    case = _case(runs, name)
    assert _as_meshless(got[0]) == _tiers(_jax_meshless(models, case))[0]
    assert got[0] == _tiers(runs["jax_tp2"][name])[0]
    _assert_tier_slices(slices, _tiers(_port(models, case))[1])
    return got[0]


# ------------------------------------------------------------- the engine


def test_mesh1_engine_bit_identical(models, runs, tp1):
    """``tests/test_engine_equivalence.py:390``: an engine on a one-rank
    group (the collective runs, the head slice is all heads) is the
    meshless engine's, and the reference's: tokens, eviction log, ERC
    counters; the per-device/global byte split collapses at tp=1."""
    case = _case(runs, "mesh1")
    base = _tiers(_port(models, case))[0]
    mesh = _tiers(_port(models, case, kv_shard=tp1))[0]
    assert base["metrics"]["evictions"] > 0, "workload produced no pressure"
    assert mesh == base
    assert mesh["tp"] == 1
    assert mesh["pool_nbytes_per_device"] == mesh["pool_nbytes"]
    assert mesh == _tiers(_jax_meshless(models, case))[0]


def test_packed_step_on_a_one_rank_group(models, tp1):
    """The packed rows' step (``lm_packed_step``) through the TP path on a
    one-rank group (the head slice is all heads, the all-gather runs)
    equals the step without a group bit for bit, logits and pool, and the
    dense paged step on the group within f32, on a mix of a decoding
    slot, a full and a partial chunk and an idle slot."""
    from repro_torch.models import (decode_cache_shapes, lm_decode_step,
                                    lm_packed_step, tree_paths)
    from repro_torch.serve.step_graph import pack_feed, unpack
    _, _, tcfg, tparams = models
    B, nw = 4, 4
    tables = np.arange(1, 1 + B * nw, dtype=np.int32).reshape(B, nw)
    slot = np.array([0, 1, 2], np.int32)
    pos = np.array([13, 8, 16], np.int32)
    n = np.array([1, 8, 3], np.int32)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, int(n.sum())).astype(np.int32)
    g = torch.Generator().manual_seed(0)
    pool0 = {k: {n_: torch.randn(s, generator=g) for n_, s in v.items()}
             for k, v in decode_cache_shapes(
                 tcfg, 1 + B * nw, BT)["stack"].items()}
    feed = pack_feed(B, 8, BT, tables, slot, pos, n,
                     np.zeros(3, bool), np.ones(3, bool), np.zeros(B, bool),
                     tokens)
    tok, rows, _, _, _ = unpack(torch.from_numpy(feed.data), B, feed.T,
                                feed.S, torch.from_numpy(tables))
    outs = []
    for shard in (None, tp1):
        pool = {"stack": {k: {n_: t.clone() for n_, t in v.items()}
                          for k, v in pool0.items()}}
        logits, _ = lm_packed_step(tcfg, tparams, pool, tok[:-1], rows,
                                   kv_shard=shard)
        outs.append((logits, pool))
    (plain, p_pool), (grouped, g_pool) = outs
    assert torch.equal(plain, grouped)
    for (_, a), (_, b) in zip(tree_paths(p_pool), tree_paths(g_pool)):
        assert torch.equal(a, b)
    grid = np.zeros((B, 8), np.int32)
    grid[0, 0], grid[1], grid[2, :3] = tokens[0], tokens[1:9], tokens[9:]
    dpos, lens = np.zeros(B, np.int32), np.zeros(B, np.int32)
    dpos[slot], lens[slot] = pos, n
    pool = {"stack": {k: {n_: t.clone() for n_, t in v.items()}
                      for k, v in pool0.items()}}
    dense, _ = lm_decode_step(tcfg, tparams, pool, torch.from_numpy(grid),
                              torch.from_numpy(dpos),
                              seq_lens=torch.from_numpy(lens),
                              paged_tables=torch.from_numpy(tables),
                              kv_shard=tp1)
    np.testing.assert_allclose(grouped[slot].numpy(), dense[slot].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tiered", [False, True], ids=["paged", "tiered"])
@pytest.mark.parametrize("policy", ["lru", "lerc"])
def test_tp_engines_token_identical(models, runs, tp1, policy, tiered):
    """``tests/test_engine_equivalence.py:416``: tp=1 and tp=2 engines
    against the meshless engine: the same tokens, bit-identical eviction
    logs (and demotion/promotion streams on the tiered store), the global
    bytes split per device."""
    name = f"{policy}-{'tiered' if tiered else 'paged'}"
    want = _tiers(_jax_meshless(models, _case(runs, name)))[0]
    m = want["metrics"]
    if tiered:
        assert m["promotions"] > 0, "no promotion exercised"
    else:
        assert m["evictions"] > 0, "workload produced no pressure"
    got, tiers = _tiers(_port(models, _case(runs, name), kv_shard=tp1))
    assert _as_meshless(got) == want
    _assert_tier_slices([tiers], _tiers(_port(models, _case(runs, name)))[1])
    got = _assert_tp2(runs, models, name)
    assert got["metrics"]["serve_tp"] == 2


def test_tp_disk_quant_promotion_token_identical(models, runs):
    """``tests/test_engine_equivalence.py:450``: an int8 host tier over a
    disk rung at tp=2, the device quantize's amax reduced over the group:
    the tokens, all three eviction logs and the tier counters of tp=1."""
    got = _assert_tp2(runs, models, "disk-int8")
    m = got["metrics"]
    assert m["quantized_demotions"] > 0, "nothing was transcoded"
    assert m["disk_promotions"] > 0, "no chain came back from disk"


def test_tp_lossless_host_over_int8_disk(models, runs):
    """A lossless host tier over an int8 disk tier at tp=2: each rank's
    host rows quantize on the host as they demote to disk, their amax
    reduced over the group, so each rank writes its slice of the tp=1
    bytes."""
    got = _assert_tp2(runs, models, "host-lossless-disk-int8")
    m = got["metrics"]
    assert m["quantized_demotions"] > 0 and m["disk_promotions"] > 0, m


def test_empty_plan_bit_identity_tp2(models, runs):
    """``tests/test_faults.py:172``: an empty fault plan on a tp=2 paged
    engine over a tiered store is bit-identical to no plan."""
    plan = _assert_tp2(runs, models, "plan")
    assert plan == _tiers(runs["ranks"][0]["no-plan"])[0]


def test_tp_sharded_frontend(models, runs):
    """Two tiered shards of tp=2 engines (``tests/test_tiered_store.py:
    130``'s workload, on the paged plane) against the reference's frontend
    without TP: tokens, per-shard eviction and host logs, the replicas'
    logs, ``verify_replicas`` on every rank, and metrics; the port's
    ``msg_*`` bytes less ``PROFILE_EXTRA`` a peer-profile message (see
    ``tests/test_torch_sharded.py``)."""
    got = [r["frontend"] for r in runs["ranks"]]
    assert got[1] == got[0], "the ranks disagree"
    want = _jax_meshless(models, _case(runs, "frontend"))
    assert got[0]["tokens"] == want["tokens"]
    assert got[0]["replica_logs"] == want["replica_logs"]
    for s, w in zip(got[0]["shards"], want["shards"]):
        assert _as_meshless(s) == w
    m = dict(got[0]["metrics"])
    n = m["msg_peer_profile_broadcasts"] * 2
    m["msg_payload_bytes"] -= PROFILE_EXTRA * n
    m["msg_lerc_bytes"] -= PROFILE_EXTRA * n
    assert m == want["metrics"]
    assert want["metrics"]["demotions"] > 0


def test_tp_rejects_gather_plane_and_indivisible_heads(models, runs, tp1):
    """``tests/test_engine_equivalence.py:495``: TP is paged-plane only
    and refuses KV-head counts it cannot split, with the reference's
    messages (qwen2-7b smoke has one KV head)."""
    jcfg, jparams, tcfg, tparams = models
    said = []
    for make in (lambda: repro.serve.ServeEngine(
                     jcfg, jparams, max_slots=2, max_seq=64, paged=False,
                     kv_shard=repro.sharding.serve_tp_context(1)),
                 lambda: ServeEngine(tcfg, tparams, max_slots=2,
                                     max_seq=64, paged=False, kv_shard=tp1,
                                     device="cpu")):
        with pytest.raises(ValueError, match="gather") as e:
            make()
        said.append(str(e.value))
    assert said[1] == said[0]
    refused = [r["refuse"] for r in runs["ranks"]]
    assert refused[0] == refused[1] == runs["jax_tp2"]["refuse"]
    assert "kv_heads=1" in refused[0]


def test_serve_tp_context_needs_a_group_of_tp(tp1):
    """tp=2 in a process whose group has one rank is refused, as the
    reference refuses a mesh wider than its visible devices."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        serve_tp_context(2, "cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        ServeEngine(ModelConfig(**TP_FIELDS, dtype=torch.float32), {},
                    max_slots=2, max_seq=64, paged=True, tp=2,
                    device="cpu")


# ----------------------------------------------------------- the launcher


def _lines(out):
    return ([ln for ln in out.splitlines() if ln.startswith("  ")],
            [ln for ln in out.splitlines() if ln.startswith("policy=")])


def test_launcher_tp2_prints_reference_lines(runs):
    """``--arch qwen1_5_110b --smoke --tp 2 --device cpu``: the launcher
    starts two ranks; rank 0 prints what the reference's launcher prints
    at ``--tp 2`` (on two forced host devices), metric for metric."""
    rc, out, err = runs["launch"]
    assert rc == 0, err
    got, head = _lines(out)
    want, want_head = _lines(runs["jax_tp2"]["launch"])
    assert len(head) == 1, out               # rank 0 alone prints
    assert got == want
    assert "tp=2" in head[0] and "tp=2" in want_head[0]
    assert "paged=on" in head[0]


def test_launcher_exits_nonzero_when_a_rank_fails(runs):
    """``--tp 2`` on qwen2-7b smoke (one KV head): every rank's engine
    refuses, and the launcher exits with the ranks' failure at once."""
    rc, _, err = runs["refused"]
    assert rc != 0
    assert "kv_heads=1" in err


def test_launch_refuses_tp_on_the_gather_plane():
    """The reference's check, before any device or model is touched."""
    from repro_torch.launch.serve import serve_main

    with pytest.raises(SystemExit) as exc:
        serve_main(["--arch", "qwen2_7b", "--smoke", "--tp", "2",
                    "--no-paged-attention"])
    assert exc.value.code == 2


# ------------------------------------------------------------- the rules


class _StubMesh:
    """Quacks like jax.sharding.Mesh for axis-size queries."""

    def __init__(self, shape):
        self.shape = shape
        self.size = 1
        for v in shape.values():
            self.size *= v


def _ctxs(multi_pod=False, **kw):
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return (MeshContext(mesh=_StubMesh(shape), data_axes=data_axes, **kw),
            JaxMeshContext(mesh=_StubMesh(shape), data_axes=data_axes,
                           **kw))


def _specs(shape, axes):
    return ParamSpec(shape, axes), JaxParamSpec(shape, axes)


def _same(port_spec, ref_spec, want):
    """The port's spec is the reference's, and the reference test's."""
    assert isinstance(port_spec, PartitionSpec)
    assert tuple(port_spec) == tuple(ref_spec) == tuple(want)


def test_tp_and_fsdp_assignment():
    c, r = _ctxs()
    for shape, axes, want in (
            ((8192, 64, 128), ("embed", "heads", "head_dim"),
             JP("data", "model")),
            ((8192, 2, 49152), ("embed", None, "ff"),
             JP("data", None, "model")),
            ((152064, 8192), ("vocab", "embed"), JP("model", "data"))):
        p, j = _specs(shape, axes)
        _same(c.param_pspec(p), r.param_pspec(j), want)


def test_gathered_layout_drops_fsdp():
    c, r = _ctxs()
    p, j = _specs((8192, 2, 49152), ("embed", None, "ff"))
    _same(c.param_pspec(p, fsdp=False), r.param_pspec(j, fsdp=False),
          JP(None, None, "model"))


def test_divisibility_fallback():
    c, r = _ctxs()
    p, j = _specs((8192, 8, 128), ("embed", "kv_heads", "head_dim"))
    _same(c.param_pspec(p), r.param_pspec(j), JP("data"))
    p, j = _specs((4097, 8, 128), ("embed", "kv_heads", "head_dim"))
    _same(c.param_pspec(p), r.param_pspec(j), JP())


def test_axis_used_once_per_tensor():
    c, r = _ctxs()
    p, j = _specs((64, 2048, 2, 1408), ("experts", "embed", None, "ff"))
    spec = c.param_pspec(p)
    _same(spec, r.param_pspec(j), JP("model", "data"))
    flat = [a for a in spec if a is not None]
    assert len(flat) == len(set(flat))


def test_multi_pod_fsdp_spans_pod_and_data():
    c, r = _ctxs(multi_pod=True)
    p, j = _specs((8192, 2, 49152), ("embed", None, "ff"))
    _same(c.param_pspec(p), r.param_pspec(j),
          JP(("pod", "data"), None, "model"))
    assert c.dp_size == r.dp_size == 32
    assert c.tp_size == r.tp_size == 16


def test_stacked_layer_axis_stays_replicated():
    c, r = _ctxs()
    p, j = _specs((80, 8192, 2, 49152), ("layer", "embed", None, "ff"))
    _same(c.param_pspec(p), r.param_pspec(j),
          JP(None, "data", None, "model"))


def test_batch_pspec_sp():
    c, r = _ctxs()
    _same(c.batch_pspec((256, 4096)), r.batch_pspec((256, 4096)),
          JP("data", "model"))
    _same(c.batch_pspec((1, 4096)), r.batch_pspec((1, 4096)),
          JP(None, "model"))
    c, r = _ctxs(seq_shard=False)
    _same(c.batch_pspec((256, 4096)), r.batch_pspec((256, 4096)),
          JP("data", None))


def test_cache_pspec_kv_and_fallbacks():
    c, r = _ctxs()
    for path, shape, want in (
            (("stack", "0_G", "k"), (28, 128, 32768, 16, 128),
             JP(None, "data", None, "model")),
            (("stack", "1_G", "k"), (23, 1, 524288, 16, 128),
             JP(None, None, "data", "model")),
            (("k",), (6, 128, 32768, 8, 64), JP(None, "data", "model"))):
        _same(c.cache_pspec(path, shape), r.cache_pspec(path, shape), want)


def test_cache_pspec_recurrent_states():
    c, r = _ctxs()
    for path, shape, want in (
            (("stack", "0_R", "h"), (12, 128, 4096),
             JP(None, "data", "model")),
            (("stack", "0_W", "S"), (32, 128, 16, 160, 160),
             JP(None, "data", "model"))):
        _same(c.cache_pspec(path, shape), r.cache_pspec(path, shape), want)


def test_local_context_and_mesh_lowering_refused():
    """``local_context`` has no mesh (every axis of size 1), and its
    lowering methods return their input unchanged, as the reference's do
    (the mesh path's own lowering is tests/test_torch_mesh.py's). A mesh
    of axis sizes only (no ``DeviceMesh``) serves the rules but refuses
    every lowering method."""
    c = local_context()
    assert c.mesh is None and c.tp_size == 1 and c.dp_size == 1
    p, j = _specs((8192, 64, 128), ("embed", "heads", "head_dim"))
    _same(c.param_pspec(p), repro.sharding.local_context().param_pspec(j),
          JP())
    x = torch.zeros(2, 4)
    assert c.param_sharding(p) is None and c.replicated() is None
    assert c.constrain_tree({"w": x}, {"w": p})["w"] is x
    for fn in (c.gather_seq, c.shard_activations,
               lambda t: c.constrain_dims(t, ("data", None))):
        assert fn(x) is x
    for t in (c.batch_sharding((2, 4)),
              c.cache_sharding(("k",), (1, 2), torch.bfloat16)):
        assert t.device.type == "meta"
    mc, _ = _ctxs()
    for call in (lambda: mc.param_sharding(p),
                 lambda: mc.constrain_tree({}, {}),
                 lambda: mc.batch_sharding((2, 4)),
                 lambda: mc.constrain_dims(x, ("data", None)),
                 lambda: mc.gather_seq(x),
                 lambda: mc.shard_activations(x),
                 lambda: mc.cache_sharding(("k",), (1,), None),
                 mc.replicated):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()


# ----------------------------- the reference at tp=2, in a subprocess


def _jax_tp2(jobdir: str) -> None:
    """Run as a script with two forced host devices: every case but the
    meshless ones on the reference's tp=2 engines, and its launcher at
    ``--tp 2``; results in ``JOBDIR/jax_tp2.pkl``."""
    from repro.launch.serve import serve_main

    assert jax.device_count() == 2, jax.devices()
    with open(os.path.join(jobdir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    jcfg = JaxConfig(**job["cfg"], dtype=jnp.float32)
    jparams = jax.tree.map(jnp.asarray, job["params"])
    out = {}
    for case in job["cases"]:
        if case["kind"] == "refuse":
            from repro import configs as jax_configs
            out[case["name"]] = torch_tp_ranks.run(
                repro.serve, jax_configs.get(case["arch"], smoke=True), {},
                case, tp=2)
        elif case["name"] != "mesh1":
            out[case["name"]] = torch_tp_ranks.run(
                repro.serve, jcfg, jparams, case, repro.faults, tp=2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_main(["--arch", "qwen1_5_110b", *LAUNCH]) == 0
    out["launch"] = buf.getvalue()
    with open(os.path.join(jobdir, "jax_tp2.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _jax_tp2(sys.argv[1])
