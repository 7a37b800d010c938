"""The port's mesh path (``repro_torch.sharding.MeshContext`` on DTensor,
``launch.mesh``, the mesh forms of the model, the expert-parallel MoE, the
mesh train step and the dry run's accounting) against the reference, on
the CPU.

* (a) ``tests/test_sharding.py``'s cases through the port's placements,
  and rank r's shard of a ``("pod", "data")``-sharded tensor equal to
  the shard JAX gives the r-th device of the mesh.
* (b) rank 0's local shape of every train-state leaf, every arch, on both
  production meshes (a fake group of 256 / 512 ranks) against
  ``NamedSharding.shard_shape`` of the reference's
  ``abstract_train_state``.
* (c) the argument and output bytes of smoke cells on a (2, 2) fake mesh
  against the reference's compiled ``memory_summary``.
* (d) loss and full gradients on four gloo ranks, a (2, 2) mesh, against
  the reference on four forced CPU devices, f32 smoke: qwen2 (7 heads:
  the context-parallel fallback), gemma2 (L layers, softcaps),
  paligemma (prefix-LM) and moonshot (3 heads: context parallel; EP over
  two model ranks on a batch where capacity drops tokens).
* (e) one AdamW step on the mesh against the reference's.
* (f) the EP MoE at ep=1 against the reference's ``_moe_ep_device`` on a
  one-device mesh (not ``_moe_local``: capacity drops tokens).
* (g) ``flash_attention_plain`` at ``q_offset``.

The reference's mesh builders make ``Explicit`` axes under this JAX
(ROADMAP.md §3), so its side builds ``MeshContext`` over an ``Auto``
mesh. The reference runs in subprocesses (this file as a script, one on 512
forced devices, one an arch on 4), the port's (2, 2) cases on four gloo ranks
(``tests/torch_mesh_ranks.py``) and its fake-group cases in a process of
their own, all started at once, each with a deadline.
"""
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

import torch_mesh_ranks  # noqa: E402
from jax.sharding import AbstractMesh, AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.common import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import MeshContext as JaxMeshContext  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention_plain  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.sharding import MeshContext  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 420.0            # seconds for any spawned process
TOL = 2e-4                  # the port's f32 parity bar
# (arch, one AdamW step too). The weights (key 0) and the (2, 24) batch
# are tests/test_torch_train.py's gradient case's; on moonshot's, EP
# capacity drops tokens (asserted)
CASES = [("qwen2_7b", True), ("gemma2_27b", False), ("paligemma_3b", False),
         ("moonshot_v1_16b_a3b", False)]
BATCH = (2, 24)
# the archs of (c)'s cells, one reference process each
CELL_ARCHS = sorted({arch for arch, _ in torch_mesh_ranks.BYTES_CELLS})


def _auto_mesh(shape, axes):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])


def _jax_ctx(shape=(2, 2), axes=("data", "model")):
    return JaxMeshContext(mesh=_auto_mesh(shape, axes),
                          data_axes=tuple(a for a in axes if a != "model"))


def _jax_cfg(arch):
    return jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        **kw)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return env


def _finish(proc, what):
    try:
        out, err = proc.communicate(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{what} passed its deadline of {DEADLINE} s:\n{err}")
    assert proc.returncode == 0, f"{what} failed:\n{err[-4000:]}"
    return out


def _job():
    cases = []
    for arch, adamw in CASES:
        cfg = _jax_cfg(arch)
        params = jax.device_get(jax_init_params(
            jax.random.key(0), jax_model_spec(cfg), dtype=jnp.float32))
        rng = np.random.default_rng(4)
        batch = {k: rng.integers(0, cfg.vocab, BATCH).astype(np.int32)
                 for k in ("tokens", "targets")}
        if cfg.frontend == "patch_embed":
            batch["patches"] = rng.standard_normal(
                (BATCH[0], cfg.frontend_len, cfg.frontend_dim)).astype(
                np.float32)
        cases.append({"arch": arch, "params": params, "batch": batch,
                      "adamw": adamw})
    return {"cases": cases}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every out-of-process run, started at once: the reference on 4 and
    on 512 forced devices, the port's four gloo ranks and its fake-group
    process; then wait for all of them."""
    jobdir = tmp_path_factory.mktemp("mesh")
    (jobdir / "job.pkl").write_bytes(pickle.dumps(_job()))
    ref4 = [("ref4_cases", str(jobdir), arch) for arch, _ in CASES] + [
        ("ref4_cells", str(jobdir), arch) for arch in CELL_ARCHS]
    procs = {
        f"reference {args}": subprocess.Popen(
            [sys.executable, __file__, *args], text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for args in ref4}
    procs.update({
        "reference (512 devices)": subprocess.Popen(
            [sys.executable, __file__, "ref512", str(jobdir)], text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=512",
                     JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE),
        **{f"port (fake group) {part}": subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_ranks.py"),
             str(jobdir), *part], text=True, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
           for part in [("shapes",)] + [("cells", a) for a in CELL_ARCHS]}})
    rc = {}
    spawner = threading.Thread(target=lambda: rc.update(ranks=ranks.spawn(
        ["-m", "repro_torch.launch.ranks", "torch_mesh_ranks:main",
         str(jobdir)], 4, timeout=DEADLINE, env=_env())))
    spawner.start()
    for name, p in procs.items():
        _finish(p, name)
    spawner.join(DEADLINE)
    assert not spawner.is_alive(), "the ranks' spawner passed its deadline"
    assert rc["ranks"] == 0, f"a rank of the port failed: {rc}"
    def load(name):
        return pickle.loads((jobdir / f"{name}.pkl").read_bytes())

    out = {name: load(name) for name in ("ref512", "port_mesh")}
    out["ref4"] = {"cells": {}, "cases": {}}
    out["port_fake"] = load("port_fake_shapes")
    out["port_fake"]["cells"] = {}
    for arch in CELL_ARCHS:
        out["ref4"]["cells"].update(load(f"ref4_cells_{arch}"))
        out["port_fake"]["cells"].update(load(f"port_fake_cells_{arch}"))
    for arch, _ in CASES:
        out["ref4"]["cases"][arch] = load(f"ref4_cases_{arch}")
    return out


# ------------------------------------------------------------------ (a)


class _StubMesh:
    """The axis names and sizes of a mesh, as ``placements`` reads them."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())
        self.shape = shape
        self.ndim = len(shape)

    def size(self, i):
        return self._sizes[i]


def _ctx(multi_pod=False, **kw):
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    axes = ("pod", "data") if multi_pod else ("data",)
    return MeshContext(mesh=_StubMesh(shape), data_axes=axes, **kw)


# tests/test_sharding.py's cases: (spec shape, axes, multi-pod, fsdp,
# expected PartitionSpec)
SHARDING_CASES = [
    ((8192, 64, 128), ("embed", "heads", "head_dim"), False, None,
     ("data", "model")),
    ((8192, 2, 49152), ("embed", None, "ff"), False, None,
     ("data", None, "model")),
    ((152064, 8192), ("vocab", "embed"), False, None, ("model", "data")),
    ((8192, 2, 49152), ("embed", None, "ff"), False, False,
     (None, None, "model")),
    ((8192, 8, 128), ("embed", "kv_heads", "head_dim"), False, None,
     ("data",)),
    ((4097, 8, 128), ("embed", "kv_heads", "head_dim"), False, None, ()),
    ((64, 2048, 2, 1408), ("experts", "embed", None, "ff"), False, None,
     ("model", "data")),
    ((8192, 2, 49152), ("embed", None, "ff"), True, None,
     (("pod", "data"), None, "model")),
    ((80, 8192, 2, 49152), ("layer", "embed", None, "ff"), False, None,
     (None, "data", None, "model")),
]


def _expected_placements(names, pspec):
    out = [Replicate()] * len(names)
    for t, entry in enumerate(pspec):
        for a in (entry if isinstance(entry, tuple) else
                  (() if entry is None else (entry,))):
            out[names.index(a)] = Shard(t)
    return out


@pytest.mark.parametrize("case", SHARDING_CASES,
                         ids=lambda c: f"{c[1]}-{'pod' if c[2] else 'sp'}")
def test_sharding_cases_through_placements(case):
    shape, axes, multi_pod, fsdp, want = case
    c = _ctx(multi_pod)
    spec = ParamSpec(shape, axes)
    pspec = c.param_pspec(spec, fsdp=fsdp)
    jc = JaxMeshContext(mesh=c.mesh, data_axes=c.data_axes)
    assert tuple(pspec) == tuple(jc.param_pspec(JaxParamSpec(shape, axes),
                                                fsdp=fsdp)) == want
    names = c.mesh.mesh_dim_names
    pl = c.placements(pspec)
    assert pl == _expected_placements(names, want)
    if fsdp is None:
        assert c.placements(c.param_pspec(spec)) == pl
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= c.mesh.size(i)
    assert tuple(local) == NamedSharding(
        AbstractMesh(tuple(c.mesh._sizes), names),
        JP(*want)).shard_shape(shape)


def test_batch_and_cache_cases_through_placements():
    c = _ctx()
    assert c.placements(c.batch_pspec((256, 4096))) == [Shard(0), Shard(1)]
    assert c.placements(c.batch_pspec((1, 4096))) == [Replicate(), Shard(1)]
    p = c.cache_pspec(("stack", "0_G", "k"), (28, 128, 32768, 16, 128))
    assert c.placements(p) == [Shard(1), Shard(3)]
    p = c.cache_pspec(("stack", "0_R", "h"), (12, 128, 4096))
    assert c.placements(p) == [Shard(1), Shard(2)]


def test_placements_refuse_an_axis_order_jax_would_not_give():
    c = _ctx(multi_pod=True)
    with pytest.raises(ValueError, match="major axis"):
        c.placements((("data", "pod"),))
    with pytest.raises(ValueError, match="used twice"):
        c.placements(("model", "model"))


def test_pod_major_shards_follow_jax_device_order(runs):
    """Rank r of a (pod=2, data=2, model=2) mesh holds, for a tensor
    sharded P(("pod","data"), "model"), the shard JAX puts on the r-th
    device of the same mesh."""
    want = runs["ref512"]["pod_major"]
    got = runs["port_fake"]["pod_major"]
    assert len(got) == len(want) == 8
    for r in range(8):
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"rank {r}")


# ------------------------------------------------------------------ (b)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_state_local_shapes_match_reference(runs, arch, multi_pod):
    got = runs["port_fake"]["shapes"][(arch, multi_pod)]
    want = runs["ref512"]["shapes"][(arch, multi_pod)]
    assert got == want


def test_mesh_size_must_match_the_group(runs):
    msg = runs["port_fake"]["mismatch"]
    assert "needs 4 ranks" in msg and "has 8" in msg


# ------------------------------------------------------------------ (c)


# XLA's CPU executable returns several outputs as one tuple buffer, whose
# table of 8-byte pointers its output size counts too
TUPLE_ENTRY = 8


@pytest.mark.parametrize("cell", torch_mesh_ranks.BYTES_CELLS,
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_bytes_match_reference(runs, cell):
    got = runs["port_fake"]["cells"][cell]
    want = runs["ref4"]["cells"][cell]
    assert got["argument_bytes"] == want["argument_bytes"]
    n = want["n_outputs"]
    table = TUPLE_ENTRY * n if n > 1 else 0
    assert got["output_bytes"] == want["output_bytes"] - table
    assert got["temp_bytes"] is None and got["alias_bytes"] is None
    assert got["peak_bytes"] >= got["argument_bytes"]


def test_sequence_sharded_smoke_caches_are_refused(runs):
    """The smoke decode cells whose cache shards the sequence over the
    model axis (one or three KV heads on two model ranks) compile on the
    fake (2, 2) mesh: each rank attends its slice of the cache and the
    partial attentions merge through K2's log-sum-exp."""
    cells = runs["port_fake"]["seq_sharded"]
    assert set(cells) == {"qwen2_7b", "moonshot_v1_16b_a3b"}
    for r in cells.values():
        assert r["ok"] is True and r["devices"] == 4
        assert r["kv_pspec"][2] == "model", r["kv_pspec"]
        assert 0 < r["memory"]["argument_bytes"] <= r["memory"]["peak_bytes"]
        # the merge's all-reduces over the model axis, a max and a sum an
        # attention layer
        assert r["collectives"]["per_kind_count"]["all-reduce"] > 0


# ------------------------------------------------------------------ (d)


def _spread(a, b):
    """The largest difference of a and b over b's largest magnitude (at
    least 1)."""
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / max(
        1.0, float(np.abs(b).max()))


def _close(got, want, what, bar=TOL):
    assert _spread(got, want) <= bar, (what, _spread(got, want), bar)


# leaves whose f32 gradient the reference itself does not give within the
# bar: its mesh and meshless gradients differ by more (paligemma's tied
# embedding: 6e-4 of its largest; 1.1e-3 and 1.7e-3 from f64). They are
# held to that spread of the reference's own, which the test checks is
# above the bar
REFERENCE_NOISE = {("paligemma_3b", "embed/tok")}


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_mesh_loss_and_grads_match_reference(runs, arch):
    got, want = runs["port_mesh"][arch], runs["ref4"]["cases"][arch]
    _close(got["loss"], want["loss"], "loss")
    assert set(got["grads"]) == set(want["grads"])
    for path, g in want["grads"].items():
        bar = TOL
        if (arch, path) in REFERENCE_NOISE:
            bar = _spread(g, want["local_grads"][path])
            assert bar > TOL, (path, bar)
        _close(got["grads"][path], g, path, bar)


def test_ep_capacity_drops_tokens_on_the_moonshot_case(runs):
    """The moonshot batch overflows an expert's capacity: the reference's
    EP loss departs from its dense one, and the port counts the drops."""
    ref = runs["ref4"]["cases"]["moonshot_v1_16b_a3b"]
    assert abs(ref["loss"] - ref["local_loss"]) > 10 * TOL
    assert runs["port_mesh"]["moonshot_v1_16b_a3b"]["dropped"] > 0
    for arch in ("qwen2_7b", "gemma2_27b", "paligemma_3b"):
        assert runs["port_mesh"][arch]["dropped"] == 0


# ------------------------------------------------------------------ (e)


def test_adamw_step_on_mesh_matches_reference(runs):
    got, want = runs["port_mesh"]["qwen2_7b"], runs["ref4"]["cases"][
        "qwen2_7b"]
    _close(got["step_loss"], want["step_loss"], "loss")
    assert set(got["new_params"]) == set(want["new_params"])
    for path, p in want["new_params"].items():
        _close(got["new_params"][path], p, path)


# ------------------------------------------------------------------ (f)


def test_ep1_matches_reference_ep_device():
    """At ep=1 the port's EP path is the reference's ``_moe_ep_device``
    (on a one-device Auto mesh), capacity drops included: it is not
    ``_moe_local``."""
    jcfg = _jax_cfg("moonshot_v1_16b_a3b")
    tcfg = configs.get("moonshot_v1_16b_a3b", smoke=True).replace(
        dtype=torch.float32)
    prm = jax.device_get(jax_init_params(
        jax.random.key(7), JM.moe_spec(jcfg), dtype=jnp.float32))
    # tokens near one direction route alike, so the top experts overflow
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((1, 1, jcfg.d_model))
         + 0.3 * rng.standard_normal((2, 24, jcfg.d_model))).astype(
        np.float32)
    jc = _jax_ctx((1, 1))
    want = np.asarray(JM.moe(jcfg, prm, jnp.asarray(x), jc))
    dropped = []
    got = TM._moe_ep_device(tcfg, None, params_from_numpy(prm),
                            torch.from_numpy(x.reshape(-1, jcfg.d_model)),
                            dropped)
    _close(got.reshape(x.shape).numpy(), want, "ep=1")
    assert int(dropped[0]) > 0
    dense = np.asarray(JM._moe_local(jcfg, prm, jnp.asarray(
        x.reshape(-1, jcfg.d_model)))).reshape(x.shape)
    assert np.abs(dense - want).max() > 10 * TOL


def test_moe_without_a_mesh_is_the_dense_path():
    """A context without a mesh runs ``_moe_local``, as in the
    reference."""
    from types import SimpleNamespace
    tcfg = configs.get("moonshot_v1_16b_a3b", smoke=True).replace(
        dtype=torch.float32)
    jcfg = _jax_cfg("moonshot_v1_16b_a3b")
    prm = jax.device_get(jax_init_params(
        jax.random.key(7), JM.moe_spec(jcfg), dtype=jnp.float32))
    x = torch.randn((1, 2, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    out = TM.moe(tcfg, params_from_numpy(prm), x,
                 mesh_ctx=SimpleNamespace(mesh=None))
    assert out.shape == x.shape
    torch.testing.assert_close(out, TM.moe(tcfg, params_from_numpy(prm), x),
                               rtol=0, atol=0)


# ------------------------------------------------------------------ (g)


@pytest.mark.parametrize("mask", ["causal", "window", "prefix"])
@pytest.mark.parametrize("heads", [(4, 2), (4, 1)], ids=["gqa", "mqa"])
@pytest.mark.parametrize("offset", [0, 24, 40])
def test_flash_plain_q_offset_equals_the_rows_of_the_whole(mask, heads,
                                                           offset):
    H, KV = heads
    S, n, D = 64, 24, 16
    g = torch.Generator().manual_seed(11)
    q = torch.randn((2, S, H, D), generator=g)
    k = torch.randn((2, S, KV, D), generator=g)
    v = torch.randn((2, S, KV, D), generator=g)
    kw = {"causal": dict(), "window": dict(window=9),
          "prefix": dict(prefix_len=20)}[mask]
    whole, lse = flash_attention_plain(q, k, v, softcap=30.0, block_q=16,
                                       block_k=16, **kw)
    part, part_lse = flash_attention_plain(
        q[:, offset:offset + n].contiguous(), k, v, softcap=30.0,
        q_offset=offset, block_q=16, block_k=16, **kw)
    torch.testing.assert_close(part, whole[:, offset:offset + n],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(part_lse, lse[:, :, offset:offset + n],
                               rtol=0, atol=1e-5)


def test_flash_plain_q_offset_refuses_rows_past_the_keys():
    q = torch.zeros((1, 8, 2, 8))
    k = torch.zeros((1, 12, 2, 8))
    with pytest.raises(ValueError, match="run past"):
        flash_attention_plain(q, k, k, q_offset=6)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention_plain(q, k, k)


# --------------------------------------------------- the reference's side


def _flat(tree, path=()):
    return torch_mesh_ranks._flat(tree, path)


def _ref4_cells(jobdir, arch):
    """(c) for ``arch``'s cells on four forced devices, a (2, 2) Auto
    mesh."""
    from repro.launch.hlo_analysis import memory_summary
    from repro.launch.specs import build_cell
    from repro.train import OptConfig, TrainConfig

    mc = _jax_ctx()
    cells = {}
    for arch, shape in [c for c in torch_mesh_ranks.BYTES_CELLS
                        if c[0] == arch]:
        tc = TrainConfig(opt=OptConfig(moments_dtype="float32"),
                         microbatches=1)
        fn, args, out_sh = build_cell(arch, shape, mc, train_cfg=tc,
                                      cfg_override=jax_configs.get(
                                          arch, smoke=True))
        kind = jax_configs.SHAPES[shape].kind
        donate = (0,) if kind == "train" else (1,) if kind == "decode" \
            else ()
        with mc.mesh:
            lowered = jax.jit(fn, out_shardings=out_sh,
                              donate_argnums=donate).lower(*args)
            compiled = lowered.compile()
        cells[(arch, shape)] = {
            **memory_summary(compiled),
            "n_outputs": len(jax.tree.leaves(lowered.out_info))}
    Path(jobdir, f"ref4_cells_{arch}.pkl").write_bytes(pickle.dumps(cells))


def _ref4_cases(jobdir, arch):
    """(d), (e) for ``arch``'s case on four forced devices, a (2, 2) Auto
    mesh."""
    from repro.models import loss_fn
    from repro.train import OptConfig, TrainConfig, adamw_init
    from repro.train import build_train_step

    job = pickle.loads(Path(jobdir, "job.pkl").read_bytes())
    mc = _jax_ctx()
    for case in [c for c in job["cases"] if c["arch"] == arch]:
        cfg = _jax_cfg(case["arch"])
        spec = jax_model_spec(cfg)
        params = jax.tree.map(jnp.asarray, case["params"])
        batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}

        def f(p):
            return loss_fn(cfg, mc.constrain_tree(p, spec), batch,
                           mesh_ctx=mc)
        loss, grads = jax.jit(jax.value_and_grad(f))(params)
        local_loss, local_grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(cfg, p, batch)))(params)
        res = {"loss": float(loss), "local_loss": float(local_loss),
               "grads": {k: np.asarray(v) for k, v in _flat(
                   jax.device_get(grads)).items()},
               "local_grads": {k: np.asarray(v) for k, v in _flat(
                   jax.device_get(local_grads)).items()}}
        if case["adamw"]:
            oc = OptConfig(**torch_mesh_ranks.ADAMW)
            step = jax.jit(build_train_step(cfg, TrainConfig(opt=oc), mc))
            state, metrics = step({"params": params,
                                   "opt": adamw_init(params, oc)}, batch)
            res["step_loss"] = float(metrics["loss"])
            res["new_params"] = {k: np.asarray(v) for k, v in _flat(
                jax.device_get(state["params"])).items()}
    Path(jobdir, f"ref4_cases_{arch}.pkl").write_bytes(pickle.dumps(res))


def _ref512(jobdir):
    """(b) and the pod-major device order on 512 forced devices."""
    from repro.train import TrainConfig, abstract_train_state
    shapes = {}
    for multi_pod in (False, True):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        mc = _jax_ctx(shape, axes)
        for arch in jax_configs.ARCH_IDS:
            state = abstract_train_state(jax_configs.get(arch),
                                         TrainConfig(), mc)
            shapes[(arch, multi_pod)] = {
                k: tuple(v.sharding.shard_shape(v.shape))
                for k, v in _flat(state).items()}
    mesh = _auto_mesh((2, 2, 2), ("pod", "data", "model"))
    x = jax.device_put(np.arange(32, dtype=np.int32).reshape(8, 4),
                       NamedSharding(mesh, JP(("pod", "data"), "model")))
    order = list(mesh.devices.flat)
    pod_major = [None] * 8
    for shard in x.addressable_shards:
        pod_major[order.index(shard.device)] = np.asarray(shard.data)
    Path(jobdir, "ref512.pkl").write_bytes(pickle.dumps(
        {"shapes": shapes, "pod_major": pod_major}))


if __name__ == "__main__":
    {"ref4_cells": _ref4_cells, "ref4_cases": _ref4_cases,
     "ref512": _ref512}[sys.argv[1]](*sys.argv[2:])
