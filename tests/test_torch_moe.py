"""The port's MoE layer and M layers against the reference's, in f32 with
the reference's weights carried over by the bridge: the router's top-k
(ids identical, weights within 1e-6, ties broken to the lower expert
index as ``jax.lax.top_k`` breaks them), the layer against ``_moe_local``,
``forward`` and ``decode_step`` on the moonshot_v1_16b_a3b and
llama4_maverick_400b_a17b smoke configs (2e-4), the paged ``ServeEngine``
on moonshot smoke against the reference's engine (tokens, eviction log
and ``metrics()`` identical) and the launcher's printed metrics. The
expert-parallel branch is held to the reference's in
``tests/test_torch_mesh.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.launch.serve import serve_main as jax_serve_main  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_cache, params_from_numpy)
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402

ARCHS = ["moonshot_v1_16b_a3b", "llama4_maverick_400b_a17b"]
TOL = 2e-4
BT = 8          # block_tokens
PROMPT = 32     # uniform prompt length (4 blocks)
MAX_NEW = 4


def _model(arch):
    jcfg = jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in ARCHS}


def _moe_params(np_params):
    """The first M layer's MoE weights."""
    key = next(k for k in np_params["stack"] if k.endswith("_M"))
    return {k: v[0] for k, v in np_params["stack"][key]["moe"].items()}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


# ---------------------------------------------------------------- router


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(models, arch):
    jcfg, tcfg, np_params, _ = models[arch]
    router = _moe_params(np_params)["router"]
    x = np.random.default_rng(0).standard_normal(
        (40, jcfg.d_model)).astype(np.float32)
    jw, ji = JM._route(jcfg, jnp.asarray(router), jnp.asarray(x))
    tw, ti = TM._route(tcfg, torch.from_numpy(router), torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=0)


def test_route_breaks_ties_to_the_lower_expert_index():
    """Router columns equal in pairs give every token tied logits: both
    packages must rank the lower expert index first, for any k. The ties
    sit at the top (experts 5 and 2, 6 and 1) and across the cut of k."""
    E, d = 8, 16
    rng = np.random.default_rng(4)
    router = -np.abs(rng.standard_normal((d, E))).astype(np.float32)
    router[:, 5] = router[:, 2] = 1.0
    router[:, 6] = router[:, 1] = 0.5
    x = np.abs(rng.standard_normal((12, d))).astype(np.float32)
    for k in (1, 2, 3, 4):
        jcfg = jax_configs.get("moonshot_v1_16b_a3b", smoke=True).replace(
            n_experts=E, top_k=k)
        tcfg = configs.get("moonshot_v1_16b_a3b", smoke=True).replace(
            n_experts=E, top_k=k)
        jw, ji = JM._route(jcfg, jnp.asarray(router), jnp.asarray(x))
        tw, ti = TM._route(tcfg, torch.from_numpy(router),
                           torch.from_numpy(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                                   rtol=0)
        assert (ti[:, 0] == 2).all()
        if k >= 2:
            assert (ti[:, 1] == 5).all()
        if k >= 4:
            assert (ti[:, 2] == 1).all() and (ti[:, 3] == 6).all()


# ----------------------------------------------------------------- layer


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(models, arch):
    jcfg, tcfg, np_params, _ = models[arch]
    prm = _moe_params(np_params)
    x = np.random.default_rng(1).standard_normal(
        (2, 7, jcfg.d_model)).astype(np.float32)
    want = JM.moe(jcfg, prm, jnp.asarray(x))
    got = TM.moe(tcfg, params_from_numpy(prm), torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got, want, what="moe")
    _close(TM._moe_local(tcfg, params_from_numpy(prm),
                         torch.from_numpy(x.reshape(-1, jcfg.d_model))),
           JM._moe_local(jcfg, prm, jnp.asarray(x.reshape(-1, jcfg.d_model))),
           what="_moe_local")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(models, arch):
    jcfg, tcfg, np_params, tparams = models[arch]
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)
    want = jax_forward(jcfg, np_params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = forward(tcfg, tparams, {"tokens": torch.from_numpy(tokens)})
    _close(got.numpy(), want, what="logits")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(models, arch):
    """The gather plane: one ragged prefill chunk of 6 tokens per slot
    (per-slot positions, real lengths 6 and 4), then 5 one-token steps
    with each package's greedy token fed back (identical in both)."""
    jcfg, tcfg, np_params, tparams = models[arch]
    B, max_seq = 2, 32
    jcache = jax_init_decode_cache(jcfg, B, max_seq)
    tcache = init_decode_cache(tcfg, B, max_seq, device="cpu")
    chunk = np.random.default_rng(3).integers(
        0, jcfg.vocab, (B, 6)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    pos = np.zeros((B,), np.int32)
    jlogits, jcache = jax_decode_step(
        jcfg, np_params, jcache, jnp.asarray(chunk), jnp.asarray(pos),
        seq_lens=jnp.asarray(lens))
    with torch.no_grad():
        tlogits, _ = decode_step(tcfg, tparams, tcache,
                                 torch.from_numpy(chunk),
                                 torch.from_numpy(pos),
                                 seq_lens=torch.from_numpy(lens))
    _close(tlogits.numpy(), jlogits, what="chunk logits")
    pos = lens.copy()
    for step in range(5):
        tok = tlogits[:, -1].argmax(-1).int().numpy()[:, None]
        np.testing.assert_array_equal(
            tok, np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None])
        jlogits, jcache = jax_decode_step(jcfg, np_params, jcache,
                                          jnp.asarray(tok), jnp.asarray(pos))
        with torch.no_grad():
            tlogits, _ = decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(tok),
                                     torch.from_numpy(pos))
        _close(tlogits.numpy(), jlogits, what=f"logits at step {step}")
        pos = pos + 1


# ---------------------------------------------------------------- engine


def workload(vocab, n_requests=8, n_families=3, seed=7):
    """Shared-prefix requests with uniform lengths, plus a duplicate of the
    first (a full-chain hit -> copy-on-write)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, vocab, PROMPT - BT))
                for _ in range(n_families)]
    reqs = [prefixes[i % n_families] + list(rng.integers(0, vocab, BT))
            for i in range(n_requests)]
    return reqs + [list(reqs[0])]


def _run(engine_cls, store_cls, cfg, params, chunk, **kw):
    probe = engine_cls(cfg, params, max_slots=2, max_seq=64,
                       store=store_cls(1 << 30, "lerc", block_tokens=BT),
                       pool_blocks=1, prefill_chunk=chunk, paged=True, **kw)
    st = store_cls(probe._block_nbytes() * 10, "lerc", block_tokens=BT)
    eng = engine_cls(cfg, params, max_slots=2, max_seq=64, store=st,
                     prefill_chunk=chunk, paged=True, **kw)
    rs = [eng.submit(r, max_new=MAX_NEW) for r in workload(cfg.vocab)]
    eng.run()
    return eng, st, rs


@pytest.mark.parametrize("chunk", [1, 8])
def test_paged_engine_matches_reference_on_moe(models, chunk):
    jcfg, tcfg, np_params, tparams = models["moonshot_v1_16b_a3b"]
    jeng, jst, jrs = _run(JaxEngine, JaxStore, jcfg, np_params, chunk)
    teng, tst, trs = _run(ServeEngine, PrefixStore, tcfg, tparams, chunk,
                          device="cpu")
    assert jst.evictions > 0, "workload produced no pressure"
    assert jeng.paged and teng.paged
    assert [r.generated for r in trs] == [r.generated for r in jrs]
    assert tst.eviction_log == jst.eviction_log
    assert [r.prefill_skipped for r in trs] == \
        [r.prefill_skipped for r in jrs]
    assert teng.steps == jeng.steps
    assert teng.metrics() == jeng.metrics()


def test_launcher_prints_reference_metrics_on_moe(capsys):
    """``--arch moonshot_v1_16b_a3b --smoke`` through both launchers: the
    same metric lines, on the paged plane."""
    args = ["--arch", "moonshot_v1_16b_a3b", "--smoke", "--requests", "4",
            "--slots", "2", "--max-seq", "32", "--shared-prefix", "16",
            "--max-new", "2", "--cache-kb", "8", "--block-tokens", "4"]
    out = []
    for main, extra in ((jax_serve_main, []),
                        (serve_main, ["--device", "cpu"])):
        assert main(args + extra) == 0
        lines = capsys.readouterr().out.splitlines()
        out.append(([ln for ln in lines if ln.startswith("  ")],
                    [ln for ln in lines if ln.startswith("policy=")]))
    (ref, ref_head), (got, head) = out
    assert got and got == ref
    assert "paged=on" in head[0] and "paged=on" in ref_head[0]
