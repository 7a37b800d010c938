"""The port's decode of R and W layers against the reference's, in f32 on
seeded numpy inputs with the reference's weights carried over by the
bridge: the one-token forms of the RG-LRU block (``rglru_step``,
``rglru_block(state=)``) and of RWKV6's mixers (``rwkv_time_mix(state=)``,
``rwkv_channel_mix(state=)``), state leaves included; then ``decode_step``
on the recurrentgemma_9b and rwkv6_3b smoke configs for 12 steps with the
state carried (logits within 2e-4, greedy tokens identical); the ports of
the reference's ``test_decode_steps`` and ``test_decode_matches_forward``
(``tests/test_archs.py``); the cache's leaf dtypes (``S`` and ``h`` fp32 in
a bf16 cache); and the refusals both packages share: no chunk (S > 1) and
no paged plane for these patterns, and no serve engine."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models import api as JA  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.serve import LegacyServeEngine as JaxLegacy  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (cache_leaf_dtype, decode_cache_shapes,  # noqa: E402
                                decode_step, forward, init_cache,
                                init_decode_cache, params_from_numpy,
                                tree_paths)
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.serve import LegacyServeEngine, ServeEngine  # noqa: E402

ARCHS = ["recurrentgemma_9b", "rwkv6_3b"]
TOL = 2e-4
STEPS = 12


def _model(arch, dtype=jnp.float32, tdtype=torch.float32):
    jcfg = jax_configs.get(arch, smoke=True).replace(dtype=dtype)
    tcfg = configs.get(arch, smoke=True).replace(dtype=tdtype)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=dtype))
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in ARCHS}


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _unstack(tree):
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    return tree[0]


# ----------------------------------------------------------- layer forms


def test_rglru_step_and_block_state_match_reference(models):
    jcfg, tcfg, np_params, _ = models["recurrentgemma_9b"]
    rec = _unstack(np_params["stack"]["0_R"]["rec"])
    rng = np.random.default_rng(1)
    rec["conv_b"] = rng.standard_normal(rec["conv_b"].shape).astype(
        np.float32)
    W = jcfg.lru_width
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    state = {"conv": rng.standard_normal((2, jcfg.conv_width - 1, W))
             .astype(np.float32),
             "h": rng.standard_normal((2, W)).astype(np.float32)}
    xr = rng.standard_normal((2, 1, W)).astype(np.float32)
    want_y, want_h = JR.rglru_step(rec, jnp.asarray(xr),
                                   jnp.asarray(state["h"]))
    got_y, got_h = TR.rglru_step(params_from_numpy(rec), torch.from_numpy(xr),
                                 torch.from_numpy(state["h"]))
    _close(got_y, want_y, what="rglru_step y")
    _close(got_h, want_h, what="rglru_step h")
    assert got_h.dtype == torch.float32
    want, want_state = JR.rglru_block(
        jcfg, rec, jnp.asarray(x),
        state={k: jnp.asarray(v) for k, v in state.items()})
    got, got_state = TR.rglru_block(
        tcfg, params_from_numpy(rec), torch.from_numpy(x),
        state={k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want, what="rglru_block out")
    for name in ("conv", "h"):
        _close(got_state[name], want_state[name], what=name)
    assert TR.rglru_state_shape(tcfg, 3) == JR.rglru_state_shape(jcfg, 3)


def test_rwkv_mixers_decode_match_reference(models):
    jcfg, tcfg, np_params, _ = models["rwkv6_3b"]
    layer = _unstack(np_params["stack"]["0_W"])
    tm, cm = dict(layer["tm"]), dict(layer["cm"])
    rng = np.random.default_rng(3)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "ln_out"):
        tm[name] = (0.5 * rng.standard_normal(tm[name].shape)).astype(
            np.float32)
    for name in ("mu_k", "mu_r"):
        cm[name] = rng.standard_normal(cm[name].shape).astype(np.float32)
    H, N = JR.rwkv_heads(jcfg)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    state = {"shift": rng.standard_normal((2, jcfg.d_model))
             .astype(np.float32),
             "S": rng.standard_normal((2, H, N, N)).astype(np.float32)}
    want, want_state = JR.rwkv_time_mix(
        jcfg, tm, jnp.asarray(x),
        state={k: jnp.asarray(v) for k, v in state.items()})
    got, got_state = TR.rwkv_time_mix(
        tcfg, params_from_numpy(tm), torch.from_numpy(x),
        state={k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want, what="time-mix out")
    for name in ("shift", "S"):
        _close(got_state[name], want_state[name], what=name)
    assert got_state["S"].dtype == torch.float32
    want, want_shift = JR.rwkv_channel_mix(jcfg, cm, jnp.asarray(x),
                                           state=jnp.asarray(state["shift"]))
    got, got_shift = TR.rwkv_channel_mix(
        tcfg, params_from_numpy(cm), torch.from_numpy(x),
        state=torch.from_numpy(state["shift"]))
    _close(got, want, what="channel-mix out")
    np.testing.assert_array_equal(got_shift.numpy(), np.asarray(want_shift))
    assert TR.rwkv_state_shape(tcfg, 3) == JR.rwkv_state_shape(jcfg, 3)


# ------------------------------------------------------------ decode_step


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(models, arch):
    """12 steps with the state carried: 4 prompt tokens, then each
    package's own greedy token fed back (identical in both). Scalar
    positions (bulk decode), B=2. recurrentgemma's L layers run with a
    window of 8 (the smoke config's is 16), so their rolling cache wraps
    at step 8."""
    jcfg, tcfg, np_params, tparams = models[arch]
    if jcfg.window:
        jcfg, tcfg = jcfg.replace(window=8), tcfg.replace(window=8)
    B, max_seq = 2, 16
    assert (decode_cache_shapes(tcfg, B, max_seq)
            == JA.decode_cache_shapes(jcfg, B, max_seq))
    jcache = jax_init_decode_cache(jcfg, B, max_seq)
    tcache = init_decode_cache(tcfg, B, max_seq, device="cpu")
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab, (B, 4))
    jtok = ttok = prompt[:, :1].astype(np.int32)
    for pos in range(STEPS):
        jlogits, jcache = jax_decode_step(jcfg, np_params, jcache,
                                          jnp.asarray(jtok), pos)
        tlogits, out = decode_step(tcfg, tparams, tcache,
                                   torch.from_numpy(ttok), pos)
        assert out is tcache                     # written in place
        assert tlogits.shape == (B, 1, jcfg.vocab)
        _close(tlogits.numpy(), jlogits, what=f"logits at step {pos}")
        if pos + 1 < prompt.shape[1]:
            jtok = ttok = prompt[:, pos + 1:pos + 2].astype(np.int32)
        else:
            jtok = np.asarray(jnp.argmax(jlogits[:, -1], -1),
                              np.int32)[:, None]
            ttok = tlogits[:, -1].argmax(-1).int().numpy()[:, None]
            np.testing.assert_array_equal(ttok, jtok)
    jleaves = dict(tree_paths(jax.device_get(jcache)))
    for path, t in tree_paths(tcache):
        _close(t.numpy(), jleaves[path], what=str(path))


def _bf16_model(arch):
    """The reference's bf16 smoke weights and config, as the reference's
    ``tests/test_archs.py`` sets them up, carried into the port."""
    jcfg = jax_configs.get(arch, smoke=True)
    tcfg = configs.get(arch, smoke=True)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jcfg.dtype))
    return tcfg, params_from_numpy(np_params)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch):
    """The port of ``tests/test_archs.py::test_decode_steps``."""
    cfg, params = _bf16_model(arch)
    B, S = 2, 16
    cache = init_decode_cache(cfg, B, S, device="cpu")
    toks = torch.ones((B, 1), dtype=torch.int32)
    with torch.no_grad():
        for pos in range(3):
            logits, cache = decode_step(cfg, params, cache, toks, pos)
            assert logits.shape == (B, 1, cfg.vocab)
            assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port of ``tests/test_archs.py::test_decode_matches_forward``:
    incremental decode agrees with the teacher-forced forward on the same
    tokens, bf16 weights, within the reference's 0.15."""
    cfg, params = _bf16_model(arch)
    B, S = 1, 12
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.key(1), (B, S), 0, cfg.vocab), np.int32))
    with torch.no_grad():
        logits_full = forward(cfg, params, {"tokens": toks}).float()
        cache = init_decode_cache(cfg, B, S, device="cpu")
        outs = []
        for pos in range(S):
            lg, cache = decode_step(cfg, params, cache,
                                    toks[:, pos:pos + 1], pos)
            outs.append(lg[:, 0].float())
    logits_inc = torch.stack(outs, dim=1)
    assert (logits_full - logits_inc).abs().max().item() < 0.15, arch


# ---------------------------------------------------------------- dtypes


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_leaf_dtypes_match_reference(arch):
    """bf16 configs: ``init_decode_cache`` keeps ``S`` and ``h`` in fp32
    and the rest in bf16 in both packages; ``init_cache`` keeps every
    leaf in the model dtype in both."""
    jcfg = jax_configs.get(arch, smoke=True)
    tcfg = configs.get(arch, smoke=True)
    name = {jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for leaf in ("S", "h", "k", "v", "conv", "tm_shift", "cm_shift"):
        assert name[jnp.dtype(JA.cache_leaf_dtype(jcfg, leaf))] == \
            cache_leaf_dtype(tcfg, leaf), leaf
    jleaves = dict(tree_paths(jax_init_decode_cache(jcfg, 2, 8)))
    tleaves = dict(tree_paths(init_decode_cache(tcfg, 2, 8, device="cpu")))
    assert jleaves.keys() == tleaves.keys()
    recurrent = 0
    for path, t in tleaves.items():
        assert name[jnp.dtype(jleaves[path].dtype)] == t.dtype, path
        assert tuple(t.shape) == jleaves[path].shape, path
        if path[-1] in ("S", "h"):
            assert t.dtype == torch.float32
            recurrent += 1
        else:
            assert t.dtype == torch.bfloat16
    assert recurrent > 0
    jflat = dict(tree_paths(JL.init_cache(jcfg, 2, 8)))
    for path, t in tree_paths(init_cache(tcfg, 2, 8, device="cpu")):
        assert t.dtype == torch.bfloat16
        assert name[jnp.dtype(jflat[path].dtype)] == t.dtype, path


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("arch", ARCHS)
def test_chunks_and_paged_raise_in_both_packages(models, arch):
    jcfg, tcfg, np_params, tparams = models[arch]
    B = 2
    jcache = jax_init_decode_cache(jcfg, B, 8)
    tcache = init_decode_cache(tcfg, B, 8, device="cpu")
    toks = np.zeros((B, 4), np.int32)
    pos = np.zeros((B,), np.int32)
    lens = np.ones((B,), np.int32)
    tables = np.zeros((B, 2), np.int32)
    with pytest.raises(NotImplementedError, match="absolute-position"):
        jax_decode_step(jcfg, np_params, jcache, jnp.asarray(toks),
                        jnp.asarray(pos))
    with pytest.raises(NotImplementedError, match="absolute-position"):
        decode_step(tcfg, tparams, tcache, torch.from_numpy(toks),
                    torch.from_numpy(pos))
    with pytest.raises(NotImplementedError, match="absolute-position"):
        jax_decode_step(jcfg, np_params, jcache, jnp.asarray(toks[:, :1]),
                        jnp.asarray(pos), seq_lens=jnp.asarray(lens),
                        paged_tables=jnp.asarray(tables))
    with pytest.raises(NotImplementedError, match="absolute-position"):
        decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, :1]),
                    torch.from_numpy(pos), seq_lens=torch.from_numpy(lens),
                    paged_tables=torch.from_numpy(tables))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engines_refuse_recurrent_patterns(models, arch):
    """Every cache leaf of a served pattern must be K or V: both packages'
    engines, the legacy baseline too, refuse the R and W state with an
    ``AssertionError``."""
    jcfg, tcfg, np_params, tparams = models[arch]
    for make in (lambda: JaxEngine(jcfg, np_params, max_slots=1,
                                   max_seq=16),
                 lambda: JaxLegacy(jcfg, np_params, max_slots=1,
                                   max_seq=16),
                 lambda: ServeEngine(tcfg, tparams, max_slots=1, max_seq=16,
                                     device="cpu"),
                 lambda: LegacyServeEngine(tcfg, tparams, max_slots=1,
                                           max_seq=16, device="cpu")):
        with pytest.raises(AssertionError, match="uniform-KV"):
            make()
