"""The port's dense layers against ``repro.models.layers`` on the qwen2-7b
smoke config in f32, with the reference's own weights carried over by the
weight bridge; and the bridge itself, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (init_params, model_spec,  # noqa: E402
                                params_from_numpy, tree_paths)
from repro_torch.models import layers as TL  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def model():
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    jp = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                         dtype=jnp.float32)
    # the bias leaves init to zeros: give them values so the test sees them
    rng = np.random.default_rng(1)
    attn = dict(jp["stack"]["0_G"]["attn"])
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(size=attn[name].shape),
                                 jnp.float32)
    jp["stack"]["0_G"]["attn"] = attn
    ln = {"scale": jnp.asarray(rng.normal(size=(jcfg.d_model,)) * 0.1,
                               jnp.float32)}
    jp["ln_f"] = ln
    np_params = jax.device_get(jp)
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


def _layer(tree, li=0):
    return {k: (_layer(v, li) if isinstance(v, dict) else v[li])
            for k, v in tree.items()}


def _x(cfg, seed, S=5):
    return np.random.default_rng(seed).normal(
        size=(2, S, cfg.d_model)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=ATOL, rtol=ATOL)


def test_rmsnorm(model):
    jcfg, tcfg, npp, tp = model
    x = _x(jcfg, 0)
    _close(TL.rmsnorm(tp["ln_f"], torch.from_numpy(x)),
           JL.rmsnorm(npp["ln_f"], jnp.asarray(x)))
    _close(TL.norm(tcfg, tp["ln_f"], torch.from_numpy(x)),
           JL.norm(jcfg, npp["ln_f"], jnp.asarray(x)))


def test_rope(model):
    jcfg, tcfg, _, _ = model
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, jcfg.n_heads, jcfg.d_head)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [40, 41, 42, 43, 44, 45]], np.int32)
    for theta in (jcfg.rope_theta, 1_000_000.0):
        _close(TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_qkv_with_bias(model):
    jcfg, tcfg, npp, tp = model
    x = _x(jcfg, 3)
    jattn, tattn = _layer(npp["stack"]["0_G"])["attn"], \
        _layer(tp["stack"]["0_G"])["attn"]
    for t, j in zip(TL._qkv(tcfg, tattn, torch.from_numpy(x),
                            torch.from_numpy(x)),
                    JL._qkv(jcfg, jattn, jnp.asarray(x), jnp.asarray(x))):
        _close(t, j)


def test_mlp(model):
    jcfg, tcfg, npp, tp = model
    x = _x(jcfg, 4)
    _close(TL.mlp(tcfg, _layer(tp["stack"]["0_G"], 1)["mlp"],
                  torch.from_numpy(x)),
           JL.mlp(jcfg, _layer(npp["stack"]["0_G"], 1)["mlp"],
                  jnp.asarray(x)))


def test_embed_unembed(model):
    jcfg, tcfg, npp, tp = model
    tok = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 7))
    tok = tok.astype(np.int32)
    _close(TL.embed(tcfg, tp["embed"], torch.from_numpy(tok)),
           JL.embed(jcfg, npp["embed"], jnp.asarray(tok)))
    h = _x(jcfg, 6, S=3)
    _close(TL.unembed(tcfg, tp["embed"], torch.from_numpy(h)),
           JL.unembed(jcfg, npp["embed"], jnp.asarray(h)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_is_bit_exact(dtype):
    jcfg = jax_configs.get("qwen2_7b", smoke=True)
    jd = getattr(jnp, dtype)
    jp = jax.device_get(jax_init_params(jax.random.key(3),
                                        jax_model_spec(jcfg), dtype=jd))
    tp = params_from_numpy(jp)
    ref, port = dict(tree_paths(jp)), dict(tree_paths(tp))
    assert ref.keys() == port.keys()
    for path, a in ref.items():
        t = port[path]
        assert t.dtype == getattr(torch, dtype), path
        assert tuple(t.shape) == a.shape, path
        bits = np.uint16 if dtype == "bfloat16" else np.uint32
        np.testing.assert_array_equal(
            t.view(torch.int16 if dtype == "bfloat16" else torch.int32)
            .numpy().view(bits), np.asarray(a).view(bits), err_msg=str(path))


def test_init_params_follows_spec():
    """The port's own seeded init: spec shapes and dtypes, zeros/ones where
    the spec says so, scaled-normal spread near 1/sqrt(fan_in), and one
    seed gives one tree."""
    cfg = configs.get("qwen2_7b", smoke=True)
    spec = model_spec(cfg)
    a = init_params(spec, torch.Generator().manual_seed(0), "cpu",
                    dtype=torch.float32)
    b = init_params(spec, torch.Generator().manual_seed(0), "cpu",
                    dtype=torch.float32)
    for (path, s), (_, t), (_, u) in zip(tree_paths(spec), tree_paths(a),
                                         tree_paths(b)):
        assert tuple(t.shape) == s.shape and t.dtype == torch.float32, path
        assert torch.equal(t, u), path
        if s.init == "zeros":
            assert not t.any(), path
    wo = a["stack"]["0_G"]["mlp"]["wo"]            # (layers, d_ff, d)
    assert abs(wo.std().item() * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    tok = a["embed"]["tok"]
    assert abs(tok.std().item() / 0.02 - 1.0) < 0.05


# configuration branches the qwen2 smoke config does not take
VARIANTS = {
    "tied_scaled_softcapped": dict(tie_embeddings=True, embed_scale=True,
                                   final_logit_softcap=30.0),
    "geglu_layernorm": dict(act="geglu", norm="layernorm"),
    "gelu": dict(act="gelu"),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_config_variants(name):
    kw = VARIANTS[name]
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(
        dtype=jnp.float32, **kw)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(
        dtype=torch.float32, **kw)
    npp = jax.device_get(jax_init_params(jax.random.key(1),
                                         jax_model_spec(jcfg),
                                         dtype=jnp.float32))
    rng = np.random.default_rng(7)
    # norms init to constants: give them values so the test sees them
    npp["ln_f"] = {k: rng.normal(size=v.shape).astype(np.float32)
                   for k, v in npp["ln_f"].items()}
    tp = params_from_numpy(npp)
    x = _x(jcfg, 8)
    tok = rng.integers(0, jcfg.vocab, (2, 5)).astype(np.int32)
    _close(TL.norm(tcfg, tp["ln_f"], torch.from_numpy(x)),
           JL.norm(jcfg, npp["ln_f"], jnp.asarray(x)))
    _close(TL.mlp(tcfg, _layer(tp["stack"]["0_G"])["mlp"],
                  torch.from_numpy(x)),
           JL.mlp(jcfg, _layer(npp["stack"]["0_G"])["mlp"], jnp.asarray(x)))
    _close(TL.embed(tcfg, tp["embed"], torch.from_numpy(tok)),
           JL.embed(jcfg, npp["embed"], jnp.asarray(tok)))
    _close(TL.unembed(tcfg, tp["embed"], torch.from_numpy(x)),
           JL.unembed(jcfg, npp["embed"], jnp.asarray(x)))


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_sdpa_matches_reference(model, softcap):
    """The gather plane's chunk attention: GQA, a per-row mask, the
    probabilities cast to v's dtype before PV."""
    jcfg, tcfg, _, _ = model
    jcfg = jcfg.replace(attn_logit_softcap=softcap)
    tcfg = tcfg.replace(attn_logit_softcap=softcap)
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 3, jcfg.n_heads, jcfg.d_head)).astype(np.float32)
    k = rng.normal(size=(2, 10, jcfg.kv_heads, jcfg.d_head)).astype(
        np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    mask = np.arange(10)[None, None, None, :] < np.array(
        [[4, 5, 6], [9, 10, 11]])[:, None, :, None]
    _close(TL._sdpa(tcfg, *(torch.from_numpy(a) for a in (q, k, v, mask))),
           JL._sdpa(jcfg, *(jnp.asarray(a) for a in (q, k, v, mask))))


@pytest.mark.parametrize("window", [None, 3])
def test_causal_mask_matches_reference(window):
    for offset in (0, 5):
        np.testing.assert_array_equal(
            TL.causal_mask(4, 12, offset, window).numpy(),
            np.asarray(JL.causal_mask(4, 12, offset, window)))
