"""The port's encoder-decoder family (``models.encdec``) against the
reference's (``repro.models.encdec``) on the whisper-base smoke config in
f32, with the reference's weights carried over by the bridge and the
same seeded frames and tokens.

* ``encode`` within 2e-4; ``forward`` logits within 2e-4 with the same
  argmax and ``loss_fn`` within 1e-5 relative (f32 on both sides, summed
  in different orders); one ``build_train_step`` step (loss, gradient
  norm and parameters, as tests/test_torch_train.py holds them);
* ``encdec_prefill_cache``'s leaves, and 12 greedy ``decode_step``s from
  it (logits within 2e-4, the same tokens) through both of the port's
  cross-attention decode routes — the port of tests/test_archs.py:60-75
  for the encdec branch;
* the reference's refusals: ``decode_step`` on a chunk, per-row lengths
  or a block table (``NotImplementedError``), the ``ServeEngine`` on
  whisper (``AssertionError``, its cache has ``ck``/``cv`` leaves);
* the spec tree, the bridge (every leaf bit for bit) and
  ``batch_shapes``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro import train as JT  # noqa: E402
from repro.models import batch_shapes as jax_batch_shapes  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.sharding import local_context  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (batch_shapes, decode_step,  # noqa: E402
                                encdec_prefill_cache, encode, forward,
                                init_decode_cache, loss_fn, model_spec,
                                params_from_numpy, tree_paths)
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               adamw_init, build_train_step)

ARCH = "whisper_base"
TOL = 2e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jax_configs.get(ARCH, smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get(ARCH, smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


def _batch(cfg, S, seed, B=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": rng.standard_normal(
                (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_encode_matches_reference(model):
    jcfg, tcfg, np_params, tparams = model
    frames = _batch(jcfg, 4, seed=1)["frames"]
    want = np.asarray(JED.encode(jcfg, np_params, jnp.asarray(frames)))
    with torch.no_grad():
        got = encode(tcfg, tparams, torch.from_numpy(frames)).numpy()
    assert got.shape == frames.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S", [8, 32])
def test_forward_and_loss_match_reference(model, S):
    jcfg, tcfg, np_params, tparams = model
    batch = _batch(jcfg, S, seed=S)
    want = np.asarray(jax_forward(jcfg, np_params, _jax(batch)))
    want_loss = float(jax_loss_fn(jcfg, np_params, _jax(batch)))
    with torch.no_grad():
        got = forward(tcfg, tparams, _torch(batch)).numpy()
        got_loss = float(loss_fn(tcfg, tparams, _torch(batch)))
    assert got.shape == want.shape == (2, S, jcfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert got_loss == pytest.approx(want_loss, rel=1e-5)


def test_chunked_attention_matches_reference(model):
    """``attn_impl="chunked"`` with chunks of 5: the bidirectional encoder
    and the causal decoder through both packages' ``chunked_attention``
    on ragged chunks (12 frames, 13 tokens)."""
    jcfg, tcfg, np_params, tparams = model
    kw = dict(attn_impl="chunked", attn_q_chunk=5, attn_kv_chunk=5)
    batch = _batch(jcfg, 13, seed=4)
    want = np.asarray(jax_forward(jcfg.replace(**kw), np_params,
                                  _jax(batch)))
    with torch.no_grad():
        got = forward(tcfg.replace(**kw), tparams, _torch(batch)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_train_step_matches_reference(model):
    """One ``build_train_step`` step in both packages from the same
    weights and batch (frames, tokens, targets): the loss within 1e-4
    relative, the gradient norm within 1e-3, the parameters within 1e-4,
    under tests/test_torch_train.py's optimizer settings (eps 1e-3)."""
    jcfg, tcfg, np_params, _ = model
    oc = dict(lr=3e-4, warmup_steps=1, total_steps=3, eps=1e-3)
    batch = _batch(jcfg, 16, seed=9)
    jstep = jax.jit(JT.build_train_step(
        jcfg, JT.TrainConfig(opt=JT.OptConfig(**oc)), local_context()))
    jstate = {"params": jax.tree.map(jnp.asarray, np_params)}
    jstate["opt"] = JT.adamw_init(jstate["params"])
    jstate, jm = jstep(jstate, _jax(batch))
    tparams = params_from_numpy(np_params)
    tstate = {"params": tparams, "opt": adamw_init(tparams)}
    tstate, tm = build_train_step(tcfg, TrainConfig(opt=OptConfig(**oc)))(
        tstate, _torch(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-3)
    want = dict(tree_paths(jax.device_get(jstate["params"])))
    got = dict(tree_paths(tstate["params"]))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]),
                                   atol=1e-4, rtol=0, err_msg=str(path))


def _prefill(jcfg, tcfg, np_params, tparams, B, max_seq, seed):
    frames = np.random.default_rng(seed).standard_normal(
        (B, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
    jenc = JED.encode(jcfg, np_params, jnp.asarray(frames))
    jcache = JED.encdec_prefill_cache(jcfg, np_params, jenc, B, max_seq)
    with torch.no_grad():
        tenc = encode(tcfg, tparams, torch.from_numpy(frames))
        tcache = encdec_prefill_cache(tcfg, tparams, tenc, B, max_seq)
    return jcache, tcache


def test_prefill_cache_matches_reference(model):
    """The same leaves: the zero self-attention k/v exactly, each layer's
    cross k/v of the encoder output within 2e-4 (the encoder's own
    bar)."""
    jcfg, tcfg, np_params, tparams = model
    jcache, tcache = _prefill(jcfg, tcfg, np_params, tparams, 2, 16, seed=2)
    assert tcache.keys() == jcache.keys() == {"k", "v", "ck", "cv"}
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        assert tcache[name].dtype == torch.float32
        assert not tcache[name].any() and not np.asarray(jcache[name]).any()
    for name in ("ck", "cv"):
        assert tcache[name].shape == jcache[name].shape == (
            jcfg.n_layers, 2, jcfg.frontend_len, jcfg.kv_heads, jcfg.d_head)
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL,
                                   rtol=TOL)
    shapes = {k: tuple(v.shape) for k, v in init_decode_cache(
        tcfg, 2, 16, device="cpu").items()}
    assert shapes == {k: v.shape for k, v in jax_init_decode_cache(
        jcfg, 2, 16).items()}


@pytest.mark.parametrize("decode_kernel", ["auto", "xla"])
def test_decode_steps_match_reference(model, decode_kernel):
    """12 greedy ``decode_step``s with a scalar position from the prefill
    cache, each package's greedy token fed back: logits within 2e-4 and
    the same tokens at every step. "auto" takes the cross-attention's
    flash-decoding route (its plain version on the CPU), "xla" ``_sdpa``
    with the all-true mask."""
    jcfg, tcfg, np_params, tparams = model
    tcfg = tcfg.replace(decode_kernel=decode_kernel)
    B, max_seq = 2, 16
    jcache, tcache = _prefill(jcfg, tcfg, np_params, tparams, B, max_seq,
                              seed=3)
    tok = np.ones((B, 1), np.int32)
    for pos in range(12):
        jlogits, jcache = jax_decode_step(jcfg, np_params, jcache,
                                          jnp.asarray(tok), pos)
        with torch.no_grad():
            tlogits, tcache = decode_step(tcfg, tparams, tcache,
                                          torch.from_numpy(tok), pos)
        assert tlogits.shape == (B, 1, jcfg.vocab)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL, err_msg=str(pos))
        tok = tlogits[:, -1].argmax(-1).int().numpy()[:, None]
        np.testing.assert_array_equal(
            tok, np.asarray(jnp.argmax(jlogits[:, -1], -1))[:, None])
    # the self-attention cache, written in place, holds the reference's
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), atol=TOL,
                                   rtol=TOL)


def test_decode_step_refuses_what_the_reference_refuses(model):
    """A chunk (S > 1), per-row lengths and a block table raise
    ``NotImplementedError`` in both packages."""
    jcfg, tcfg, np_params, tparams = model
    jcache, tcache = _prefill(jcfg, tcfg, np_params, tparams, 2, 16, seed=5)
    two = np.ones((2, 2), np.int32)
    one = np.ones((2, 1), np.int32)
    lens = np.ones((2,), np.int32)
    tables = np.zeros((2, 4), np.int32)
    for kw in ({}, {"seq_lens": lens}, {"paged_tables": tables}):
        toks = two if not kw else one
        with pytest.raises(NotImplementedError, match="encdec is S=1"):
            jax_decode_step(jcfg, np_params, jcache, jnp.asarray(toks), 0,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(NotImplementedError, match="encdec is S=1"):
            decode_step(tcfg, tparams, tcache, torch.from_numpy(toks), 0,
                        **{k: torch.from_numpy(v) for k, v in kw.items()})


def test_engine_refuses_whisper(model):
    """The serve engine takes uniform-KV patterns only; whisper's decode
    cache has ``ck``/``cv`` leaves: ``AssertionError`` in both
    packages."""
    jcfg, tcfg, np_params, tparams = model
    with pytest.raises(AssertionError, match="uniform-KV"):
        JaxEngine(jcfg, np_params, max_slots=1, max_seq=16)
    with pytest.raises(AssertionError, match="uniform-KV"):
        ServeEngine(tcfg, tparams, max_slots=1, max_seq=16, device="cpu")


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_reference(smoke):
    """``enc_stack``, ``dec_stack`` (with ``cross_q`` and ``cross_kv``),
    ``pos_dec``, ``ln_enc`` and the rest: the same names, shapes, axes and
    init rules as the reference's tree."""
    ref = dict(tree_paths(jax_model_spec(jax_configs.get(ARCH,
                                                         smoke=smoke))))
    port = dict(tree_paths(model_spec(configs.get(ARCH, smoke=smoke))))
    assert port.keys() == ref.keys()
    for path, s in ref.items():
        q = port[path]
        assert (q.shape, q.axes, q.init, q.scale) == \
            (s.shape, s.axes, s.init, s.scale), path
    if not smoke:
        assert port[("dec_stack", "cross_kv", "wk")].shape == (6, 512, 8, 64)
        assert port[("enc_stack", "mlp", "wi")].shape == (6, 512, 1, 2048)
        assert port[("pos_dec",)].shape == (32_768, 512)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_carries_every_leaf(dtype):
    """``params_from_numpy`` carries each of the encdec tree's leaves over
    bit for bit, in f32 and in bf16."""
    jcfg = jax_configs.get(ARCH, smoke=True).replace(dtype=dtype)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(1), jax_model_spec(jcfg), dtype=dtype))
    want = dict(tree_paths(np_params))
    got = dict(tree_paths(params_from_numpy(np_params)))
    assert got.keys() == want.keys()
    assert {p[0] for p in got} == {"embed", "pos_dec", "enc_stack",
                                   "ln_enc", "dec_stack", "ln_f"}
    for path, t in got.items():
        a = np.asarray(want[path])
        assert t.shape == a.shape, path
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))


@pytest.mark.parametrize("arch", ["whisper_base", "paligemma_3b",
                                  "qwen2_7b"])
def test_batch_shapes_equal_reference(arch):
    for smoke in (True, False):
        ref = jax_batch_shapes(jax_configs.get(arch, smoke=smoke), 4, 32)
        port = batch_shapes(configs.get(arch, smoke=smoke), 4, 32)
        assert port.keys() == ref.keys()
        for name, (shape, dtype) in ref.items():
            assert port[name][0] == shape, (arch, name)
            assert str(port[name][1]).split(".")[-1] == \
                jnp.dtype(dtype).name, (arch, name)
