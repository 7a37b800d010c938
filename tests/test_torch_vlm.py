"""The port's image-prefix family against the reference's on the
paligemma-3b smoke config in f32, with the reference's weights carried
over by the bridge and the same seeded patches and tokens.

* ``forward`` with patches (the logits cover the 8 prefix positions and
  the text) within 2e-4 with the same argmax, ``loss_fn`` (which drops
  the prefix positions) within 1e-5 relative;
* ``attn_impl="chunked"`` with chunks smaller than the prefix (ragged);
* the paged ``ServeEngine`` on paligemma smoke (text-only decode, as the
  reference's) against the reference's engine: tokens, eviction log and
  ``metrics()`` identical; and the launcher's printed lines;
* the spec tree (``frontend_proj``) and the bridge, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.launch.serve import serve_main as jax_serve_main  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import serve_main  # noqa: E402
from repro_torch.models import (forward, loss_fn, model_spec,  # noqa: E402
                                params_from_numpy, tree_paths)
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402

ARCH = "paligemma_3b"
TOL = 2e-4
BT = 8          # block_tokens
PROMPT = 32     # uniform prompt length (4 blocks)
MAX_NEW = 4


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
            "patches": rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)}


def _compare(jcfg, tcfg, np_params, tparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jax_forward(jcfg, np_params, jb))
    want_loss = float(jax_loss_fn(jcfg, np_params, jb))
    with torch.no_grad():
        got = forward(tcfg, tparams, tb).numpy()
        got_loss = float(loss_fn(tcfg, tparams, tb))
    B, S = batch["tokens"].shape
    assert got.shape == want.shape == (B, jcfg.frontend_len + S, jcfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert got_loss == pytest.approx(want_loss, rel=1e-5)


@pytest.mark.parametrize("S", [8, 32])
def test_forward_and_loss_match_reference(model, S):
    _compare(*model, _batch(model[0], S, seed=S))


def test_loss_drops_the_prefix(model):
    """The loss is the text positions' cross entropy: equal to ``lm_loss``
    over the logits' last S positions."""
    from repro_torch.models import lm_loss
    _, tcfg, _, tparams = model
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 12, 7).items()}
    with torch.no_grad():
        logits = forward(tcfg, tparams, tb)
        want = lm_loss(tcfg, logits[:, -12:], tb["targets"])
        assert float(loss_fn(tcfg, tparams, tb)) == float(want)


def test_chunked_attention_with_prefix_matches_reference(model):
    """Chunks of 5 over 8 prefix and 13 text positions: the prefix spans
    two chunks and ends inside a third, and the last chunk is ragged."""
    jcfg, tcfg, np_params, tparams = model
    kw = dict(attn_impl="chunked", attn_q_chunk=5, attn_kv_chunk=5)
    _compare(jcfg.replace(**kw), tcfg.replace(**kw), np_params, tparams,
             _batch(jcfg, 13, seed=5))


# ---------------------------------------------------------------- engine


def _workload(vocab, n_requests=8, n_families=3, seed=7):
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
    rs = [eng.submit(r, max_new=MAX_NEW) for r in _workload(cfg.vocab)]
    eng.run()
    return eng, st, rs


@pytest.mark.parametrize("chunk", [1, 8])
def test_paged_engine_matches_reference(model, chunk):
    jcfg, tcfg, np_params, tparams = model
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


def test_launcher_prints_reference_lines(capsys):
    """``--arch paligemma_3b --smoke`` through both launchers: the same
    metric lines, on the paged plane."""
    args = ["--arch", "paligemma_3b", "--smoke", "--requests", "4",
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


# ------------------------------------------------------ spec and bridge


@pytest.mark.parametrize("smoke", [True, False])
def test_spec_tree_equals_reference(smoke):
    ref = dict(tree_paths(jax_model_spec(jax_configs.get(ARCH,
                                                         smoke=smoke))))
    port = dict(tree_paths(model_spec(configs.get(ARCH, smoke=smoke))))
    assert port.keys() == ref.keys()
    for path, s in ref.items():
        q = port[path]
        assert (q.shape, q.axes, q.init, q.scale) == \
            (s.shape, s.axes, s.init, s.scale), path
    if not smoke:
        assert port[("frontend_proj",)].shape == (1152, 2048)
        assert port[("stack", "0_G", "attn", "wk")].shape == (18, 2048, 1,
                                                             256)


def test_bridge_carries_frontend_proj():
    jcfg = jax_configs.get(ARCH, smoke=True)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(1), jax_model_spec(jcfg), dtype=jnp.bfloat16))
    got = dict(tree_paths(params_from_numpy(np_params)))
    want = dict(tree_paths(np_params))
    assert got.keys() == want.keys() and ("frontend_proj",) in got
    for path, t in got.items():
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(want[path]).view(np.int16),
                                      err_msg=str(path))
