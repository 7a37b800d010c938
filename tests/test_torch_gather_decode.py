"""The port's gather-plane decode step (per-slot contiguous caches, written in
place) against the reference's ``decode_step`` without block tables, in
f32 with the reference's weights carried over by the bridge and one seeded
cache handed to both:

* gemma2 smoke (LG, window 8, softcaps) across the window's wrap: rows at
  positions 3, 8 and 13, so the L layers write slots 3, 0 and 5 and attend
  4, 8 and 8 slots;
* qwen2 smoke at S=1 and S=8 (chunked prefill through ``_sdpa``), with a
  row whose padded chunk, or whose position, runs past ``max_seq``: the
  reference drops those writes;
* one scalar position shared by every row (bulk decode), where the
  reference clamps the write's start into the cache.

Logits of every row agree within 2e-4 (the reference's parity bar: f32,
different summation orders). The first layer's new cache entries agree
within 1e-5: their inputs are the same embeddings on both sides. Deeper
layers' entries carry the f32 drift of the layers below and are held to
2e-4 of the leaf's scale. Every cache entry the reference leaves unchanged
is unchanged here.
Both attention routes of the port run: ``decode_kernel="auto"`` (the
flash-decoding wrapper, which on CPU tensors runs its plain version) and
``"xla"`` (``_sdpa``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (cache_shapes, init_decode_cache,  # noqa: E402
                                lm_decode_step, params_from_numpy,
                                tree_paths)
from repro_torch.models.common import tree_map  # noqa: E402

TOL = 2e-4
MAX_SEQ = 24
_REF = {}


def _model(arch):
    jcfg = jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


@pytest.fixture(scope="module")
def models():
    return {arch: _model(arch) for arch in ("gemma2_27b", "qwen2_7b")}


# name -> (arch, S, per-slot positions or one int, real lengths or None)
CASES = {
    "gemma2_wrap": ("gemma2_27b", 1, [3, 8, 13], [1, 1, 1]),
    "qwen2_s1": ("qwen2_7b", 1, [5, 0, MAX_SEQ + 6, 13], [1, 1, 1, 1]),
    "qwen2_s8": ("qwen2_7b", 8, [5, 0, MAX_SEQ - 4, 13], [8, 5, 2, 1]),
    "gemma2_bulk": ("gemma2_27b", 1, 13, None),
    "qwen2_bulk_clamped": ("qwen2_7b", 1, MAX_SEQ + 2, None),
}


def _inputs(cfg, name):
    _, S, pos, lens = CASES[name]
    B = len(pos) if isinstance(pos, list) else 2
    rng = np.random.default_rng(sorted(CASES).index(name))
    cache = tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                     cache_shapes(cfg, B, MAX_SEQ))
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if isinstance(pos, list):
        pos = np.asarray(pos, np.int32)
    lens = None if lens is None else np.asarray(lens, np.int32)
    return cache, tokens, pos, lens


def _reference(models, name):
    if name not in _REF:
        arch = CASES[name][0]
        jcfg, tcfg, np_params, _ = models[arch]
        cache, tokens, pos, lens = _inputs(tcfg, name)
        logits, new = decode_step(
            jcfg, np_params, tree_map(jnp.asarray, cache),
            jnp.asarray(tokens), jnp.asarray(pos) if
            isinstance(pos, np.ndarray) else pos,
            seq_lens=None if lens is None else jnp.asarray(lens))
        _REF[name] = (np.asarray(logits),
                      tree_map(np.asarray, jax.device_get(new)))
    return _REF[name]


@pytest.mark.parametrize("decode_kernel", ["auto", "xla"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_decode_step_matches_reference(models, name, decode_kernel):
    arch = CASES[name][0]
    _, tcfg, _, tparams = models[arch]
    tcfg = tcfg.replace(decode_kernel=decode_kernel)
    cache, tokens, pos, lens = _inputs(tcfg, name)
    ref_logits, ref_cache = _reference(models, name)
    tcache = tree_map(lambda a: torch.from_numpy(a.copy()), cache)
    logits, new = lm_decode_step(
        tcfg, tparams, tcache, torch.from_numpy(tokens),
        torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos,
        seq_lens=None if lens is None else torch.from_numpy(lens))
    assert new is tcache                        # written in place
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=TOL,
                               rtol=TOL)
    orig, ref = dict(tree_paths(cache)), dict(tree_paths(ref_cache))
    first = min(new["stack"])                   # the unit's first sublayer
    changed_any = False
    for path, got in tree_paths(new):
        got = got.numpy()
        if path[1] == first:
            np.testing.assert_allclose(got[0], ref[path][0], atol=1e-5,
                                       rtol=1e-5, err_msg=str(path))
        np.testing.assert_allclose(got, ref[path],
                                   atol=TOL * np.abs(ref[path]).max(),
                                   err_msg=str(path))
        same = ref[path] == orig[path]
        np.testing.assert_array_equal(got[same], orig[path][same],
                                      err_msg=str(path))
        changed_any |= bool((~same).any())
    assert changed_any


def test_init_decode_cache_layout():
    """Zeros in the model dtype on the device asked for; the L leaves are
    a rolling window, min(window, max_seq) slots wide."""
    cfg = configs.get("gemma2_27b", smoke=True)
    cache = init_decode_cache(cfg, 3, 64, device="cpu")
    shapes = dict(tree_paths(cache_shapes(cfg, 3, 64)))
    for path, t in tree_paths(cache):
        assert tuple(t.shape) == shapes[path] and t.dtype == cfg.dtype
        assert t.device.type == "cpu" and not t.any()
    assert cache["stack"]["0_L"]["k"].shape == (2, 3, 8, 2, 16)
    assert cache["stack"]["1_G"]["k"].shape == (2, 3, 64, 2, 16)


def test_rolling_layers_refuse_chunks_and_tables(models):
    """As in the reference: chunked prefill and the paged plane need
    absolute-position caches."""
    _, tcfg, _, tparams = models["gemma2_27b"]
    cache = init_decode_cache(tcfg, 2, 16, device="cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="absolute-position"):
        lm_decode_step(tcfg, tparams, cache, tokens, pos)
    with pytest.raises(NotImplementedError, match="absolute-position"):
        lm_decode_step(tcfg, tparams, cache, tokens[:, :1], pos,
                       seq_lens=torch.ones(2, dtype=torch.int32),
                       paged_tables=torch.zeros((2, 2), dtype=torch.int32))
