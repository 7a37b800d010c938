"""The port's training forward (``lm_forward``) and loss against the
reference's on the qwen2-7b, codeqwen1.5-7b (MHA), qwen1.5-110b, gemma2-27b,
recurrentgemma-9b and rwkv6-3b smoke configs in f32, with the reference's weights carried over by the bridge
and the same seeded tokens.

Logits within 2e-4 with the same argmax everywhere, the loss within 1e-5
relative: f32 on both sides, summed in different orders. The CPU route of
``attn_impl="auto"`` is the reference's (``_sdpa`` at these lengths);
``attn_impl="chunked"`` with small chunks holds the port's
``chunked_attention`` to the reference's. S=8 fits inside every window,
S=32 is wider than gemma2's (8) and recurrentgemma's (16); S=8 is a
ragged half of rwkv6's WKV chunk (16), S=32 two whole chunks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                init_decode_cache, lm_forward, loss_fn,
                                params_from_numpy)

ARCHS = ["qwen2_7b", "codeqwen1_5_7b", "qwen1_5_110b", "gemma2_27b",
         "recurrentgemma_9b", "rwkv6_3b"]
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)
        tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
        np_params = jax.device_get(jax_init_params(
            jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
        _MODELS[arch] = (jcfg, tcfg, np_params,
                         params_from_numpy(np_params))
    return _MODELS[arch]


def _batch(cfg, S, seed, B=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _compare(jcfg, tcfg, np_params, tparams, batch):
    jlogits = np.asarray(jax_forward(jcfg, np_params,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()}))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tlogits = forward(tcfg, tparams, tbatch).numpy()
        tloss = float(loss_fn(tcfg, tparams, tbatch))
    jloss = float(jax_loss_fn(jcfg, np_params,
                              {k: jnp.asarray(v) for k, v in batch.items()}))
    assert tlogits.shape == jlogits.shape
    np.testing.assert_allclose(tlogits, jlogits, atol=2e-4, rtol=2e-4)
    assert (tlogits.argmax(-1) == jlogits.argmax(-1)).all()
    assert tloss == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, S):
    jcfg, tcfg, np_params, tparams = _model(arch)
    _compare(jcfg, tcfg, np_params, tparams, _batch(jcfg, S, seed=S))


@pytest.mark.parametrize("arch", ["gemma2_27b", "recurrentgemma_9b"])
def test_chunked_attention_matches_reference(arch):
    """Ragged chunks (S=30 over chunks of 8): padding, banded windows,
    softcaps (gemma2) and MQA (recurrentgemma) through both packages'
    ``chunked_attention``."""
    jcfg, tcfg, np_params, tparams = _model(arch)
    kw = dict(attn_impl="chunked", attn_q_chunk=8, attn_kv_chunk=8)
    _compare(jcfg.replace(**kw), tcfg.replace(**kw), np_params, tparams,
             _batch(jcfg, 30, seed=5))


def test_last_logit_only():
    _, tcfg, _, tparams = _model("recurrentgemma_9b")
    tokens = torch.from_numpy(_batch(tcfg, 12, seed=1)["tokens"])
    with torch.no_grad():
        full = lm_forward(tcfg, tparams, tokens)
        last = lm_forward(tcfg, tparams, tokens, last_logit_only=True)
    assert last.shape == (2, 1, tcfg.vocab)
    torch.testing.assert_close(last, full[:, -1:])


def test_unported_families_raise():
    """What raises is what the reference refuses too: the encoder-decoder
    family's ``decode_step`` on a chunk or a block table (its forward and
    one-token decode are ported: tests/test_torch_encdec.py). The M (MoE)
    layer kind, which raised until it was ported, now gives the
    reference's logits and loss (moonshot smoke, every layer M)."""
    cfg = configs.get("whisper_base", smoke=True).replace(
        dtype=torch.float32)
    cache = init_decode_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="encdec is S=1"):
        decode_step(cfg, {}, cache, torch.zeros((1, 2), dtype=torch.int32),
                    0)
    with pytest.raises(NotImplementedError, match="encdec is S=1"):
        decode_step(cfg, {}, cache, torch.zeros((1, 1), dtype=torch.int32),
                    0, paged_tables=torch.zeros((1, 2), dtype=torch.int32))
    jcfg, tcfg, np_params, tparams = _model("moonshot_v1_16b_a3b")
    assert set(tcfg.layer_pattern) == {"M"}
    _compare(jcfg, tcfg, np_params, tparams, _batch(jcfg, 24, seed=6))
