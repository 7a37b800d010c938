"""The port's paged decode step against the reference's ``decode_step(...,
paged_tables=)`` on the qwen2-7b smoke config in f32, with the reference's
weights carried over by the bridge and one seeded pool, block tables and
chunk handed to both.

Logits of every live row agree within 2e-4 (the reference's parity bar:
f32 everywhere, different summation orders). The pool rows the first
layer writes for real tokens agree within 1e-6: their inputs are the
same embeddings on both sides. Deeper layers' rows carry the f32 drift of
the layers below and are held to the logits' 2e-4. Every padded or
inactive-slot token lands in junk row 0, and no other row changes."""
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
from repro_torch.models import lm_decode_step, params_from_numpy  # noqa: E402

BT, NB, NW = 4, 40, 6


@pytest.fixture(scope="module")
def model():
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    return jcfg, tcfg, np_params, params_from_numpy(np_params)


def _case(cfg, S, seed):
    """Four slots: ragged real lengths, one inactive slot (lens 0, all-zero
    table). Live tables hold disjoint shuffled rows, never row 0."""
    rng = np.random.default_rng(seed)
    B = 4
    shape = (cfg.n_layers, NB, BT, cfg.kv_heads, cfg.d_head)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    tables = (1 + rng.permutation(NB - 1)[:B * NW]).reshape(B, NW)
    tables = tables.astype(np.int32)
    lens = np.array([S, max(S - 3, 1), 0, max(S // 2, 1)], np.int32)
    pos = np.array([5, 0, 0, 13], np.int32)
    tables[2] = 0
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return pool, tables, lens, pos, tokens


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("decode_kernel", ["auto", "xla"])
def test_paged_decode_step_matches_reference(model, S, decode_kernel):
    jcfg, tcfg, np_params, tparams = model
    tcfg = tcfg.replace(decode_kernel=decode_kernel)
    pool, tables, lens, pos, tokens = _case(jcfg, S, seed=S)
    jpool = {"stack": {"0_G": {n: jnp.asarray(a) for n, a in pool.items()}}}
    jlogits, jnew = decode_step(jcfg, np_params, jpool, jnp.asarray(tokens),
                                jnp.asarray(pos), seq_lens=jnp.asarray(lens),
                                paged_tables=jnp.asarray(tables))
    tpool = {"stack": {"0_G": {n: torch.from_numpy(a.copy())
                               for n, a in pool.items()}}}
    tlogits, tnew = lm_decode_step(
        tcfg, tparams, tpool, torch.from_numpy(tokens),
        torch.from_numpy(pos), seq_lens=torch.from_numpy(lens),
        paged_tables=torch.from_numpy(tables))
    assert tnew is tpool                        # updated in place
    live = lens > 0
    assert tlogits.shape == (4, 1, jcfg.vocab)
    np.testing.assert_allclose(tlogits.numpy()[live],
                               np.asarray(jlogits)[live],
                               atol=2e-4, rtol=2e-4)

    written = np.zeros((NB, BT), bool)          # (row, offset) of real tokens
    for b in range(4):
        for j in range(lens[b]):
            t = pos[b] + j
            written[tables[b, t // BT], t % BT] = True
    padded = int((S - lens).sum())
    for n in "kv":
        got = tpool["stack"]["0_G"][n].numpy()
        ref = np.asarray(jnew["stack"]["0_G"][n])
        np.testing.assert_allclose(got[0][written], ref[0][written],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got[:, written], ref[:, written],
                                   atol=2e-4, rtol=2e-4)
        untouched = ~written
        untouched[0] = False
        np.testing.assert_array_equal(got[:, untouched],
                                      pool[n][:, untouched])
        # every padded / inactive token went to the junk row
        assert padded > 0
        assert (got[:, 0] != pool[n][:, 0]).any()


def test_paged_decode_step_config_variant():
    """The decode-step branches qwen2 does not take: post-norms, attention
    and final softcaps, tied and scaled embeddings (an all-global gemma-
    style config), S=8, against the reference."""
    kw = dict(post_norms=True, attn_logit_softcap=50.0,
              final_logit_softcap=30.0, tie_embeddings=True,
              embed_scale=True)
    jcfg = jax_configs.get("qwen2_7b", smoke=True).replace(
        dtype=jnp.float32, **kw)
    tcfg = configs.get("qwen2_7b", smoke=True).replace(
        dtype=torch.float32, **kw)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(2), jax_model_spec(jcfg), dtype=jnp.float32))
    pool, tables, lens, pos, tokens = _case(jcfg, 8, seed=3)
    jpool = {"stack": {"0_G": {n: jnp.asarray(a) for n, a in pool.items()}}}
    jlogits, _ = decode_step(jcfg, np_params, jpool, jnp.asarray(tokens),
                             jnp.asarray(pos), seq_lens=jnp.asarray(lens),
                             paged_tables=jnp.asarray(tables))
    tpool = {"stack": {"0_G": {n: torch.from_numpy(a.copy())
                               for n, a in pool.items()}}}
    tlogits, _ = lm_decode_step(
        tcfg, params_from_numpy(np_params), tpool, torch.from_numpy(tokens),
        torch.from_numpy(pos), seq_lens=torch.from_numpy(lens),
        paged_tables=torch.from_numpy(tables))
    live = lens > 0
    np.testing.assert_allclose(tlogits.numpy()[live],
                               np.asarray(jlogits)[live],
                               atol=2e-4, rtol=2e-4)
