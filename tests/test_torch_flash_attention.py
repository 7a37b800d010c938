"""The port's flash attention (K3's plain versions and the CPU route of its
wrapper) against the reference's Pallas ``flash_attention`` (interpret
mode on the CPU) and its oracle ``kernels.ref.attention_ref``, on the same
seeded inputs.

Forward: the reference test's ``FLASH_CASES`` without the bidirectional
one, f32 within 2e-5 and bf16 within 2e-2, as the reference test holds its
kernel. Backward: against ``jax.vjp`` of the oracle and against torch
autograd of the plain forward, f32, each gradient within 1e-4 of its
largest magnitude (both sides sum the same products in different orders).
Then the masks of the encoder-decoder and image-prefix paths
(``MASK_CASES``: non-causal with Sq != Skv, bidirectional, the prefix-LM
``prefix_len``) under the same bars, against the oracle and the Pallas
kernel where they take the case and otherwise against the reference's
dense attention under the reference's own mask."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels.ref import attention_ref  # noqa: E402
from repro_torch.kernels import (flash_attention,  # noqa: E402
                                 flash_attention_bwd_plain,
                                 flash_attention_plain)

# (B, S, H, KV, D, causal, window, softcap, dtype, tol): the reference
# test's cases, tests/test_kernels.py:24-32, without the bidirectional one
FLASH_CASES = [
    (1, 128, 2, 2, 64, True, None, None, "float32", 2e-5),
    (2, 256, 4, 1, 64, True, None, None, "float32", 2e-5),   # MQA
    (1, 256, 8, 2, 64, True, None, 50.0, "float32", 2e-5),   # softcap
    (1, 320, 4, 4, 64, True, 128, None, "float32", 2e-5),    # window
    (1, 256, 4, 2, 64, True, None, None, "bfloat16", 2e-2),  # bf16
    (1, 100, 2, 1, 64, True, 32, 30.0, "float32", 2e-5),     # ragged+all
]
IDS = [f"B{c[0]}S{c[1]}H{c[2]}KV{c[3]}w{c[6]}s{c[7]}{c[8]}"
       for c in FLASH_CASES]


def _inputs(case, seed):
    B, S, H, KV, D = case[:5]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)]]


def _to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("case", FLASH_CASES, ids=IDS)
def test_plain_forward_matches_reference_kernel_and_oracle(case):
    B, S, H, KV, D, causal, window, softcap, dtype, tol = case
    arrays = _inputs(case, seed=S + H)
    jq, jk, jv = _to_jax(arrays, dtype)
    want_kernel = np.asarray(jax_flash(jq, jk, jv, causal=causal,
                                       window=window, softcap=softcap,
                                       block_q=64, block_k=64), np.float32)
    f32 = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    want_oracle = np.asarray(attention_ref(*f32, causal=causal,
                                           window=window, softcap=softcap),
                             np.float32)
    tq, tk, tv = _to_torch(arrays, dtype)
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, softcap=softcap)
    assert out.dtype == tq.dtype and out.shape == (B, S, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    got = out.float().numpy()
    np.testing.assert_allclose(got, want_kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want_oracle, atol=tol, rtol=tol)
    # the wrapper's CPU route is the plain version
    wrapped = flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=softcap)
    assert torch.equal(wrapped, out)


def test_lse_is_the_log_sum_exp_of_the_visible_scores():
    B, S, H, KV, D, window, softcap = 1, 70, 4, 2, 16, 20, 30.0
    q, k, v = _to_torch(_inputs((B, S, H, KV, D), seed=3), "float32")
    _, lse = flash_attention_plain(q, k, v, window=window, softcap=softcap,
                                   block_q=32, block_k=16)
    kr = torch.repeat_interleave(k, H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) / D ** 0.5
    s = softcap * torch.tanh(s / softcap)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    s = torch.where((j <= i) & (j > i - window), s, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5,
                               rtol=1e-5)


F32_CASES = [c for c in FLASH_CASES if c[8] == "float32"]


@pytest.mark.parametrize("case", F32_CASES,
                         ids=[i for c, i in zip(FLASH_CASES, IDS)
                              if c[8] == "float32"])
def test_plain_backward_matches_reference_grad(case):
    B, S, H, KV, D, causal, window, softcap, _, _ = case
    arrays = _inputs(case, seed=S * 3 + H)
    dout = np.random.default_rng(S).standard_normal(
        (B, S, H, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: attention_ref(
        q, k, v, causal=causal, window=window, softcap=softcap),
        *[jnp.asarray(a) for a in arrays])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    tq, tk, tv = [t.requires_grad_(True)
                  for t in _to_torch(arrays, "float32")]
    out, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                     window=window, softcap=softcap)
    tdout = torch.from_numpy(dout)
    autograd = torch.autograd.grad(out, (tq, tk, tv), tdout)
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                    out.detach(), lse.detach(), tdout,
                                    causal=causal,
                                    window=window, softcap=softcap,
                                    block_q=48)
    # the wrapper's Function takes the same backward
    wrapped = torch.autograd.grad(
        flash_attention(tq, tk, tv, causal=causal, window=window,
                        softcap=softcap), (tq, tk, tv), tdout)
    for name, g, a, w, r in zip("qkv", got, autograd, wrapped, want):
        scale = float(np.abs(r).max())
        for other in (a, w):
            assert np.abs(g.numpy() - other.numpy()).max() <= 1e-4 * scale
        assert np.abs(g.numpy() - r).max() <= 1e-4 * scale, name


# (B, Sq, Skv, H, KV, D, causal, window, softcap, prefix_len): the masks of
# the encoder-decoder and image-prefix paths. Non-causal Sq != Skv both
# ways (a decoder's cross-attention; the key tail ragged against the
# tiles), non-causal Sq == Skv (an encoder), PaliGemma's prefix-LM mask
# alone, with a window and softcap, and with a prefix longer than the
# sequence
MASK_CASES = [
    (2, 37, 100, 4, 4, 16, False, None, None, 0),
    (1, 100, 37, 2, 1, 32, False, None, 30.0, 0),
    (1, 64, 64, 4, 2, 16, False, None, None, 0),
    (2, 40, 40, 4, 1, 32, True, None, None, 8),
    (1, 70, 70, 2, 2, 16, True, 16, 50.0, 30),
    (1, 20, 20, 2, 1, 16, True, None, None, 50),
]
MASK_IDS = [f"Sq{c[1]}Skv{c[2]}c{int(c[6])}w{c[7]}s{c[8]}p{c[9]}"
            for c in MASK_CASES]


def _mask_inputs(case, seed):
    B, Sq, Skv, H, KV, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)]]


def _reference_masked(case):
    """The reference's dense attention (``models.layers._sdpa``) under the
    reference's own mask (``models.attention._mask``: causal, window,
    ``m |= kpos < prefix_len``), as a function of (q, k, v)."""
    from types import SimpleNamespace

    from repro.models.attention import _mask
    from repro.models.layers import _sdpa
    _, Sq, Skv, _, _, _, causal, window, softcap, prefix = case
    m = _mask(0, 0, Sq, Skv, causal=causal, window=window,
              prefix_len=prefix)[None, None]
    cfg = SimpleNamespace(attn_logit_softcap=softcap)
    return lambda q, k, v: _sdpa(cfg, q, k, v, m)


@pytest.mark.parametrize("case", MASK_CASES, ids=MASK_IDS)
def test_plain_masks_match_reference(case):
    """f32 forward within 2e-5 of the reference's dense attention under
    its mask, and, for the non-causal cases, of ``attention_ref`` and the
    Pallas kernel (its key tail masked at ``kv_len``); tiles of 16 so the
    prefix and the key tail cross tile edges. The wrapper's CPU route is
    the plain version."""
    B, Sq, Skv, H, KV, D, causal, window, softcap, prefix = case
    arrays = _mask_inputs(case, seed=Sq + Skv)
    jq, jk, jv = _to_jax(arrays, "float32")
    wants = [np.asarray(_reference_masked(case)(jq, jk, jv))]
    if not causal:
        wants.append(np.asarray(attention_ref(
            jq, jk, jv, causal=False, window=window, softcap=softcap)))
        wants.append(np.asarray(jax_flash(
            jq, jk, jv, causal=False, window=window, softcap=softcap,
            block_q=16, block_k=16)))
    tq, tk, tv = _to_torch(arrays, "float32")
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix)
    out, lse = flash_attention_plain(tq, tk, tv, block_q=16, block_k=16,
                                     **kw)
    assert out.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    for want in wants:
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    assert torch.allclose(flash_attention(tq, tk, tv, **kw), out,
                          atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", MASK_CASES, ids=MASK_IDS)
def test_plain_mask_backward_matches_reference_grad(case):
    """The plain backward, the wrapper's Function and autograd of the plain
    forward against ``jax.vjp`` of the reference's dense attention under
    its mask: each gradient within 1e-4 of its largest magnitude."""
    B, Sq, Skv, H, KV, D, causal, window, softcap, prefix = case
    arrays = _mask_inputs(case, seed=3 * Sq + Skv)
    dout = np.random.default_rng(Sq).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    _, vjp = jax.vjp(_reference_masked(case),
                     *[jnp.asarray(a) for a in arrays])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix)
    tq, tk, tv = [t.requires_grad_(True)
                  for t in _to_torch(arrays, "float32")]
    out, lse = flash_attention_plain(tq, tk, tv, block_q=16, block_k=16,
                                     **kw)
    tdout = torch.from_numpy(dout)
    autograd = torch.autograd.grad(out, (tq, tk, tv), tdout)
    got = flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                    out.detach(), lse.detach(), tdout,
                                    block_q=16, **kw)
    wrapped = torch.autograd.grad(flash_attention(tq, tk, tv, **kw),
                                  (tq, tk, tv), tdout)
    for name, g, a, w, r in zip("qkv", got, autograd, wrapped, want):
        assert g.shape == r.shape, name
        scale = float(np.abs(r).max())
        for other in (g, a, w):
            assert np.abs(other.detach().numpy() - r).max() <= 1e-4 * scale, \
                name


def test_plain_and_wrapper_raise_on_what_neither_takes():
    """Causal attention with Sq != Skv raises (the reference's kernel has
    no query offset), as does a negative prefix."""
    q = torch.zeros((1, 5, 2, 8))
    k = torch.zeros((1, 7, 2, 8))
    for fn in (flash_attention_plain, flash_attention):
        with pytest.raises(ValueError, match="Sq == Skv"):
            fn(q, k, k, causal=True)
        with pytest.raises(ValueError, match="prefix_len"):
            fn(q, q, q, prefix_len=-1)
