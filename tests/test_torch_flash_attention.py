"""The port's flash attention (K3's plain versions and the CPU route of its
wrapper) against the reference's Pallas ``flash_attention`` (interpret
mode on the CPU) and its oracle ``kernels.ref.attention_ref``, on the same
seeded inputs.

Forward: the reference test's ``FLASH_CASES`` without the bidirectional
one (the kernel route is causal only), f32 within 2e-5 and bf16 within
2e-2, as the reference test holds its kernel. Backward: against
``jax.vjp`` of the oracle and against torch autograd of the plain forward,
f32, each gradient within 1e-4 of its largest magnitude (both sides sum
the same products in different orders)."""
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
