"""The port's RWKV6 WKV (K4's plain version, the chunk-parallel form and
the CPU route of its wrapper) against the reference's oracle
``kernels.ref.rwkv6_ref`` and its Pallas ``rwkv6_wkv`` (interpret mode on
the CPU), and the time-mix and channel-mix against the reference's on the
rwkv6-3b smoke config, f32, on the same seeded inputs and weights.

The WKV within 1e-4 of the oracle's largest magnitude, the reference
test's bar (tests/test_kernels.py:111-128); chunk 16 against chunk 48
within 2e-4, as the reference test holds its kernel; the mixers within
2e-4 (their projections sum in other orders); the gradients through the
wrapper within 1e-4 of each gradient's largest magnitude against
``jax.vjp`` of the reference model's chunk-parallel WKV."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels import rwkv6_wkv as jax_rwkv6_wkv  # noqa: E402
from repro.kernels.ref import rwkv6_ref  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import rwkv6_scan as TK  # noqa: E402
from repro_torch.kernels import (rwkv6_wkv, rwkv6_wkv_chunked,  # noqa: E402
                                 rwkv6_wkv_plain)
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

# (B, T, H, N, chunk): the reference test's cases,
# tests/test_kernels.py:111-112
RWKV_CASES = [(1, 64, 2, 32, 16), (2, 96, 4, 64, 32), (1, 50, 2, 16, 32),
              (1, 128, 2, 128, 32)]


def _inputs(B, T, H, N, seed, logw_scale=0.5):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, T, H, N)) for _ in range(3))
    logw = np.clip(-np.exp(logw_scale * rng.standard_normal((B, T, H, N))),
                   -5.0, -1e-6)
    u = 0.5 * rng.standard_normal((H, N))
    return [x.astype(np.float32) for x in (r, k, v, logw, u)]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / (np.abs(want).max() + 1e-6))


@pytest.mark.parametrize("case", RWKV_CASES)
def test_plain_matches_reference(case):
    B, T, H, N, C = case
    xs = _inputs(B, T, H, N, seed=T + N)
    ref = rwkv6_ref(*map(jnp.asarray, xs))
    ker = jax_rwkv6_wkv(*map(jnp.asarray, xs), chunk=C)
    out, _ = rwkv6_wkv_plain(*map(torch.from_numpy, xs), chunk=C)
    assert out.dtype == torch.float32 and out.shape == (B, T, H, N)
    assert _rel(out.numpy(), ref) < 1e-4
    assert _rel(out.numpy(), ker) < 1e-4


@pytest.mark.parametrize("case", RWKV_CASES)
def test_chunked_and_wrapper_match_plain(case):
    """The chunk-parallel form and the wrapper's CPU route (chunk 16, the
    largest they take) against the plain version at the case's chunk:
    output and last state."""
    B, T, H, N, C = case
    xs = list(map(torch.from_numpy, _inputs(B, T, H, N, seed=T * 3 + N)))
    want, want_s = rwkv6_wkv_plain(*xs, chunk=C)
    for fn in (rwkv6_wkv_chunked, rwkv6_wkv):
        got, s = fn(*xs, chunk=16)
        assert _rel(got.numpy(), want.numpy()) < 1e-4
        assert _rel(s.numpy(), want_s.numpy()) < 1e-4
    plain16 = rwkv6_wkv_plain(*xs, chunk=16)
    wrapped = rwkv6_wkv(*xs, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(plain16, wrapped))


def test_chunk_invariance():
    """Chunks of 16 and 48 give one result (the state handoff);
    tests/test_kernels.py:131-143."""
    B, T, H, N = 1, 96, 2, 32
    xs = list(map(torch.from_numpy, _inputs(B, T, H, N, seed=0,
                                            logw_scale=0.3)))
    o16, s16 = rwkv6_wkv_plain(*xs, chunk=16)
    o48, s48 = rwkv6_wkv_plain(*xs, chunk=48)
    np.testing.assert_allclose(o16.numpy(), o48.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(s16.numpy(), s48.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_strong_decay_stays_finite():
    """logw = -5 throughout, the model's clip floor: the reference's
    factored form at chunk 32 overflows there; the port's plain version
    (any chunk) and chunked form (chunk 16) stay finite and agree with the
    oracle."""
    B, T, H, N = 1, 64, 2, 16
    xs = _inputs(B, T, H, N, seed=5)
    xs[3][:] = -5.0
    ref = rwkv6_ref(*map(jnp.asarray, xs))
    ts = list(map(torch.from_numpy, xs))
    for out, _ in (rwkv6_wkv_plain(*ts, chunk=16),
                   rwkv6_wkv_plain(*ts, chunk=48),
                   rwkv6_wkv_chunked(*ts, chunk=16)):
        assert torch.isfinite(out).all()
        assert _rel(out.numpy(), ref) < 1e-4


def test_chunk_limits_raise():
    xs = list(map(torch.from_numpy, _inputs(1, 8, 1, 4, seed=0)))
    for bad in (0, 17, 32):
        with pytest.raises(ValueError, match="chunk"):
            rwkv6_wkv(*xs, chunk=bad)
        with pytest.raises(ValueError, match="chunk"):
            rwkv6_wkv_chunked(*xs, chunk=bad)


def _smoke(arch="rwkv6_3b"):
    jcfg = jax_configs.get(arch, smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    layer = jax.tree.map(lambda a: a[0], np_params["stack"]["0_W"])
    return jcfg, tcfg, layer


def test_time_mix_matches_reference():
    """Output and the state a decode would continue from ({"shift", "S"},
    S being the WKV's last state) on ragged S=40; the zero-initialised
    mixing weights and w0 get values so the test sees them."""
    jcfg, tcfg, layer = _smoke()
    tm = dict(layer["tm"])
    rng = np.random.default_rng(3)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "ln_out"):
        tm[name] = (0.5 * rng.standard_normal(tm[name].shape)).astype(
            np.float32)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    want, want_state = JR.rwkv_time_mix(jcfg, tm, jnp.asarray(x))
    got, state = TR.rwkv_time_mix(tcfg, params_from_numpy(tm),
                                  torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    assert state["S"].shape == (2, 16, 4, 4)
    for name in ("shift", "S"):
        assert _rel(state[name].numpy(), want_state[name]) < 1e-5, name
    # the decode form (it raised until it was ported): one more token
    # from the state each package's prefill left
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want1, want_state1 = JR.rwkv_time_mix(jcfg, tm, jnp.asarray(x1),
                                          state=want_state)
    got1, state1 = TR.rwkv_time_mix(tcfg, params_from_numpy(tm),
                                    torch.from_numpy(x1), state=state)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-4,
                               rtol=2e-4)
    for name in ("shift", "S"):
        assert _rel(state1[name].numpy(), want_state1[name]) < 1e-5, name


def test_channel_mix_matches_reference():
    jcfg, tcfg, layer = _smoke()
    cm = dict(layer["cm"])
    rng = np.random.default_rng(4)
    for name in ("mu_k", "mu_r"):
        cm[name] = rng.standard_normal(cm[name].shape).astype(np.float32)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    want, want_shift = JR.rwkv_channel_mix(jcfg, cm, jnp.asarray(x))
    got, shift = TR.rwkv_channel_mix(tcfg, params_from_numpy(cm),
                                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(want_shift))
    # the decode form (it raised until it was ported): one more token
    # after the last one each package returned
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    want1, want_shift1 = JR.rwkv_channel_mix(jcfg, cm, jnp.asarray(x1),
                                             state=want_shift)
    got1, shift1 = TR.rwkv_channel_mix(tcfg, params_from_numpy(cm),
                                       torch.from_numpy(x1), state=shift)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_array_equal(shift1.numpy(), np.asarray(want_shift1))


@pytest.mark.parametrize("B,T,H,N", [(2, 40, 16, 4), (1, 64, 16, 8)])
def test_wrapper_gradients_match_reference(B, T, H, N):
    """Gradients for r, k, v, logw and u through ``rwkv6_wkv`` (its
    backward recomputes the chunk-parallel form) against ``jax.vjp`` of
    the reference's ``rwkv_time_mix`` training path with its projection
    and output stages replaced by the inputs and the identity, so what is
    differentiated is the reference's chunk-parallel WKV alone."""
    jcfg = jax_configs.get("rwkv6_3b", smoke=True).replace(
        dtype=jnp.float32, d_model=H * N)
    assert JR.rwkv_heads(jcfg) == (H, N)
    xs = _inputs(B, T, H, N, seed=T + H)
    g = np.random.default_rng(9).standard_normal((B, T, H, N)).astype(
        np.float32)

    def reference_wkv(r, k, v, logw, u):
        x = jnp.zeros((B, T, H * N), jnp.float32)
        with mock.patch.object(JR, "_rwkv_proj",
                               lambda *a: (r, k, v, r, logw)), \
                mock.patch.object(JR, "_rwkv_out",
                                  lambda cfg, prm, wkv, *a: wkv):
            return JR.rwkv_time_mix(jcfg, {"u": u}, x)[0]

    _, vjp = jax.vjp(reference_wkv, *map(jnp.asarray, xs))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    out, s_last = rwkv6_wkv(*leaves, chunk=16)
    assert not s_last.requires_grad
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("r", "k", "v", "logw", "u"), got, want):
        assert a.shape == w.shape, name
        assert _rel(a.numpy(), w) < 1e-4, name


def test_wrapper_gradients_match_plain_many_chunks():
    """Gradients through ``rwkv6_wkv`` (the chunk-parallel form, its state
    carried by the two-level scan over 63 chunks, the last one ragged)
    against autograd of the plain version (a loop over chunks with decays
    from differences of log decays), at the full model's head width."""
    B, T, H, N = 1, 1000, 2, 160
    xs = _inputs(B, T, H, N, seed=11)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, T, H, N)).astype(np.float32))
    got, want = [], []
    for fn, grads in ((rwkv6_wkv, got), (rwkv6_wkv_plain, want)):
        leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs]
        grads.extend(torch.autograd.grad(fn(*leaves, chunk=16)[0], leaves,
                                         g))
    for name, a, w in zip(("r", "k", "v", "logw", "u"), got, want):
        assert _rel(a.numpy(), w.numpy()) < 1e-4, name


def _carry_loop(D, M):
    S = torch.zeros_like(M[:, 0])
    prev = []
    for d, m in zip(D.unbind(1), M.unbind(1)):
        prev.append(S)
        S = d[..., None] * S + m
    return torch.stack(prev, dim=1), S


@pytest.mark.parametrize("nc", [1, 2, 7, 16, 17, 63])
def test_carry_matches_loop(nc):
    """The backward's two-level state carry (groups of about sqrt(nc)
    chunks, identity chunks padding the last group) against a loop over
    the chunks: the state entering each chunk, the last state, and their
    gradients."""
    rng = np.random.default_rng(nc)
    D0 = torch.from_numpy(rng.uniform(0.0, 1.0, (2, nc, 3, 8)))
    M0 = torch.from_numpy(rng.standard_normal((2, nc, 3, 8, 8)))
    gp = torch.from_numpy(rng.standard_normal((2, nc, 3, 8, 8)))
    gl = torch.from_numpy(rng.standard_normal((2, 3, 8, 8)))
    res = []
    for carry in (TK._carry, _carry_loop):
        D, M = D0.clone().requires_grad_(), M0.clone().requires_grad_()
        S_prev, S_last = carry(D, M)
        loss = (S_prev * gp).sum() + (S_last * gl).sum()
        res.append((S_prev, S_last, *torch.autograd.grad(loss, (D, M))))
    for a, w in zip(*res):
        np.testing.assert_allclose(a.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)
