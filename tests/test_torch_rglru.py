"""The port's RG-LRU scan (K5's plain versions and the CPU route of its
wrapper) against the reference's oracle ``kernels.ref.rglru_ref`` and its
Pallas ``rglru_scan`` (interpret mode on the CPU), and the whole
``rglru_block`` against the reference's on the recurrentgemma-9b smoke
config, f32, on the same seeded inputs and weights.

Scan forward within 1e-5, as the reference test holds its kernel; the
backward within 1e-5 of each gradient's largest magnitude against
``jax.vjp`` of the oracle; the block within 2e-4 (its gate and projection
products sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.kernels import rglru_scan as jax_rglru  # noqa: E402
from repro.kernels.ref import rglru_ref  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import rglru_scan  # noqa: E402
from repro_torch.kernels import (rglru_scan_bwd_plain,  # noqa: E402
                                 rglru_scan_plain)
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

# (B, T, W, block_t, block_w): the reference test's cases,
# tests/test_kernels.py:76-77
RGLRU_CASES = [(1, 64, 128, 16, 128), (2, 200, 256, 64, 128),
               (1, 256, 512, 256, 256), (3, 33, 128, 32, 128)]


def _inputs(B, T, W, seed):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, W))))
    b = rng.standard_normal((B, T, W))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_plain_scan_matches_reference(case):
    B, T, W, bt, bw = case
    a, b = _inputs(B, T, W, seed=T + W)
    y_ref, h_ref = rglru_ref(jnp.asarray(a), jnp.asarray(b))
    y_ker, h_ker = jax_rglru(jnp.asarray(a), jnp.asarray(b), block_t=bt,
                             block_w=bw)
    y, h = rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
    for want_y, want_h in ((y_ref, h_ref), (y_ker, h_ker)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   atol=1e-5, rtol=1e-5)
    # the wrapper's CPU route is the plain version
    wy, wh = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(wy, y) and torch.equal(wh, h)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_plain_backward_matches_reference_grad(case):
    B, T, W = case[:3]
    a, b = _inputs(B, T, W, seed=T * 7 + W)
    g = np.random.default_rng(T).standard_normal((B, T, W)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b: rglru_ref(a, b)[0], jnp.asarray(a),
                     jnp.asarray(b))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]

    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    y, _ = rglru_scan_plain(ta, tb)
    got = rglru_scan_bwd_plain(ta.detach(), y.detach(), torch.from_numpy(g))
    autograd = torch.autograd.grad(y, (ta, tb), torch.from_numpy(g))
    wrapped = torch.autograd.grad(rglru_scan(ta, tb)[0], (ta, tb),
                                  torch.from_numpy(g))
    for x, ag, wg, r in zip(got, autograd, wrapped, want):
        scale = float(np.abs(r).max())
        assert np.abs(x.numpy() - r).max() <= 1e-5 * scale
        assert np.abs(x.numpy() - ag.numpy()).max() <= 1e-5 * scale
        assert torch.equal(x, wg)


def test_rglru_block_matches_reference():
    jcfg = jax_configs.get("recurrentgemma_9b",
                           smoke=True).replace(dtype=jnp.float32)
    tcfg = configs.get("recurrentgemma_9b",
                       smoke=True).replace(dtype=torch.float32)
    np_params = jax.device_get(jax_init_params(
        jax.random.key(0), jax_model_spec(jcfg), dtype=jnp.float32))
    rec = {k: v[0] for k, v in np_params["stack"]["0_R"]["rec"].items()}
    # conv_b inits to zeros: give it values so the test sees it
    rec["conv_b"] = np.random.default_rng(2).standard_normal(
        rec["conv_b"].shape).astype(np.float32)
    x = np.random.default_rng(1).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)
    want, want_state = JR.rglru_block(jcfg, rec, jnp.asarray(x))
    got, state = TR.rglru_block(tcfg, params_from_numpy(rec),
                                torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    for name in ("conv", "h"):
        np.testing.assert_allclose(state[name].numpy(),
                                   np.asarray(want_state[name]), atol=2e-4,
                                   rtol=2e-4)
    # the decode form (it raised until it was ported): one more token
    # from the state each package's prefill left
    x1 = np.random.default_rng(3).standard_normal(
        (2, 1, jcfg.d_model)).astype(np.float32)
    want1, want_state1 = JR.rglru_block(jcfg, rec, jnp.asarray(x1),
                                        state=want_state)
    got1, state1 = TR.rglru_block(tcfg, params_from_numpy(rec),
                                  torch.from_numpy(x1), state=state)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=2e-4,
                               rtol=2e-4)
    for name in ("conv", "h"):
        np.testing.assert_allclose(state1[name].numpy(),
                                   np.asarray(want_state1[name]), atol=2e-4,
                                   rtol=2e-4)
