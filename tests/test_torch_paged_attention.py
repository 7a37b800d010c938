"""The port's paged attention (its plain version, which is what the wrapper
runs on CPU tensors) against the reference's Pallas paged kernel in
interpret mode, on the reference test's cases; and the wrapper's contract:
plain version for CPU tensors only, no launch counted there.

Inputs are made with numpy from a seed and handed to both. atol 3e-5, the
reference test's tolerance: both sides accumulate in fp32, in different
orders."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention  # noqa: E402
from repro.kernels import paged_decode_attention as jax_paged  # noqa: E402
from repro_torch.kernels import (paged_attention_plain,  # noqa: E402
                                 paged_decode_attention)

ATOL = 3e-5

# (B, S, H, KV, D, bt, NW, softcap), as tests/test_paged_attention.py
PAGED_CASES = [
    (2, 1, 4, 2, 64, 8, 8, None),        # plain decode, GQA
    (3, 4, 4, 1, 64, 8, 6, None),        # prefill chunk, MQA
    (1, 8, 8, 2, 32, 4, 16, 50.0),       # chunk > bt, softcap
    (2, 3, 2, 2, 128, 16, 4, None),      # chunk not dividing bt
]


def _inputs(case, seed):
    B, S, H, KV, D, bt, NW, _ = case
    NB = B * NW + 3                      # pool bigger than any one table
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    kp = rng.normal(size=(NB, bt, KV, D)).astype(np.float32)
    vp = rng.normal(size=(NB, bt, KV, D)).astype(np.float32)
    # disjoint, shuffled tables: pool row order is unrelated to position
    tables = rng.permutation(NB)[:B * NW].reshape(B, NW).astype(np.int32)
    pos0 = np.array([(7 * b + 5) % (NW * bt - S) for b in range(B)])
    qpos = (pos0[:, None] + np.arange(S)[None, :]).astype(np.int32)
    return q, kp, vp, tables, qpos


def _both(q, kp, vp, tables, qpos, softcap):
    ref = np.asarray(jax_paged(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tables),
                               jnp.asarray(qpos), softcap=softcap))
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, qpos)]
    return ref, paged_attention_plain(*t, softcap=softcap).numpy()


@pytest.mark.parametrize("case", PAGED_CASES)
def test_plain_matches_pallas_kernel(case):
    ref, got = _both(*_inputs(case, seed=sum(case[:6])), case[-1])
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_identity_table_matches_flash_decoding():
    """Identity table (row i backs positions [i*bt, (i+1)*bt)) and S=1:
    the plain paged attention reproduces the reference's flash-decoding
    kernel over the contiguous cache, as the reference test holds its
    paged kernel to it."""
    B, H, KV, D, bt, NW = 2, 4, 2, 64, 8, 8
    S_cache = NW * bt
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kp = rng.normal(size=(B * NW, bt, KV, D)).astype(np.float32)
    vp = rng.normal(size=(B * NW, bt, KV, D)).astype(np.float32)
    tables = np.arange(B * NW, dtype=np.int32).reshape(B, NW)
    valid = np.array([S_cache, S_cache - 13], np.int32)
    got = paged_attention_plain(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(valid[:, None] - 1))
    kc = kp[tables].reshape(B, S_cache, KV, D)
    vc = vp[tables].reshape(B, S_cache, KV, D)
    ref = decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(kc),
                           jnp.asarray(vc), jnp.asarray(valid), block_k=bt)
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(ref),
                               atol=ATOL, rtol=ATOL)


def test_inactive_row_with_zero_table():
    """An inactive slot: all-zero padded table (every block is junk row 0)
    and lens 0, so its chunk sits at positions 0..S-1; next to a live row
    with a shuffled table."""
    case = (2, 4, 4, 2, 64, 8, 6, None)
    q, kp, vp, tables, _ = _inputs(case, seed=5)
    tables[1] = 0
    qpos = np.stack([np.arange(20, 24), np.arange(4)]).astype(np.int32)
    ref, got = _both(q, kp, vp, tables, qpos, None)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    case = PAGED_CASES[2]
    t = [torch.from_numpy(a) for a in _inputs(case, seed=1)]
    before = paged_decode_attention.launches
    out = paged_decode_attention(*t, softcap=case[-1])
    assert torch.equal(out, paged_attention_plain(*t, softcap=case[-1]))
    assert paged_decode_attention.launches == before  # no kernel launched
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_decode_attention(*[x.to("meta") for x in t])
