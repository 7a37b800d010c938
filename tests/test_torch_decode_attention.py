"""The port's flash-decoding attention (its plain version, which is what the
wrapper runs on CPU tensors) against the reference's Pallas decode kernel
in interpret mode, on the reference test's cases, the model path's case
and rows with nothing or one slot to see; and the wrapper's contract:
plain version for CPU tensors only, no launch counted there.

Inputs are made with numpy from a seed and handed to both. atol 3e-5, the
reference test's tolerance: both sides accumulate in fp32, in different
orders."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain)

ATOL = 3e-5

# (B, S, H, KV, D, window, softcap), as tests/test_kernels.py
DECODE_CASES = [
    (2, 128, 4, 2, 64, None, None),
    (1, 200, 8, 1, 64, None, 50.0),      # MQA + softcap, ragged S
    (3, 256, 4, 4, 64, 64, None),        # sliding window
    (2, 96, 8, 2, 128, None, None),
]


def _inputs(B, S, H, KV, D, valid, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    return q, k, v, np.asarray(valid, np.int32)


def _both(q, k, v, valid, window, softcap, block_k=64):
    ref = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(valid),
                                window=window, softcap=softcap,
                                block_k=block_k))
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    return ref, decode_attention_plain(*t, window, softcap).numpy()


@pytest.mark.parametrize("case", DECODE_CASES)
def test_plain_matches_pallas_kernel(case):
    B, S, H, KV, D, window, softcap = case
    args = _inputs(B, S, H, KV, D, [S - 7 * i for i in range(B)], seed=S + H)
    ref, got = _both(*args, window, softcap)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


def test_plain_matches_pallas_kernel_on_model_path_case():
    """The shape the gemma2 decode gives it: GQA pairs (G=2), softcap 50,
    ragged valid lengths, one row whose rolling window has wrapped (the
    whole buffer valid)."""
    args = _inputs(3, 64, 4, 2, 16, [64, 9, 1], seed=4)
    ref, got = _both(*args, None, 50.0, block_k=32)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("window", [None, 4])
def test_rows_that_see_nothing_or_one_slot(window):
    """valid_len 0 gives 0 (the kernel divides by max(l, 1e-30)); valid
    1 gives that slot's value row; next to a full row."""
    args = _inputs(3, 32, 4, 2, 32, [0, 1, 32], seed=6)
    ref, got = _both(*args, window, None, block_k=16)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=ATOL)
    assert not got[0].any()
    v = args[2]
    np.testing.assert_allclose(got[1].reshape(2, 2, 32),
                               np.repeat(v[1, 0][:, None], 2, axis=1),
                               atol=ATOL, rtol=ATOL)


def test_valid_length_past_the_cache_counts_every_slot():
    """A G layer at a position past max_seq attends its whole cache."""
    q, k, v, _ = _inputs(2, 24, 4, 2, 16, [0, 0], seed=8)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = decode_attention_plain(*t, torch.tensor([30, 24], dtype=torch.int32))
    full = decode_attention_plain(*t, torch.tensor([24, 24],
                                                   dtype=torch.int32))
    assert torch.equal(got, full)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    B, S, H, KV, D, window, softcap = DECODE_CASES[2]
    t = [torch.from_numpy(a) for a in _inputs(B, S, H, KV, D, [S, 100, 3],
                                              seed=1)]
    before = decode_attention.launches
    out = decode_attention(*t, window=window, softcap=softcap)
    assert torch.equal(out, decode_attention_plain(*t, window, softcap))
    assert decode_attention.launches == before   # no kernel launched
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_attention(*[x.to("meta") for x in t])
