"""The port's CUDA paged-attention kernel against its plain version, on the
card. These tests need a GPU and nvcc; elsewhere they skip. Run them on
the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (paged_attention_plain,  # noqa: E402
                                 paged_decode_attention)

pytestmark = pytest.mark.cuda

# (B, S, H, KV, D, bt, NW, softcap): the reference test's cases, the main
# path's decode and prefill shapes, and odd sizes (D=8 smoke heads, bt=5,
# D=256 with its larger shared-memory tile)
CASES = [
    (2, 1, 4, 2, 64, 8, 8, None),
    (3, 4, 4, 1, 64, 8, 6, None),
    (1, 8, 8, 2, 32, 4, 16, 50.0),
    (2, 3, 2, 2, 128, 16, 4, None),
    (8, 1, 28, 4, 128, 16, 64, None),
    (4, 64, 28, 4, 128, 16, 40, None),
    (3, 5, 7, 1, 8, 5, 7, 30.0),
    (2, 9, 4, 2, 256, 16, 5, None),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _inputs(case, dtype, dev, seed):
    B, S, H, KV, D, bt, NW, _ = case
    rng = np.random.default_rng(seed)
    NB = B * NW + 3
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s, np.float32))
                 .to(dev, dtype) for s in
                 [(B, S, H, D), (NB, bt, KV, D), (NB, bt, KV, D)])
    tables = rng.permutation(NB)[:B * NW].reshape(B, NW).astype(np.int32)
    pos0 = rng.integers(0, NW * bt - S + 1, B)
    qpos = (pos0[:, None] + np.arange(S)[None, :]).astype(np.int32)
    return [q, kp, vp, torch.from_numpy(tables).to(dev),
            torch.from_numpy(qpos).to(dev)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_kernel_matches_plain(dev, case, dtype, atol):
    """f32: both sum in fp32, in different orders. bf16: both round an
    fp32 result below 2 in magnitude to bf16 (one ulp <= 7.8e-3)."""
    args = _inputs(case, getattr(torch, dtype), dev, seed=sum(case[:7]))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, softcap=case[-1])
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_attention_plain(*args, softcap=case[-1])
    assert (got.float() - want.float()).abs().max().item() <= atol


def test_wrapper_raises_on_what_kernel_does_not_take(dev):
    args = _inputs(CASES[0], torch.float16, dev, seed=0)
    with pytest.raises(TypeError):
        paged_decode_attention(*args)
    args = _inputs(CASES[1], torch.float32, dev, seed=0)
    D = args[0].shape[-1]
    strided_q = torch.cat([args[0], args[0]], dim=-1)[..., :D]
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(strided_q, *args[1:])
    with pytest.raises(ValueError, match="mixed devices|is on"):
        paged_decode_attention(args[0], args[1].cpu(), *args[2:])
