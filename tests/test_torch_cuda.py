"""The port's CUDA kernels (paged attention, flash-decoding) against their
plain versions, on the card. These tests need a GPU and nvcc; elsewhere
they skip. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain,
                                 paged_attention_plain,
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


# (B, S, H, KV, D, window, softcap, valid lengths): the reference test's
# cases (valid S - 7i), rows that see nothing or one slot, the gemma2 main
# path's shapes (ragged at S=128, the wrapped L window at S=4096, split
# over blocks), split key ranges under a window and past the cache's
# width, and odd sizes: qwen2 smoke's G=7 heads of D=8, D=256, G=16 (two
# row groups a KV head), MQA with G=8
DECODE_CASES = [
    (2, 128, 4, 2, 64, None, None, [128, 121]),
    (1, 200, 8, 1, 64, None, 50.0, [200]),
    (3, 256, 4, 4, 64, 64, None, [256, 249, 242]),
    (2, 96, 8, 2, 128, None, None, [96, 89]),
    (4, 40, 4, 2, 32, None, None, [0, 1, 40, 17]),
    (8, 128, 32, 16, 128, None, 50.0, [80, 128, 1, 96, 33, 64, 127, 5]),
    (8, 4096, 32, 16, 128, None, 50.0, [4096] * 8),
    (3, 1000, 8, 4, 64, 300, 30.0, [1000, 640, 0]),
    (2, 700, 4, 2, 64, None, None, [900, 333]),
    (3, 33, 7, 1, 8, None, None, [33, 2, 20]),
    (2, 300, 4, 2, 256, None, None, [300, 271]),
    (2, 64, 32, 2, 64, 16, None, [64, 10]),
    (2, 512, 8, 1, 128, None, 50.0, [512, 77]),
]


def _decode_inputs(case, dtype, dev, seed):
    B, S, H, KV, D, _, _, valid = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(dev, dtype) for s in
               [(B, H, D), (B, S, KV, D), (B, S, KV, D)])
    return [q, k, v, torch.tensor(valid, dtype=torch.int32, device=dev)]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_decode_kernel_matches_plain(dev, case, dtype, atol):
    """f32: both sum in fp32, in different orders. bf16: both round an
    fp32 result below 2 in magnitude to bf16 (one ulp <= 7.8e-3)."""
    window, softcap = case[5], case[6]
    args = _decode_inputs(case, getattr(torch, dtype), dev,
                          seed=sum(case[:5]))
    before = decode_attention.launches
    got = decode_attention(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(*args, window, softcap)
    assert (got.float() - want.float()).abs().max().item() <= atol
    for b, vl in enumerate(case[-1]):
        if vl == 0:
            assert not got[b].any()


def test_decode_wrapper_raises_on_what_kernel_does_not_take(dev):
    case = DECODE_CASES[0]
    args = _decode_inputs(case, torch.float16, dev, seed=0)
    with pytest.raises(TypeError):
        decode_attention(*args)
    q, k, v, valid = _decode_inputs(case, torch.float32, dev, seed=0)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q, k, v, valid.long())
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                         v, valid)
    with pytest.raises(ValueError, match="mixed devices|is on"):
        decode_attention(q, k.cpu(), v, valid)
    with pytest.raises(ValueError, match="window"):
        decode_attention(q, k, v, valid, window=-1)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous(), valid)
