"""The port's CUDA kernels (paged attention, flash-decoding, flash
attention, the RG-LRU scan, the RWKV6 WKV) against their plain versions,
on the card.
These tests need a GPU and nvcc; elsewhere they skip. Run them on the
card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain, flash_attention,
                                 flash_attention_bwd_plain,
                                 flash_attention_forward,
                                 flash_attention_plain,
                                 paged_attention_plain,
                                 paged_decode_attention, rglru_scan,
                                 rglru_scan_bwd_plain, rglru_scan_plain,
                                 rglru_scan_reverse, rwkv6_wkv,
                                 rwkv6_wkv_plain)
from repro_torch.models import (init_params, loss_fn,  # noqa: E402
                                model_spec, tree_paths)
from repro_torch.models.common import unflatten  # noqa: E402

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


# (B, S, H, KV, D, bt, NW, softcap): every branch of the simt, mma16 and
# mma64 designs. A long table (NW*bt = 4096, split over many blocks), qwen2's
# G=7 at D=8 and D=128, D=256 both ways, G=1, softcaps both ways, a bf16
# chunk whose S*G = 140 is no multiple of the 64-row tile, S*G = 16 and 17
# on either side of the switch from 16-row to 64-row tiles, and D=64 over
# 4096 keys, whose plans hold more splits (32, 64) than the merge pass has
# lanes on D (D/4 = 16)
SPLIT_MMA_CASES = [
    (8, 1, 28, 4, 128, 16, 256, None),
    (3, 1, 7, 1, 8, 8, 12, None),
    (4, 2, 28, 4, 128, 16, 32, None),
    (2, 1, 16, 2, 256, 16, 20, None),
    (2, 9, 4, 2, 256, 16, 5, None),
    (4, 1, 4, 4, 64, 8, 16, None),
    (2, 1, 28, 4, 128, 16, 40, 30.0),
    (2, 8, 8, 2, 64, 16, 16, 50.0),
    (4, 20, 28, 4, 128, 16, 24, None),
    (3, 16, 4, 4, 64, 16, 8, None),
    (3, 17, 4, 4, 64, 16, 8, None),
    (2, 1, 8, 1, 64, 16, 256, None),
]


def _ragged_inputs(case, dtype, dev, seed):
    """_inputs with ragged positions: row 0 ends at the table's last key,
    row 1 starts at 0, the last row is an idle slot (all-zero table,
    positions from 0) and, with B >= 4, row 2 sees no key (qpos -1)."""
    q, kp, vp, tables, qpos = _inputs(case, dtype, dev, seed)
    B, S = qpos.shape
    L = tables.shape[1] * kp.shape[1]
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    qpos[0] = L - S + ar
    qpos[1] = ar
    tables[-1] = 0
    qpos[-1] = ar
    if B >= 4:
        qpos[2] = -1
    return [q, kp, vp, tables, qpos]


@pytest.mark.parametrize("case", SPLIT_MMA_CASES)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_kernel_designs_match_plain(dev, case, dtype, atol):
    """Every design against the plain version on ragged positions, an idle
    slot and a row that sees no key (0 out); one launch counted a call,
    the merge pass included."""
    from repro_torch.kernels.paged_attention import paged_design
    B, S, H, KV = case[:4]
    args = _ragged_inputs(case, getattr(torch, dtype), dev,
                          seed=sum(case[:7]))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, softcap=case[-1])
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = paged_attention_plain(*args, softcap=case[-1])
    assert (got.float() - want.float()).abs().max().item() <= atol
    if B >= 4:
        assert not got[2].any()
    assert paged_design(S, H // KV, getattr(torch, dtype)) == (
        "simt" if dtype == "float32" else
        "mma64" if S * H // KV > 16 else "mma16")


def test_kernel_merges_many_splits(dev):
    """Decode calls whose plan splits the table over many blocks, in each
    design: the merge pass runs inside the one counted launch."""
    from repro_torch.kernels import paged_attention as pa
    case = (8, 1, 28, 4, 128, 16, 256, None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = _ragged_inputs(case, dtype, dev, seed=3)
        design = pa.paged_design(1, 7, dtype)
        assert pa.split_plan(design, 8, 1, 7, 4, 16, 256, n_sm)[0] > 1
        before = paged_decode_attention.launches
        got = paged_decode_attention(*args)
        torch.cuda.synchronize()
        assert paged_decode_attention.launches == before + 1
        want = paged_attention_plain(*args)
        assert (got.float() - want.float()).abs().max().item() <= atol


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


# (B, S, H, KV, D, window, softcap): the CPU test's cases (the reference
# test's), the smoke configs' heads (qwen2 G=7 of D=8, gemma2 D=16 with
# window 8 and softcap 50, recurrentgemma MQA of D=32 with window 16),
# the training shapes' heads at a short S (recurrentgemma D=256 MQA G=16
# with a window, gemma2 D=128 softcap), a ragged S below one tile and a
# window of 0 (rows that see nothing)
FLASH_CASES = [
    (1, 128, 2, 2, 64, None, None),
    (2, 256, 4, 1, 64, None, None),
    (1, 256, 8, 2, 64, None, 50.0),
    (1, 320, 4, 4, 64, 128, None),
    (1, 100, 2, 1, 64, 32, 30.0),
    (2, 40, 7, 1, 8, None, None),
    (2, 37, 4, 2, 16, 8, 50.0),
    (2, 64, 2, 1, 32, 16, None),
    (1, 300, 16, 1, 256, 100, None),
    (2, 200, 8, 4, 128, None, 50.0),
    (3, 5, 2, 1, 24, None, None),
    (1, 70, 2, 2, 64, 0, None),
]


def _flash_inputs(case, dtype, dev, seed):
    B, S, H, KV, D = case[:5]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(dev, dtype) for s in
            [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)]]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 2e-2)])
def test_flash_kernel_matches_plain(dev, case, dtype, atol):
    """Forward: out within atol (f32: fp32 sums in different orders; bf16:
    one ulp of an output below 2) and the fp32 lse within 1e-4. Backward
    through the Function (K3's out and lse, the plain backward) against
    torch autograd of the plain forward, f32: each gradient within 1e-4
    of its largest magnitude."""
    window, softcap = case[5], case[6]
    q, k, v = _flash_inputs(case, getattr(torch, dtype), dev,
                            seed=sum(case[:5]))
    kw = dict(causal=True, window=window, softcap=softcap)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, lse = flash_attention_plain(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max().item() <= atol
    if window == 0:
        assert not got.any()
    if dtype == "bfloat16":
        return
    _, klse = flash_attention_forward(q, k, v, **kw)
    assert (klse - lse).abs().max().item() <= 1e-4
    dout = torch.randn(got.shape, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, **kw), leaves,
                                dout)
    ref = torch.autograd.grad(flash_attention_plain(*leaves, **kw)[0],
                              leaves, dout)
    for g, r in zip(grads, ref):
        assert (g - r).abs().max().item() <= 1e-4 * max(
            r.abs().max().item(), 1e-30)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_wgmma_gradients_through_function(dev, case):
    """bf16 through the wgmma design: the lse within 1e-3 of the
    plain forward's (fp32 scores from exact bf16 products), and the
    gradients through the Function (K3's out and lse, the plain backward)
    against the plain backward fed the plain forward's, each within 2e-2
    of its largest magnitude (one bf16 ulp of out, carried through
    dout . out)."""
    from repro_torch.kernels.flash_attention import flash_design
    assert flash_design(torch.bfloat16) == "wgmma"
    window, softcap = case[5], case[6]
    q, k, v = _flash_inputs(case, torch.bfloat16, dev, seed=sum(case[:5]))
    kw = dict(causal=True, window=window, softcap=softcap)
    _, klse = flash_attention_forward(q, k, v, **kw)
    out, lse = flash_attention_plain(q, k, v, **kw)
    assert (klse - lse).abs().max().item() <= 1e-3
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention.launches
    grads = torch.autograd.grad(flash_attention(*leaves, **kw), leaves,
                                dout)
    assert flash_attention.launches == before + 1
    ref = flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    for g, r in zip(grads, ref):
        assert (g.float() - r.float()).abs().max().item() <= 2e-2 * max(
            r.float().abs().max().item(), 1e-30)


def test_flash_bwd_plain_from_kernel_lse(dev):
    """The plain backward fed K3's bf16 out and lse at recurrentgemma's
    L-layer head shape equals the one fed the plain forward's, within
    bf16 rounding."""
    case = (1, 256, 16, 1, 256, 64, None)
    q, k, v = _flash_inputs(case, torch.bfloat16, dev, seed=9)
    dout = torch.randn(q.shape, device=dev).to(torch.bfloat16)
    outs = [flash_attention_forward(q, k, v, window=64),
            flash_attention_plain(q, k, v, window=64)]
    g_kernel, g_plain = (flash_attention_bwd_plain(q, k, v, o, l, dout,
                                                   window=64)
                         for o, l in outs)
    for a, b in zip(g_kernel, g_plain):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 2e-2 * scale


def test_flash_wrapper_raises_on_what_kernel_does_not_take(dev):
    case = FLASH_CASES[0]
    q, k, v = _flash_inputs(case, torch.float16, dev, seed=0)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(case, torch.float32, dev, seed=0)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                                k, v)
    with pytest.raises(ValueError, match="mixed devices|is on"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :12].contiguous(), k[..., :12].contiguous(),
                        v[..., :12].contiguous())
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash_attention(q[:, :64].contiguous(), k, v)


# (B, T, W): the reference test's cases, a ragged T below and above the
# kernel's unroll, W not a multiple of its block, and the training shape's
# width at a short T
RGLRU_CASES = [(1, 64, 128), (2, 200, 256), (1, 256, 512), (3, 33, 128),
               (2, 7, 100), (1, 1, 64), (2, 128, 4096)]


def _rglru_inputs(B, T, W, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, T, W), generator=g, device=dev))
    b = torch.randn((B, T, W), generator=g, device=dev)
    return a, b


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_kernel_matches_plain(dev, case):
    """Kernel and plain versions round every product and sum on its own,
    in the same order: forward and reverse mode agree bit for bit."""
    a, b = _rglru_inputs(*case, dev, seed=sum(case))
    before = (rglru_scan.launches, rglru_scan_reverse.launches)
    y, h = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before[0] + 1
    want_y, want_h = rglru_scan_plain(a, b)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    dy = torch.randn(y.shape, device=dev)
    da, db = rglru_scan_reverse(a, y, dy)
    torch.cuda.synchronize()
    assert rglru_scan_reverse.launches == before[1] + 1
    want_da, want_db = rglru_scan_bwd_plain(a, want_y, dy)
    assert torch.equal(da, want_da) and torch.equal(db, want_db)
    leaves = [a.clone().requires_grad_(True), b.clone().requires_grad_(True)]
    grads = torch.autograd.grad(rglru_scan(*leaves)[0], leaves, dy)
    assert torch.equal(grads[0], da) and torch.equal(grads[1], db)


def test_rglru_wrapper_raises_on_what_kernel_does_not_take(dev):
    a, b = _rglru_inputs(2, 16, 64, dev, seed=0)
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.to(torch.bfloat16), b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, b[:, :8])
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), b)
    with pytest.raises(ValueError, match="one device"):
        rglru_scan(a, b.cpu())


# (B, T, H, N, chunk): the reference test's cases (tests/test_kernels.py:
# 111-112) at the kernel's chunk of at most 16, the smoke model's heads
# (N=4), ragged T, short chunks, N not a multiple of 4 or of the 32-column
# tile, the training cell's heads (N=160) and the largest N (256)
RWKV_CASES = [(1, 64, 2, 32, 16), (2, 96, 4, 64, 16), (1, 50, 2, 16, 16),
              (1, 128, 2, 128, 16), (2, 40, 16, 4, 16), (1, 37, 3, 20, 5),
              (2, 9, 2, 33, 16), (1, 100, 2, 160, 16), (1, 48, 1, 256, 16),
              (1, 1, 2, 8, 16)]


def _rwkv_inputs(B, T, H, N, dtype, dev, seed, logw=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (0.5 * torch.randn((B, T, H, N), generator=g, device=dev)
               for _ in range(3))
    lw = torch.clamp(-torch.exp(0.5 * torch.randn(
        (B, T, H, N), generator=g, device=dev)), -5.0, -1e-6)
    if logw is not None:
        lw.fill_(logw)
    u = 0.5 * torch.randn((H, N), generator=g, device=dev)
    return [t.to(dtype) for t in (r, k, v)] + [lw, u]


@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_kernel_matches_plain(dev, case, dtype):
    """Output and last state within 1e-4 of their largest magnitude (the
    reference test's bar): kernel and plain version read the same inputs
    and sum in fp32, the kernel with factored decays, the plain version
    with differences of cumulative decays."""
    *shape, C = case
    xs = _rwkv_inputs(*shape, getattr(torch, dtype), dev, seed=sum(case))
    before = rwkv6_wkv.launches
    out, s_last = rwkv6_wkv(*xs, chunk=C)
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches == before + 1
    want, want_s = rwkv6_wkv_plain(*xs, chunk=C)
    for got, w in ((out, want), (s_last, want_s)):
        assert got.dtype == torch.float32 and got.shape == w.shape
        err = (got - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (case, err)


def test_rwkv6_kernel_strong_decay(dev):
    """logw = -5 throughout, the model's clip floor, where the factored
    decay's exponent reaches 75: finite, and the plain version's result."""
    xs = _rwkv_inputs(2, 200, 4, 64, torch.float32, dev, seed=3, logw=-5.0)
    out, s_last = rwkv6_wkv(*xs, chunk=16)
    want, want_s = rwkv6_wkv_plain(*xs, chunk=16)
    assert torch.isfinite(out).all() and torch.isfinite(s_last).all()
    assert (out - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (s_last - want_s).abs().max().item() <= \
        1e-4 * want_s.abs().max().item()


def _rwkv_grads_against_plain(shape, dtype, dev, seed):
    """The Function's gradients (kernel forward, the chunk-parallel form
    recomputed for the backward) and autograd's of the plain version (a
    loop over chunks, decays from differences of log decays) on the same
    inputs and dout."""
    xs = _rwkv_inputs(*shape, dtype, dev, seed=seed)
    dout = torch.randn(shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(7))
    grads = []
    for fn in (rwkv6_wkv, rwkv6_wkv_plain):
        leaves = [t.clone().requires_grad_(True) for t in xs]
        grads.append(torch.autograd.grad(fn(*leaves, chunk=16)[0], leaves,
                                         dout))
    return zip(*grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_gradients_through_wrapper(dev, dtype):
    """The Function's gradients against autograd of the plain version,
    within 1e-4 of each gradient's largest magnitude (fp32), one bf16 ulp
    (bf16: the gradients of r, k, v round to it)."""
    tol = 1e-4 if dtype == "float32" else 2 ** -7
    for a, b in _rwkv_grads_against_plain((2, 70, 4, 32),
                                          getattr(torch, dtype), dev, 5):
        assert a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * b.float().abs().max().item()


def test_rwkv6_gradients_many_chunks(dev):
    """As above at 64 chunks and the full model's head width: the
    backward's two-level state carry at 8 groups of 8 chunks."""
    for a, b in _rwkv_grads_against_plain((1, 1024, 4, 160), torch.float32,
                                          dev, 8):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item()


def test_rwkv6_wrapper_raises_on_what_kernel_does_not_take(dev):
    r, k, v, lw, u = _rwkv_inputs(1, 32, 2, 16, torch.float32, dev, seed=0)
    with pytest.raises(ValueError, match="chunk"):
        rwkv6_wkv(r, k, v, lw, u, chunk=32)
    with pytest.raises(TypeError, match="float32"):
        rwkv6_wkv(r, k, v, lw.to(torch.bfloat16), u)
    with pytest.raises(TypeError, match="dtype"):
        rwkv6_wkv(r, k.to(torch.bfloat16), v, lw, u)
    with pytest.raises(ValueError, match="shape"):
        rwkv6_wkv(r, k, v[:, :8], lw, u)
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_wkv(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, lw,
                  u)
    with pytest.raises(ValueError, match="one device"):
        rwkv6_wkv(r, k, v, lw, u.cpu())
    big = _rwkv_inputs(1, 4, 1, 264, torch.float32, dev, seed=1)
    with pytest.raises(ValueError, match="N <= 256"):
        rwkv6_wkv(*big)


@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma2_27b",
                                  "recurrentgemma_9b", "rwkv6_3b"])
def test_loss_and_grads_on_card_match_cpu(dev, arch):
    """The smoke configs' loss and gradients in f32: the card (K3, K5,
    K4) against the CPU (the reference's routes, plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    params = init_params(model_spec(cfg), torch.Generator().manual_seed(0),
                         "cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    out = {}
    for where in ("cpu", dev):
        leaves = {p: t.to(where).requires_grad_(True)
                  for p, t in tree_paths(params)}
        loss = loss_fn(cfg, unflatten(leaves),
                       {k: v.to(where) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out[str(where)] = (loss.item(), [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    assert lg == pytest.approx(lc, rel=1e-5)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max().item() <= 1e-3 * b.abs().max().item()
