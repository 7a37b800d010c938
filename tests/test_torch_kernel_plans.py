"""What the kernels' wrappers decide on the host, checked on the CPU:
paged attention's and flash-decoding's split plans (each covers the key
range exactly, depends on shapes alone and, for flash-decoding, plans no
more than one wave of blocks), the split-and-merge algebra both kernels
run (each split's softmax state from the plain version's scores, merged as
the kernel merges them, equals the plain version), the RWKV6 WKV kernel's
two passes (the per-chunk pass, then the state pass over column slices,
give the plain version's output and last state), the dtype and shape
dispatch of the attention wrappers, the RG-LRU scan's launch plan (every
channel and step covered once, every SM given a block, shapes alone), and
the kernel build's hash over the sources and the headers they include."""
import importlib
import inspect
import math
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_wkv_plain  # noqa: E402

# the module, which the package's function of the same name shadows
da_mod = importlib.import_module("repro_torch.kernels.decode_attention")
rg_mod = importlib.import_module("repro_torch.kernels.rglru_scan")
from repro_torch.kernels.flash_attention import flash_design  # noqa: E402

DESIGNS = ("simt", "mma16", "mma64")

# (B, S, G, KV, bt, NW, n_sm): the serve path's decode and prefill shapes,
# a long table, a wide batch that needs no split, odd block sizes, one
# sequence of one KV head, and a table past the longest split
PLAN_SHAPES = [
    (8, 1, 7, 4, 16, 64, 132),
    (8, 64, 7, 4, 16, 40, 132),
    (8, 1, 28, 4, 16, 256, 132),
    (256, 1, 8, 8, 16, 64, 132),
    (3, 5, 7, 1, 5, 7, 132),
    (1, 1, 1, 1, 1, 1, 132),
    (2, 9, 2, 2, 16, 5, 20),
    (1, 1, 8, 1, 16, 2000, 132),
]


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_covers_the_table_exactly(design, shape):
    """n ranges of per keys cover [0, NW*bt), none of them empty; per is a
    whole number of the design's steps and at most the longest split."""
    B, S, G, KV, bt, NW, n_sm = shape
    n, per = pa.split_plan(design, B, S, G, KV, bt, NW, n_sm)
    step = pa._SPLIT_SHAPE[design][2]
    n_keys = NW * bt
    assert n >= 1 and per >= 1
    assert n * per >= n_keys > (n - 1) * per
    assert per % step == 0
    assert per <= pa._MAX_SPLIT_KEYS


def test_plan_depends_on_shapes_alone(monkeypatch):
    """The cached plan takes integers and a dtype, never a tensor, so the
    wrapper never reads qpos (or anything else) back from the card; equal
    shapes give the one cached plan."""
    params = inspect.signature(pa._plan.__wrapped__).parameters
    assert {p.annotation for p in params.values()} <= {"int",
                                                       "torch.dtype"}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(
                            multi_processor_count=132))
    pa._plan.cache_clear()
    try:
        for dtype, design in ((torch.bfloat16, "mma16"),
                              (torch.float32, "simt")):
            got = pa._plan(8, 1, 28, 4, 16, 64, dtype, 0)
            assert got == (pa._DESIGN_CODES[design],
                           *pa.split_plan(design, 8, 1, 7, 4, 16, 64, 132))
            assert pa._plan(8, 1, 28, 4, 16, 64, dtype, 0) == got
        assert pa._plan.cache_info().hits == 2
    finally:
        pa._plan.cache_clear()


@pytest.mark.parametrize("design,n_splits", [("mma16", 32),
                                              ("simt", 64)])
def test_long_narrow_case_plans_more_splits_than_merge_lanes(design,
                                                            n_splits):
    """The card cases' D=64 table of 4096 keys (B=2, G=8, one KV head) is
    split into more ranges than the merge pass has lanes on D (D/4 = 16),
    so the card tests reach the merge's lanes that hold no columns."""
    n, per = pa.split_plan(design, 2, 1, 8, 1, 16, 256, 132)
    assert n == n_splits and n > 64 // 4


@pytest.mark.parametrize("S,G,dtype,design", [
    (1, 7, torch.bfloat16, "mma16"),
    (2, 8, torch.bfloat16, "mma16"),
    (16, 1, torch.bfloat16, "mma16"),
    (17, 1, torch.bfloat16, "mma64"),
    (64, 7, torch.bfloat16, "mma64"),
    (1, 7, torch.float32, "simt"),
    (64, 7, torch.float32, "simt"),
])
def test_paged_design_follows_dtype_and_rows(S, G, dtype, design):
    assert pa.paged_design(S, G, dtype) == design


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "simt")])
def test_flash_design_follows_dtype(dtype, design):
    assert flash_design(dtype) == design


def _inputs(B, S, H, KV, D, bt, NW, seed):
    """Seeded f32 inputs with ragged positions: row 0 ends at the table's
    last key, row 1 starts at 0, the last row is an idle slot (all-zero
    table) and, with B >= 4, row 2 sees no key."""
    rng = np.random.default_rng(seed)
    NB = B * NW + 3
    q, kp, vp = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in [(B, S, H, D), (NB, bt, KV, D), (NB, bt, KV, D)])
    tables = rng.permutation(NB)[:B * NW].reshape(B, NW).astype(np.int32)
    pos0 = rng.integers(0, NW * bt - S + 1, B)
    qpos = (pos0[:, None] + np.arange(S)[None, :]).astype(np.int32)
    qpos[0] = NW * bt - S + np.arange(S)
    qpos[1] = np.arange(S)
    tables[-1] = 0
    qpos[-1] = np.arange(S)
    if B >= 4:
        qpos[2] = -1
    return [q, kp, vp, torch.from_numpy(tables), torch.from_numpy(qpos)]


def _split_and_merge(q, kp, vp, tables, qpos, n, per, softcap=None):
    """Paged attention the kernel's way: each of n ranges of per keys
    gives its softmax state (m, l, acc) over the keys of the range a row
    can see (m = NEG_INF, l = 0, acc = 0 where it sees none), and the merge
    weighs state j by exp(m_j - max m), 0 for a state that saw no key, and
    divides by the weighted sum of l (at least 1e-30)."""
    B, S, H, D = q.shape
    bt, KV = kp.shape[1], kp.shape[2]
    NW = tables.shape[1]
    G = H // KV
    L = NW * bt
    rows = tables.long()
    kc = kp[rows].reshape(B, L, KV, D)
    vc = vp[rows].reshape(B, L, KV, D)
    qg = q.reshape(B, S, KV, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(L)
    seen = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]
    states = []
    for j in range(n):
        inside = (kpos >= j * per) & (kpos < (j + 1) * per)
        mask = seen & inside
        sj = torch.where(mask, s, pa.NEG_INF)
        m = sj.amax(dim=-1)
        safe = torch.where(m <= pa.NEG_INF / 2, 0.0, m)
        p = torch.where(mask, torch.exp(sj - safe[..., None]), 0.0)
        states.append((m, p.sum(-1), torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                  vc)))
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    safe = torch.where(mx <= pa.NEG_INF / 2, 0.0, mx)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l_, a in states:
        w = torch.where(m <= pa.NEG_INF / 2, 0.0, torch.exp(m - safe))
        lsum = lsum + w * l_
        acc = acc + w[..., None] * a
    out = acc / lsum.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


# (B, S, H, KV, D, bt, NW, softcap): decode with G=7 over a long table, a
# chunk of G=1 rows, a softcap, odd block sizes and a short table
MERGE_CASES = [
    (8, 1, 28, 4, 16, 16, 64, None),
    (4, 17, 4, 4, 16, 16, 8, None),
    (4, 3, 8, 2, 32, 8, 16, 30.0),
    (4, 5, 7, 1, 8, 5, 7, None),
    (3, 1, 4, 2, 16, 4, 3, None),
]


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("case", MERGE_CASES)
def test_split_merge_algebra_matches_plain(design, case):
    """With each design's plan (at 132 SMs), the splits' merged states equal
    the plain version within 1e-6 in f32, empty splits, the row that sees
    no key (0) and the idle slot included."""
    *shape, softcap = case
    B, S, H, KV, D, bt, NW = shape
    args = _inputs(*shape, seed=sum(shape))
    n, per = pa.split_plan(design, B, S, H // KV, KV, bt, NW, 132)
    got = _split_and_merge(*args, n, per, softcap)
    want = pa.paged_attention_plain(*args, softcap)
    assert (got - want).abs().max().item() <= 1e-6
    if B >= 4:
        assert not got[2].any()


def test_split_merge_algebra_with_many_empty_splits():
    """One key a split: almost every split of a short row is empty."""
    args = _inputs(4, 2, 4, 2, 16, 4, 6, seed=5)
    got = _split_and_merge(*args, 24, 1)
    want = pa.paged_attention_plain(*args)
    assert (got - want).abs().max().item() <= 1e-6


# flash-decoding (B, S, H, KV, D, window, itemsize, blocks_per_sm, n_sm):
# the gather serve cell's S=128 and S=4096 in bf16 at 3 and 4 blocks an
# SM, a window of the cache's width, a narrow window, f32 at D=256, G=16
# in two row groups, a batch that fills the wave alone, one row of one
# head, and a small card
DECODE_PLAN_SHAPES = [
    (8, 128, 32, 16, 128, None, 2, 4, 132),
    (8, 4096, 32, 16, 128, None, 2, 4, 132),
    (8, 4096, 32, 16, 128, None, 2, 3, 132),
    (8, 4096, 32, 16, 128, 4096, 2, 4, 132),
    (3, 1000, 8, 4, 64, 300, 4, 4, 132),
    (2, 300, 4, 2, 256, None, 4, 2, 132),
    (2, 64, 32, 2, 64, 16, 2, 4, 132),
    (256, 2048, 8, 8, 128, None, 2, 4, 132),
    (1, 1, 1, 1, 8, None, 4, 4, 132),
    (2, 700, 4, 2, 64, None, 2, 3, 20),
]


def _decode_ranges(vl, S, window, n, per):
    """The key ranges the kernel's n splits of ``per`` keys walk for a row
    of valid length ``vl``: [lo, end) each, empty ones included."""
    start = max(0, vl - window) if window is not None else 0
    hi = min(vl, S)
    return [(start + j * per, min(hi, start + (j + 1) * per))
            for j in range(n)]


def _decode_plan(shape):
    B, S, H, KV, D, window, isz, occ, n_sm = shape
    n_keys = S if window is None else max(min(S, window), 1)
    return da_mod.split_plan(B, KV, H // KV, D, isz, n_keys, occ, n_sm)


@pytest.mark.parametrize("shape", DECODE_PLAN_SHAPES)
def test_decode_split_plan_covers_visible_keys_exactly(shape):
    """For every valid length, the splits' ranges are disjoint, in order,
    and their union is the row's visible keys; each split is a whole
    number of the ring's tiles and none is needless."""
    B, S, H, KV, D, window, isz, occ, n_sm = shape
    n, per = _decode_plan(shape)
    n_keys = S if window is None else max(min(S, window), 1)
    assert n >= 1 and per % da_mod.tile_keys(D, isz) == 0
    assert n * per >= n_keys > (n - 1) * per
    for vl in sorted({0, 1, S // 2, S - 1, S, S + 1, S + 404, 2 * S + 7}):
        start = max(0, vl - window) if window is not None else 0
        want = set(range(start, min(vl, S)))
        got = []
        for lo, end in _decode_ranges(vl, S, window, n, per):
            got.extend(range(lo, end))
        assert got == sorted(want), (vl, n, per)


@pytest.mark.parametrize("shape", DECODE_PLAN_SHAPES)
def test_decode_split_plan_fills_at_most_one_wave(shape):
    """Splits never plan more blocks than one wave holds at the given
    occupancy; only a single split may exceed it, when its blocks alone
    do."""
    B, S, H, KV, D, window, isz, occ, n_sm = shape
    n, _ = _decode_plan(shape)
    G = H // KV
    base = B * KV * -(-G // da_mod.heads_per_block(G, D))
    assert n * base <= max(occ * n_sm, base)
    if n > 1:
        assert n * base <= occ * n_sm


def test_decode_plan_depends_on_shapes_alone(monkeypatch):
    """The cached plan takes integers and a dtype, never a tensor, so the
    wrapper never reads valid_len back from the card; equal shapes give
    the one cached plan, whatever the valid lengths."""
    params = inspect.signature(da_mod._plan.__wrapped__).parameters
    assert {p.annotation for p in params.values()} <= {"int", "torch.dtype"}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(da_mod, "_blocks_per_sm",
                        lambda device, H, KV, D, code: 4)
    monkeypatch.setattr(da_mod, "_sm_counts", {})
    da_mod._plan.cache_clear()
    try:
        for dtype, isz in ((torch.bfloat16, 2), (torch.float32, 4)):
            got = da_mod._plan(8, 4096, 32, 16, 128, -1, dtype, 0)
            assert got == da_mod.split_plan(8, 16, 2, 128, isz, 4096, 4, 132)
            assert da_mod._plan(8, 4096, 32, 16, 128, -1, dtype, 0) == got
        assert da_mod._plan(8, 4096, 32, 16, 128, 300, torch.bfloat16,
                            0) == da_mod.split_plan(8, 16, 2, 128, 2, 300,
                                                    4, 132)
        assert da_mod._plan.cache_info().hits == 2
    finally:
        da_mod._plan.cache_clear()


def _decode_split_and_merge(q, k, v, valid, window, softcap, n, per):
    """Flash-decoding the kernel's way: each of n splits gives its softmax
    state (m, l, acc) over its range of the row's visible keys (m =
    NEG_INF, l = 0, acc = 0 where it sees none), and the merge weighs
    state j by exp(m_j - max m), 0 for a state that saw no key, and
    divides by the weighted sum of l (at least 1e-30)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bshd->bhgs", qg, k)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(S)
    states = []
    for j in range(n):
        inside = torch.zeros((B, S), dtype=torch.bool)
        for b in range(B):
            lo, end = _decode_ranges(int(valid[b]), S, window, n, per)[j]
            inside[b] = (kpos >= lo) & (kpos < end)
        mask = inside[:, None, None, :]
        sj = torch.where(mask, s, da_mod.NEG_INF)
        m = sj.amax(dim=-1)
        safe = torch.where(m <= da_mod.NEG_INF / 2, 0.0, m)
        p = torch.where(mask, torch.exp(sj - safe[..., None]), 0.0)
        states.append((m, p.sum(-1), torch.einsum("bhgs,bshd->bhgd", p, v)))
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    safe = torch.where(mx <= da_mod.NEG_INF / 2, 0.0, mx)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, l_, a in states:
        w = torch.where(m <= da_mod.NEG_INF / 2, 0.0, torch.exp(m - safe))
        lsum = lsum + w * l_
        acc = acc + w[..., None] * a
    return (acc / lsum.clamp_min(1e-30)[..., None]).reshape(B, H, D)


# (B, S, H, KV, D, window, softcap, valid, n_splits): the serve cell's
# ragged S=128 at its plan, the wrapped window (valid past S) with and
# without a window, rows that see nothing, G=8, and one tile a split, so
# that most splits of a short row are empty
DECODE_MERGE_CASES = [
    (8, 128, 32, 16, 32, None, 50.0, [80, 128, 1, 96, 33, 64, 127, 5], 2),
    (4, 256, 4, 2, 16, 200, None, [300, 256, 90, 0], 4),
    (3, 256, 4, 2, 16, None, 30.0, [400, 256, 0], 4),
    (2, 96, 16, 2, 8, None, None, [96, 40], 3),
    (3, 160, 4, 1, 16, 64, None, [160, 5, 0], 5),
]


@pytest.mark.parametrize("case", DECODE_MERGE_CASES)
def test_decode_split_merge_algebra_matches_plain(case):
    """The splits' merged states equal the plain version within 1e-6 in
    f32, empty splits and rows that see no key (0) included; the plan's
    tile-rounded split length, and splits of one 8-key tile."""
    B, S, H, KV, D, window, softcap, valid, n_splits = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in [(B, H, D), (B, S, KV, D), (B, S, KV, D)])
    valid = torch.tensor(valid, dtype=torch.int32)
    n_keys = S if window is None else max(min(S, window), 1)
    want = da_mod.decode_attention_plain(q, k, v, valid, window, softcap)
    for n, per in ((n_splits, -(-n_keys // n_splits)),
                   (-(-n_keys // 8), 8)):
        got = _decode_split_and_merge(q, k, v, valid, window, softcap, n,
                                      per)
        assert (got - want).abs().max().item() <= 1e-6
        for b, vl in enumerate(valid.tolist()):
            if vl == 0:
                assert not got[b].any()


def _wkv_two_pass(r, k, v, logw, u, chunk, cols):
    """The RWKV6 WKV the kernel's way, in plain PyTorch: the chunk pass
    takes, for every chunk at once, the factored-decay scores (the bonus on
    the diagonal) and the intra-chunk output, and the rows r e^lce,
    k e^(lc_last - lc) and e^lc_last; then the state pass carries each
    slice of ``cols`` state columns through the chunks in order, adding
    (r e^lce) S to the output before S <- e^lc_last S + k_out^T v."""
    B, T, H, N = r.shape
    C = min(chunk, T)
    nc = -(-T // C)
    pad = nc * C - T
    rf, kf, vf, lw = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                      .reshape(B, nc, C, H, N) for t in (r, k, v, logw))
    lc = torch.cumsum(lw, dim=2)
    lce = lc - lw
    a0 = lc[:, :, :1]
    scores = torch.einsum("bcthn,bcjhn->bchtj", rf * torch.exp(lce - a0),
                          kf * torch.exp(a0 - lc))
    strict = torch.ones((C, C), dtype=torch.bool).tril(-1)
    scores = torch.where(strict, scores, 0.0)
    bonus = torch.einsum("bcthn,bcthn->bcht", rf, u.float() * kf)
    scores = scores + torch.diag_embed(bonus)
    out = torch.einsum("bchtj,bcjhn->bcthn", scores, vf)
    ra = rf * torch.exp(lce)
    last = lc[:, :, -1:]
    ko = kf * torch.exp(last - lc)
    dec = torch.exp(last[:, :, 0])                      # (B, nc, H, N)
    s_last = torch.zeros((B, H, N, N))
    for m0 in range(0, N, cols):
        m1 = min(N, m0 + cols)
        S = torch.zeros((B, H, N, m1 - m0))
        for c in range(nc):
            out[:, c, :, :, m0:m1] += torch.einsum("bthn,bhnm->bthm",
                                                   ra[:, c], S)
            S = dec[:, c][..., None] * S + torch.einsum(
                "bthn,bthm->bhnm", ko[:, c], vf[:, c, :, :, m0:m1])
        s_last[..., m0:m1] = S
    return out.reshape(B, nc * C, H, N)[:, :T], s_last


# (B, T, H, N, chunk): ragged T at the kernel's chunk of 16 with N not a
# multiple of the 32-column slice, the cell's N=160 over 5 chunks, a short
# chunk, and T below one chunk
WKV_TWO_PASS_CASES = [(2, 37, 2, 20, 16), (1, 80, 2, 160, 16),
                      (2, 23, 3, 9, 5), (1, 7, 2, 33, 16)]


@pytest.mark.parametrize("case", WKV_TWO_PASS_CASES)
def test_wkv_two_pass_decomposition_matches_plain(case):
    """The chunk pass, then the state pass over 32-column slices (the
    kernel's), give the plain version's output and last state within 1e-5
    of their largest magnitude (both fp32)."""
    B, T, H, N, chunk = case
    rng = np.random.default_rng(sum(case))
    r, k, v = (torch.from_numpy(0.5 * rng.standard_normal((B, T, H, N))
                                .astype(np.float32)) for _ in range(3))
    logw = torch.from_numpy(np.clip(-np.exp(rng.standard_normal(
        (B, T, H, N))), -5.0, -1e-6).astype(np.float32))
    u = torch.from_numpy(0.5 * rng.standard_normal((H, N)).astype(
        np.float32))
    got, got_s = _wkv_two_pass(r, k, v, logw, u, chunk, 32)
    want, want_s = rwkv6_wkv_plain(r, k, v, logw, u, chunk=chunk)
    for g, w in ((got, want), (got_s, want_s)):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


# (B, T, W): the training cell and one 4096-token sequence, ragged W on
# both stripe widths (100, 66, 4100, 2110), short T, and wide batches
RGLRU_PLAN_SHAPES = [(2, 4096, 4096), (1, 4096, 4096), (1, 7, 100),
                     (3, 1, 66), (1, 33, 4100), (2, 2, 4100), (2, 17, 2110),
                     (64, 4096, 4096), (5, 300, 66), (1, 16, 1)]


@pytest.mark.parametrize("shape", RGLRU_PLAN_SHAPES)
def test_rglru_plan_covers_every_channel_and_step_once(shape):
    """The plan's blocks, each a stripe of ``channels`` channels of one
    row (the kernel's blockIdx: stripe fastest, then row), cover every
    (b, w) channel exactly once; the stages, walked forward from 0 and in
    reverse from T - 1 as the kernel walks them, cover every step once; a
    stage holds the kernel's 512 floats of each input."""
    B, T, W = shape
    plan = rg_mod.rglru_plan(B, T, W, 132)
    assert rg_mod.rglru_plan(B, T, W, 132, reverse=True)._replace(
        stages=plan.stages) == plan
    C, S = plan.channels, plan.steps
    assert C in (16, 32) and C * S == 512 == rg_mod._STAGE_FLOATS
    assert 2 <= plan.stages <= 8          # the kernel's ring: 2 to 8
    stripes = -(-W // C)
    assert plan.blocks == B * stripes
    seen = np.zeros((B, W), np.int64)
    for blk in range(plan.blocks):
        b, w0 = blk // stripes, (blk % stripes) * C
        seen[b, w0:min(W, w0 + C)] += 1
    assert (seen == 1).all()
    n_stages = -(-T // S)
    fwd = [k * S + u for k in range(n_stages) for u in range(S)
           if k * S + u < T]
    rev = [T - 1 - k * S - u for k in range(n_stages) for u in range(S)
           if T - 1 - k * S - u >= 0]
    assert fwd == list(range(T)) and rev == list(range(T - 1, -1, -1))


@pytest.mark.parametrize("B", [1, 2])
def test_rglru_plan_gives_every_sm_a_block(B):
    """At W=4096 (the cell, B=2, and one sequence, B=1) the plan fills all
    132 SMs of an H100: 256 stripes of 32 channels at B=2, of 16 at B=1,
    with the ring 6 stages deep forward and 3 in reverse."""
    for reverse, stages in ((False, 6), (True, 3)):
        plan = rg_mod.rglru_plan(B, 4096, 4096, 132, reverse)
        assert plan.blocks >= 132
        assert plan == rg_mod.RGLRUPlan(32 if B == 2 else 16, 16 if B == 2
                                        else 32, stages, 256)


def test_rglru_plan_depends_on_shapes_alone(monkeypatch):
    """The cached plan takes integers, never a tensor; the wrapper's call
    signature holds it per shape, so tensors of other values get the one
    plan without a new check or plan."""
    params = inspect.signature(rg_mod._plan.__wrapped__).parameters
    assert {p.annotation for p in params.values()} <= {"int", "bool"}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(rg_mod, "_sm_counts", {})
    monkeypatch.setattr(rg_mod, "_signatures", {})
    rg_mod._plan.cache_clear()
    try:
        a, b = torch.rand(1, 64, 4096), torch.randn(1, 64, 4096)
        got = rg_mod._signature(a=a, b=b)
        assert got[1] == rg_mod.rglru_plan(1, 64, 4096, 132)
        rev = rg_mod._signature(a=a, y=b, dy=b)
        assert rev[1] == rg_mod.rglru_plan(1, 64, 4096, 132, reverse=True)
        checks = []
        monkeypatch.setattr(rg_mod, "_check_cuda_args",
                            lambda **kw: checks.append(kw))
        a.fill_(float("nan"))
        b.zero_()
        assert rg_mod._signature(a=a, b=b) is got
        assert rg_mod._signature(a=torch.ones(1, 64, 4096),
                                 b=torch.ones(1, 64, 4096)) is got
        assert checks == [] and rg_mod._plan.cache_info().misses == 2
    finally:
        rg_mod._plan.cache_clear()


def _copy_csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    return csrc


def test_library_path_covers_every_header(tmp_path, monkeypatch):
    """An edited header under csrc/ gives every source a new library path,
    so no stale library is loaded from _build/."""
    csrc = _copy_csrc(tmp_path, monkeypatch)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    before = {n: build.library_path(n)
              for n in ("paged_attention", "flash_attention")}
    assert before == {n: build.library_path(n) for n in before}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)


def test_library_path_covers_the_source(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = build.library_path("paged_attention")
    other = build.library_path("flash_attention")
    src = csrc / "paged_attention.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("paged_attention") != before
    assert build.library_path("flash_attention") == other


def test_library_path_sees_a_new_header(tmp_path, monkeypatch):
    csrc = _copy_csrc(tmp_path, monkeypatch)
    before = build.library_path("flash_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_attention") != before
