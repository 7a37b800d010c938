"""What the attention kernels' wrappers decide on the host, checked on the
CPU: paged attention's split plan (it covers the block table's key range
exactly and depends on shapes alone), the split-and-merge algebra its
kernel runs (each split's softmax state from the plain version's scores,
merged as the kernel's merge pass does, equals the plain version), the
dtype and shape dispatch of both attention wrappers, and the kernel build's
hash over the sources and the headers they include."""
import inspect
import math
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
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
