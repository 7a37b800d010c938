"""Shared layers: norms, RoPE, embeddings, the decode modes of the
attention layer and the MLP; mirrors ``src/repro/models/layers.py``. Plain
functions over param dicts of tensors; fp32 where numerics demand it
(norms, softmax, rope), the model dtype elsewhere.

Every mode of the reference's ``attention``: training/prefill (no cache:
the flash-attention kernel on CUDA, ``_sdpa`` or ``chunked_attention`` on
CPU), causal, bidirectional (an encoder) or with an image prefix; the
decode modes: paged (chunk written into pool rows, attention out of the
pool, optionally head-sharded over a ``KVShardCtx``), on a (B, S) grid
or on packed token rows (``PackedRows``: each row written at its own
slot's pool row, the queries scattered into K1's tile and back), and the
gather plane's per-slot and bulk modes over contiguous caches; and
cross-attention over an encoder's precomputed keys and values
(``cross_kv_spec``, ``make_cross_kv``).

The mesh path (a ``MeshContext`` with a ``DeviceMesh``): parameters and
activations are DTensors, and the reference's constraints sit at the same
places as ``redistribute`` calls — ``gather_seq`` on entry to attention
and the MLP, ``_tp_qkv_constraints`` on q/k/v (heads over model, or the
context-parallel fallback), the MLP intermediate over ``ff``, and the
vocab-parallel logits. The q/k/v projections and the unembedding are
DTensor products. What DTensor cannot propagate runs on each rank's local
shards under ``local_map``, with the placements set just before it: the
embedding lookup (``_mesh_embed``), the MLP (``_mesh_mlp``), and RoPE, the
attention kernels and the output projection (``_mesh_attention``,
``_mesh_decode_attention``, which merges a sequence-sharded cache's
partial attentions across ranks).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import (decode_attention, decode_attention_plain,
                       flash_attention, merge_partials,
                       paged_attention_plain, paged_decode_attention)
from ..sharding import all_max, reduce_from_group
from .attention import chunked_attention
from .common import ModelConfig, p

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int):
    return {"scale": p((dim,), ("embed",), init="zeros")}  # (1+scale) param.


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


def layernorm_spec(dim: int):
    return {"scale": p((dim,), ("embed",), init="ones"),
            "bias": p((dim,), ("embed",), init="zeros")}


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def norm_spec(cfg: ModelConfig, dim: Optional[int] = None):
    dim = dim or cfg.d_model
    return layernorm_spec(dim) if cfg.norm == "layernorm" else rmsnorm_spec(dim)


def norm(cfg: ModelConfig, params, x):
    return layernorm(params, x) if cfg.norm == "layernorm" else rmsnorm(params, x)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S). Half-split
    rotation with ``freq = theta^(-i/half)``, in fp32."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None, None].float() * freq   # (...,S,1,half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_spec(cfg: ModelConfig) -> Dict:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_head
    spec = {
        "wq": p((d, H, Dh), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": p((d, KV, Dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": p((d, KV, Dh), ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": p((H, Dh, d), ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        spec["bq"] = p((H, Dh), ("heads", "head_dim"), init="zeros")
        spec["bk"] = p((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = p((KV, Dh), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _qkv(cfg: ModelConfig, params, xq, xkv):
    q = torch.einsum("bsd,dhk->bshk", xq, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _sdpa(cfg: ModelConfig, q, k, v, mask):
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D); mask: (B|1, 1, Sq, Skv) bool.
    Dense fp32 masked softmax; the probabilities are cast to v's dtype
    before PV, as the reference does."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(D)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def causal_mask(Sq: int, Skv: int, q_offset=0, window: Optional[int] = None,
                device=None):
    """(1,1,Sq,Skv) bool. ``q_offset``: absolute position of query 0.
    ``window``: sliding window (local attention)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None]


def _use_chunked(cfg: ModelConfig, Sq: int) -> bool:
    if cfg.attn_impl == "chunked":
        return True
    if cfg.attn_impl == "xla":
        return False
    return Sq > 2048  # auto: full logits past 2k are prohibitive


def _self_attention(cfg: ModelConfig, q, k, v, *, window, bidirectional,
                    prefix_len, q_offset: Optional[int] = None):
    """Training/prefill attention of (B,S,H,D) queries against the same
    positions' (B,S,KV,D) keys and values: causal with an optional
    ``window`` and a ``prefix_len`` every query sees, or
    ``bidirectional``. ``attn_impl="auto"`` on CUDA tensors takes the
    flash-attention kernel, which raises on what it does not take;
    otherwise the reference's rule: ``_sdpa`` with a dense mask, or
    ``chunked_attention``. ``q_offset``: the queries are rows
    ``[q_offset, q_offset + Sq)`` of the keys (context parallelism)."""
    Sq, Skv = q.shape[1], k.shape[1]
    if cfg.attn_impl == "auto" and q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=not bidirectional,
                               window=window, softcap=cfg.attn_logit_softcap,
                               prefix_len=prefix_len, q_offset=q_offset)
    if _use_chunked(cfg, Skv):
        return chunked_attention(
            q, k, v, causal=not bidirectional, window=window,
            softcap=cfg.attn_logit_softcap, prefix_len=prefix_len,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
            exact_causal=cfg.exact_causal, q_offset=q_offset or 0)
    if bidirectional:
        mask = torch.ones((1, 1, Sq, Skv), dtype=torch.bool,
                          device=q.device)
    else:
        qpos = (q_offset or 0) + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        m = kpos <= qpos
        if window is not None:
            m &= kpos > qpos - window
        if prefix_len:
            m |= kpos < prefix_len
        mask = m[None, None]
    return _sdpa(cfg, q, k, v, mask)


def _paged_attention(cfg: ModelConfig, q, k_pages, v_pages, tables, qpos):
    """Attention for a (B,Sq,H,D) query chunk straight out of KV pool
    pages (num_blocks, bt, KV, D); block ``i`` of ``tables[b]`` backs
    logical positions [i*bt, (i+1)*bt) and query token (b, j) attends
    positions <= qpos[b, j]. ``decode_kernel="xla"`` takes the plain
    version; "flash" and "auto" take the wrapper, which launches the CUDA
    kernel on CUDA tensors and the plain version on CPU tensors."""
    if cfg.decode_kernel == "xla":
        return paged_attention_plain(q, k_pages, v_pages, tables, qpos,
                                     cfg.attn_logit_softcap)
    return paged_decode_attention(q, k_pages, v_pages, tables, qpos,
                                  softcap=cfg.attn_logit_softcap)


def _paged_write_attend(cfg: ModelConfig, q, k, v, kp, vp, tables, lens,
                        cache_pos):
    """Zero-copy paged data plane: write the chunk's k/v into the pool
    rows the block table names, attend straight out of the pool. Unlike
    the reference, which returns new pages, the pool pages ``kp``/``vp``
    are updated IN PLACE (``index_put_``). Returns (out, kp, vp)."""
    B, Sq = q.shape[:2]
    bt = kp.shape[-3]
    steps = torch.arange(Sq, dtype=torch.int32, device=q.device)
    tpos = cache_pos[:, None].int() + steps[None, :]               # (B,Sq)
    blk = torch.clamp(tpos // bt, max=tables.shape[1] - 1)
    rows = torch.gather(tables, 1, blk.long())
    # right-padded (and inactive-slot) tokens land in pool row 0, the
    # engine's reserved junk row — real rows only ever see writes of real
    # tokens
    rows = torch.where(steps[None, :] < lens[:, None], rows, 0)
    widx = (rows.reshape(-1).long(), (tpos % bt).reshape(-1).long())
    kp.index_put_(widx, k.reshape((B * Sq,) + k.shape[2:]).to(kp.dtype))
    vp.index_put_(widx, v.reshape((B * Sq,) + v.shape[2:]).to(vp.dtype))
    out = _paged_attention(cfg, q, kp, vp, tables, tpos)
    return out, kp, vp


def _paged_write_attend_tp(cfg: ModelConfig, kv_shard, q, k, v, kp, vp,
                           tables, lens, cache_pos):
    """Tensor-parallel paged write+attend on one rank of ``kv_shard``: the
    rank's contiguous slice of the query heads and of the chunk's k/v
    heads (under GQA packing an H/tp query slice owns exactly its KV
    slice's head groups) go through ``_paged_write_attend`` against the
    rank's head-sliced pool pages, and the outputs are all-gathered over
    heads, so the (replicated) ``wo`` projection runs on the full head
    set in single-device order on every rank: the tokens are those of
    tp=1 (a sum of partial ``wo`` products would change the order). The
    kernel takes contiguous inputs, so the query slice is a copy. The
    collective runs at tp=1 too."""
    hq, hkv = kv_shard.heads(q.shape[2]), kv_shard.heads(k.shape[2])
    out, kp, vp = _paged_write_attend(cfg, q[:, :, hq].contiguous(),
                                      k[:, :, hkv], v[:, :, hkv], kp, vp,
                                      tables, lens, cache_pos)
    return kv_shard.gather_heads(out), kp, vp


class PackedRows(NamedTuple):
    """Where each of a packed paged step's T token rows belongs
    (``lm.lm_packed_step``): ``pos`` (T,) its absolute position; ``write``
    (pool row, offset), each (T,), where its K/V goes: ``tables[slot, pos
    // bt]`` and ``pos % bt``, a padding row's the junk row 0 at offset 0;
    ``tile`` (T,) its place in the flattened (B, S) query tile that K1
    takes (a padding row's: B * S, one past the tile) and ``back`` (T,)
    the tile entry it reads its output from (a padding row's: 0); ``qpos``
    (B, S) int32 the tile's positions (0 where no row lands); ``tables``
    (B, NW) int32; ``last`` (B,) each slot's last real row. With S = 1,
    row b is slot b and the rows are the tile."""
    pos: torch.Tensor
    write: Tuple[torch.Tensor, torch.Tensor]
    tile: torch.Tensor
    back: torch.Tensor
    qpos: torch.Tensor
    tables: torch.Tensor
    last: torch.Tensor


def _packed_write_attend(cfg: ModelConfig, q, k, v, kp, vp,
                         rows: PackedRows):
    """The paged plane on packed rows: q (1, T, H, D), k and v (1, T, KV,
    D) of T token rows, each of its own slot and position. Each row's K/V
    is written IN PLACE into the pool pages ``kp``/``vp`` at
    ``rows.write``; the queries are scattered into the (B, S, H, D) tile of
    ``_paged_attention`` and its outputs gathered back to the rows. Returns
    (1, T, H, D)."""
    T, H, D = q.shape[1:]
    kp.index_put_(rows.write, k[0].to(kp.dtype))
    vp.index_put_(rows.write, v[0].to(vp.dtype))
    B, S = rows.qpos.shape
    if S == 1:
        return _paged_attention(cfg, q.reshape(B, 1, H, D), kp, vp,
                                rows.tables, rows.qpos).reshape(1, T, H, D)
    tile = q.new_zeros((B * S + 1, H, D))
    tile[rows.tile] = q[0]
    out = _paged_attention(cfg, tile[:-1].view(B, S, H, D), kp, vp,
                           rows.tables, rows.qpos)
    return out.reshape(B * S, H, D)[rows.back][None]


def _packed_write_attend_tp(cfg: ModelConfig, kv_shard, q, k, v, kp, vp,
                            rows: PackedRows):
    """``_packed_write_attend`` on one rank of ``kv_shard``: the rank's
    head slices, as ``_paged_write_attend_tp`` takes them, and the outputs
    all-gathered over heads."""
    hq, hkv = kv_shard.heads(q.shape[2]), kv_shard.heads(k.shape[2])
    out = _packed_write_attend(cfg, q[:, :, hq].contiguous(), k[:, :, hkv],
                               v[:, :, hkv], kp, vp, rows)
    return kv_shard.gather_heads(out)


def _write_per_slot(cache, tpos, val) -> None:
    """``cache[b, tpos[b, j]] = val[b, j]`` in place, for a (B, S, KV, D)
    cache and (B, Sq) positions. A position past the cache's end is
    dropped, as the reference's scatter drops it, and without a host sync:
    such a write is aimed at the last slot carrying the value that slot
    ends up holding anyway (the chunk's own write there, else its old
    contents), so the duplicate indices all agree."""
    B, Sq = tpos.shape
    last = cache.shape[1] - 1
    rows = torch.arange(B, device=cache.device)
    j = (last - tpos[:, 0]).clamp(0, Sq - 1).long()
    ends_there = tpos[rows, j] == last
    final = torch.where(ends_there[:, None, None], val[rows, j],
                        cache[rows, last])
    val = torch.where((tpos > last)[:, :, None, None], final[:, None], val)
    cache.index_put_((rows[:, None].expand(B, Sq),
                      tpos.clamp(max=last).long()), val)


def _write_bulk(cache, start, val) -> None:
    """``cache[:, start:start+Sq] = val`` in place, with the start clamped
    so the chunk fits, as the reference's ``dynamic_update_slice`` clamps
    it."""
    Sq = val.shape[1]
    s0 = min(max(int(start), 0), cache.shape[1] - Sq)
    cache[:, s0:s0 + Sq] = val


def _cross_attention(cfg: ModelConfig, q, k, v):
    """(B,Sq,H,D) queries against an encoder's (B,Skv,KV,D) keys and
    values, every key visible, no RoPE. A chunk (Sq > 1) takes the
    flash-attention kernel on CUDA tensors under ``attn_impl="auto"``; a
    one-token decode takes ``decode_attention`` (the kernel on CUDA
    tensors, its plain version on CPU tensors) with every row's valid
    length the encoder's, unless ``decode_kernel="xla"``; the rest
    ``_sdpa`` with the all-true mask, as the reference does."""
    B, Sq = q.shape[:2]
    Skv = k.shape[1]
    if Sq > 1 and cfg.attn_impl == "auto" and q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=False,
                               softcap=cfg.attn_logit_softcap)
    if Sq == 1 and cfg.decode_kernel != "xla":
        valid = torch.full((B,), Skv, dtype=torch.int32, device=q.device)
        return decode_attention(q[:, 0].contiguous(), k.contiguous(),
                                v.contiguous(), valid,
                                softcap=cfg.attn_logit_softcap)[:, None]
    mask = torch.ones((1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    return _sdpa(cfg, q, k, v, mask)


def _tp_qkv_constraints(mesh_ctx, q, k, v):
    """Inside the TP region: heads over model, batch over data. When the
    head count does not divide the model axis (qwen2: 28H, whisper: 8H on
    TP=16), fall back to CONTEXT parallelism for long inputs: queries
    sharded over model along the sequence (each rank attends its query
    slice against replicated KV) — otherwise a 32k prefill keeps full
    (B, S, H, D) projections replicated on every chip."""
    dp, mdl = mesh_ctx.data_axes, mesh_ctx.model_axis
    tp = mesh_ctx.tp_size
    H = q.shape[2]
    if H % max(tp, 1) == 0 or tp <= 1:
        q = mesh_ctx.constrain_dims(q, (dp, None, mdl, None))
        k = mesh_ctx.constrain_dims(k, (dp, None, mdl, None))
        v = mesh_ctx.constrain_dims(v, (dp, None, mdl, None))
    elif q.shape[1] > 1 and q.shape[1] % tp == 0:
        q = mesh_ctx.constrain_dims(q, (dp, mdl, None, None))
        k = mesh_ctx.constrain_dims(k, (dp, None, None, None))
        v = mesh_ctx.constrain_dims(v, (dp, None, None, None))
    return q, k, v


def _local_kv_heads(mesh_ctx, q_pl, k_pl, H: int, KV: int, kl, vl):
    """The K/V heads that this rank's query heads read. When the queries
    are sharded over heads and K/V are not (few KV heads), the local
    queries ``[r·H/tp, (r+1)·H/tp)`` read KV heads ``h // (H/KV)``: a
    contiguous slice when the local heads hold whole groups, else one KV
    head a query head."""
    m = mesh_ctx.model_dim()
    if not isinstance(q_pl[m], Shard) or q_pl[m].dim != 2 \
            or isinstance(k_pl[m], Shard):
        return kl, vl
    tp, G = mesh_ctx.tp_size, H // KV
    h0, n = mesh_ctx.model_rank() * (H // tp), H // tp
    if n % G == 0:
        sl = slice(h0 // G, (h0 + n) // G)
        return kl[:, :, sl], vl[:, :, sl]
    idx = torch.arange(h0, h0 + n, device=kl.device) // G
    return kl[:, :, idx], vl[:, :, idx]


def _partial_where_split(pl, split):
    """``pl`` with ``Partial()`` on the mesh dims where ``split`` shards
    and ``pl`` replicates: the gradient layout of an input every rank of
    those dims holds whole but uses for its own share of the work (each
    rank's gradient is a part of the sum)."""
    return tuple(Partial() if isinstance(a, Replicate)
                 and isinstance(b, Shard) else a for a, b in zip(pl, split))


def _out_placements(mesh_ctx, q_pl):
    """The layout of the output projection of attention outputs laid out
    as q (``q_pl``): rows as q's, and a partial sum over model where the
    heads are sharded there."""
    m = mesh_ctx.model_dim()
    out = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else
           Replicate() for pl in q_pl]
    if isinstance(q_pl[m], Shard):
        # heads sharded: a partial sum (over one rank, where the model
        # axis has size 1 and the rules leave wo whole)
        out[m] = Shard(1) if q_pl[m].dim == 1 else Partial()
    return out


def _mesh_attention(cfg: ModelConfig, mesh_ctx, q, k, v, wo, *, positions,
                    window, bidirectional, prefix_len, cross=False):
    """RoPE, the training/prefill attention and the output projection on
    each rank's shards (``local_map`` with q/k/v's placements as
    ``_tp_qkv_constraints`` set them). Queries sharded over the sequence
    (the context-parallel fallback) are rows ``[r·S/tp, (r+1)·S/tp)`` on
    model rank r: RoPE takes their positions and the attention their
    ``q_offset``, and the projected rows stay sequence-sharded. Queries
    sharded over heads give a partial sum over model. ``cross``: queries
    against an encoder's keys and values (``_cross_attention``: no RoPE,
    every key visible)."""
    H, KV = q.shape[2], k.shape[2]
    q_pl, k_pl, v_pl = (tuple(t.placements) for t in (q, k, v))
    wo_pl = tuple(wo.placements)
    m = mesh_ctx.model_dim()
    cp = isinstance(q_pl[m], Shard) and q_pl[m].dim == 1

    def body(ql, kl, vl, wol):
        kl, vl = _local_kv_heads(mesh_ctx, q_pl, k_pl, H, KV, kl, vl)
        if cross:
            out = _cross_attention(cfg, ql, kl, vl)
            return torch.einsum("bshk,hkd->bsd", out, wol)
        off = mesh_ctx.model_rank() * ql.shape[1] if cp else None
        rows = slice(off or 0, (off or 0) + ql.shape[1])
        ql = rope(ql, positions[:, rows], cfg.rope_theta)
        kl = rope(kl, positions, cfg.rope_theta)
        out = _self_attention(cfg, ql, kl, vl, window=window,
                              bidirectional=bidirectional,
                              prefix_len=prefix_len, q_offset=off)
        return torch.einsum("bshk,hkd->bsd", out, wol)

    return local_map(body,
                     out_placements=_out_placements(mesh_ctx, q_pl),
                     in_placements=(q_pl, k_pl, v_pl, wo_pl),
                     in_grad_placements=(
                         q_pl, _partial_where_split(k_pl, q_pl),
                         _partial_where_split(v_pl, q_pl),
                         _partial_where_split(wo_pl, q_pl)),
                     device_mesh=mesh_ctx.mesh,
                     redistribute_inputs=True)(q, k, v, wo)


def _global_offset(t, dim: int) -> int:
    """The global index of this rank's first element of DTensor ``t``
    along ``dim``, which its placements split evenly: in mesh order, each
    mesh dim that shards ``dim`` splits the previous one's chunk."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    size, off = t.shape[dim], 0
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size //= mesh.size(i)
            off += coord[i] * size
    return off


def _merge_over_groups(groups, out, lse):
    """``merge_partials`` of this rank's (out, lse) with those of the other
    ranks of each group in ``groups`` (one mesh dim's group each): the
    max and the two sums all-reduced over each in turn."""
    def reduce_max(t):
        for g in groups:
            t = all_max(t, g)
        return t

    def reduce_sum(t):
        for g in groups:
            t = reduce_from_group(t, g)
        return t

    return merge_partials(out, lse, reduce_max, reduce_sum)[0]


def _mesh_decode_attention(cfg: ModelConfig, mesh_ctx, q, k, v, wo, cache,
                           cache_pos, cache_valid_len, positions):
    """A bulk decode step's attention on each rank's shards (``local_map``
    with the placements set just before it): the token's RoPE, its write
    into the rank's shard of the cache, in place, the attention over that
    shard (``decode_attention``, the K2 kernel on CUDA) and the output
    projection. With ``k is None`` a cross-attention of the token over an
    encoder's cached keys and values (``cache``; no RoPE, no write, every
    key valid).

    The cache shards batch over data and KV heads over model, or keeps
    the heads whole and shards its sequence (few KV heads; the data axes
    a small batch leaves over): each rank then holds slots ``[s0, s0 +
    S_local)``, attends them with the valid length clipped to its slice
    (0 where the row sees none of it), and the token is written by the
    rank whose slice holds its slot. The ranks' partial attentions, each
    with K2's log-sum-exp, merge over the mesh dims that shard the
    sequence (``merge_partials``: a max and two sums all-reduced), after
    which every rank of those dims holds the attention over the whole
    cache. Queries sharded over heads on such a dim are gathered first;
    the output then meets ``wo``'s head shard as a partial sum over
    model."""
    ck_t, cv_t = cache["k"], cache["v"]
    c_pl = tuple(ck_t.placements)
    seq_dims = [i for i, pl in enumerate(c_pl)
                if isinstance(pl, Shard) and pl.dim == 1]
    # q and the new token's k/v: laid out as the cache, the sequence's
    # dims replicated (the token is every slice's query); heads as the
    # cache's where it shards them
    whole_seq = tuple(Replicate() if i in seq_dims else pl
                      for i, pl in enumerate(c_pl))
    q_pl = tuple(Replicate() if i in seq_dims else
                 c_pl[i] if isinstance(c_pl[i], Shard) else pl
                 for i, pl in enumerate(q.placements))
    q = mesh_ctx._redistribute(q, q_pl)
    cross = k is None
    args = [q, wo, ck_t, cv_t]
    if not cross:
        args += [mesh_ctx._redistribute(k, whole_seq),
                 mesh_ctx._redistribute(v, whole_seq)]
    wo_pl = tuple(wo.placements)
    m = mesh_ctx.model_dim()
    out_pl = [Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else
              Replicate() for pl in q_pl]
    out_pl[m] = Partial() if isinstance(wo_pl[m], Shard) else Replicate()
    S, H, KV = ck_t.shape[1], q.shape[2], ck_t.shape[2]
    s0 = _global_offset(ck_t, 1) if seq_dims else 0
    groups = [mesh_ctx.mesh.get_group(i) for i in seq_dims]
    if cross:
        base = S
    else:
        base = cache_pos + 1 if cache_valid_len is None else cache_valid_len
    attend = (decode_attention_plain if cfg.decode_kernel == "xla"
              else decode_attention)

    def body(ql, wol, ck, cv, kl=None, vl=None):
        B, n = ql.shape[0], ck.shape[1]
        if not cross:
            ql = rope(ql, positions, cfg.rope_theta)
            kl = rope(kl, positions, cfg.rope_theta)
            # the reference's update slice, its start clamped into the
            # whole cache, lands on the rank whose slice holds its slot
            slot = min(max(int(cache_pos), 0), S - 1) - s0
            if 0 <= slot < n:
                ck[:, slot:slot + 1] = kl.to(ck.dtype)
                cv[:, slot:slot + 1] = vl.to(cv.dtype)
        valid = torch.full((B,), min(max(int(base) - s0, 0), n),
                           dtype=torch.int32, device=ql.device)
        kh, vh = _local_kv_heads(mesh_ctx, q_pl, c_pl, H, KV, ck, cv)
        qa = ql[:, 0].contiguous()
        if groups:
            out, lse = attend(qa, kh.contiguous(), vh.contiguous(), valid,
                              softcap=cfg.attn_logit_softcap,
                              return_lse=True)
            out = _merge_over_groups(groups, out, lse)
        else:
            out = attend(qa, kh.contiguous(), vh.contiguous(), valid,
                         softcap=cfg.attn_logit_softcap)
        out = out[:, None]
        if wol.shape[0] != out.shape[2]:
            # every head's output against wo's head shard
            h0 = mesh_ctx.model_rank() * wol.shape[0]
            out = out[:, :, h0:h0 + wol.shape[0]]
        return torch.einsum("bshk,hkd->bsd", out, wol)

    return local_map(body, out_placements=out_pl,
                     in_placements=tuple(tuple(a.placements) for a in args),
                     device_mesh=mesh_ctx.mesh,
                     redistribute_inputs=True)(*args)


def attention(cfg: ModelConfig, params, x, *, positions, window=None,
              cache: Optional[Dict] = None, cache_pos=None,
              cache_valid_len=None, paged: Optional[Dict] = None,
              packed: Optional[PackedRows] = None,
              cross_kv=None, bidirectional: bool = False,
              prefix_len: int = 0, kv_shard=None, mesh_ctx=None):
    """Attention layer (proj → rope → attend → proj). Returns (out, cache).

    With a mesh (``mesh_ctx``; DTensor params and ``x``): ``gather_seq``
    on entry, q/k/v laid out by ``_tp_qkv_constraints``, then RoPE and
    the attention on each rank's shards: ``_mesh_attention`` without a
    cache (and for a cross-attention chunk), ``_mesh_decode_attention``
    for a bulk decode step into a DTensor cache, or a one-token
    cross-attention over cached encoder keys, whose sequence may be
    sharded (the ranks' partial attentions then merge through K2's
    log-sum-exp), each with the output projection: a partial sum over
    model where heads are sharded.

      * training/prefill: ``cache=None``; causal (or bidirectional)
        self-attention over the chunk with an optional sliding ``window``
        and image prefix of ``prefix_len`` positions, routed by
        ``_self_attention``. Returns (out, None).
      * cross: ``cross_kv`` = (k, v), an encoder's (B, Skv, KV, D) keys
        and values from ``make_cross_kv``; no RoPE, every key visible,
        routed by ``_cross_attention``. Returns (out, cache) with the
        ``cache`` given, untouched.

    The decode modes write the caches IN PLACE (the reference returns new
    ones):

      * paged: ``cache`` = {"k","v"} per-layer KV *pool* views
        (num_blocks, bt, KV, D) and ``paged`` = {"tables": (B, NW) pool
        rows in chain order, "seq_lens": (B,) real tokens per row}.
        Absolute positions only (G layers). With ``kv_shard`` (serve
        tensor parallelism) the pages hold this rank's KV heads and the
        attention runs ``_paged_write_attend_tp``.
      * packed: ``cache`` the pool views as paged, ``x`` (1, T, d) the
        packed rows of ``lm_packed_step`` and ``packed`` their
        ``PackedRows``: ``_packed_write_attend`` (or its ``_tp`` form).
      * gather: ``cache`` = {"k","v"} (B, S_cache, KV, D); the chunk is
        written at slot ``cache_pos`` — (B,) per slot (continuous
        batching) or one shared scalar (bulk) — and query token j attends
        the first ``cache_valid_len + j`` slots (``cache_pos + 1 + j`` by
        default). Rolling (L) caches pass ``pos % window`` and
        ``min(pos + 1, window)``: the whole wrapped buffer is live and
        slot order is irrelevant.

    A one-token decode attends through ``decode_attention`` (the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors), or with
    ``decode_kernel == "xla"`` through the plain version itself, as the
    paged mode does; a longer chunk through ``_sdpa``. (The reference's
    "xla" route is ``_sdpa``, which casts the probabilities to v's dtype:
    in bf16 it parts from the kernel there.)"""
    B, Sq = x.shape[:2]
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        assert paged is None and kv_shard is None, \
            "the mesh path has no paged plane"
        x = mesh_ctx.gather_seq(x)     # SP all-gather on TP-region entry
        if cross_kv is not None:
            q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
            if cfg.qkv_bias:
                q = q + params["bq"]
            if Sq == 1:
                # a decode step over the cached encoder keys, laid out as
                # the cache is
                return _mesh_decode_attention(
                    cfg, mesh_ctx, q, None, None, params["wo"],
                    {"k": cross_kv[0], "v": cross_kv[1]}, None, None,
                    positions), cache
            q, k, v = _tp_qkv_constraints(mesh_ctx, q, *cross_kv)
            return _mesh_attention(cfg, mesh_ctx, q, k, v, params["wo"],
                                   positions=positions, window=None,
                                   bidirectional=True, prefix_len=0,
                                   cross=True), cache
        q, k, v = _tp_qkv_constraints(mesh_ctx, *_qkv(cfg, params, x, x))
        if cache is None:
            return _mesh_attention(cfg, mesh_ctx, q, k, v, params["wo"],
                                   positions=positions, window=window,
                                   bidirectional=bidirectional,
                                   prefix_len=prefix_len), None
        return _mesh_decode_attention(cfg, mesh_ctx, q, k, v, params["wo"],
                                      cache, cache_pos, cache_valid_len,
                                      positions), cache
    if cross_kv is not None:
        q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
        if cfg.qkv_bias:
            q = q + params["bq"]
        out = _cross_attention(cfg, q, *cross_kv)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache
    q, k, v = _qkv(cfg, params, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = _self_attention(cfg, q, k, v, window=window,
                              bidirectional=bidirectional,
                              prefix_len=prefix_len)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), None
    if packed is not None:
        fn = (partial(_packed_write_attend_tp, cfg, kv_shard)
              if kv_shard is not None else partial(_packed_write_attend, cfg))
        out = fn(q, k, v, cache["k"], cache["v"], packed)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache
    if paged is not None:
        fn = (partial(_paged_write_attend_tp, cfg, kv_shard)
              if kv_shard is not None else partial(_paged_write_attend, cfg))
        out, ck, cv = fn(q, k, v, cache["k"], cache["v"], paged["tables"],
                         paged["seq_lens"], cache_pos)
        return (torch.einsum("bshk,hkd->bsd", out, params["wo"]),
                {"k": ck, "v": cv})
    ck, cv = cache["k"], cache["v"]
    base = cache_pos + 1 if cache_valid_len is None else cache_valid_len
    if isinstance(cache_pos, torch.Tensor) and cache_pos.ndim == 1:
        # per-slot positions: each slot writes its chunk at its own offset
        tpos = (cache_pos[:, None].int()
                + torch.arange(Sq, dtype=torch.int32,
                               device=x.device)[None, :])           # (B,Sq)
        _write_per_slot(ck, tpos, k.to(ck.dtype))
        _write_per_slot(cv, tpos, v.to(cv.dtype))
        valid = base.int()
    else:
        # bulk decode: one shared position
        _write_bulk(ck, cache_pos, k.to(ck.dtype))
        _write_bulk(cv, cache_pos, v.to(cv.dtype))
        valid = torch.full((B,), int(base), dtype=torch.int32,
                           device=x.device)
    if Sq == 1:
        attend = (decode_attention_plain if cfg.decode_kernel == "xla"
                  else decode_attention)
        out = attend(q[:, 0], ck, cv, valid,
                     softcap=cfg.attn_logit_softcap)[:, None]
    else:
        # query token j sees j more slots than the chunk's first
        seen = valid[:, None] + torch.arange(Sq, device=x.device)[None, :]
        kpos = torch.arange(ck.shape[1], device=x.device)
        mask = (kpos[None, None, :] < seen[:, :, None])[:, None]
        out = _sdpa(cfg, q, ck, cv, mask)
    return (torch.einsum("bshk,hkd->bsd", out, params["wo"]),
            {"k": ck, "v": cv})


def cross_kv_spec(cfg: ModelConfig):
    """Encoder-side projections for cross attention (computed once)."""
    return {
        "wk": p((cfg.d_model, cfg.kv_heads, cfg.d_head),
                ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": p((cfg.d_model, cfg.kv_heads, cfg.d_head),
                ("embed", "kv_heads", "head_dim"), init="scaled"),
    }


def make_cross_kv(params, enc_out):
    """(k, v), each (B, T, KV, D), of an encoder output (B, T, d_model)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"])
    return k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {"wi": p((d, 2, f), ("embed", None, "ff"), init="scaled"),
                "wo": p((f, d), ("ff", "embed"), init="scaled")}
    return {"wi": p((d, 1, f), ("embed", None, "ff"), init="scaled"),
            "wo": p((f, d), ("ff", "embed"), init="scaled")}


def mlp(cfg: ModelConfig, params, x, mesh_ctx=None):
    """The dense MLP. With a mesh: ``gather_seq`` on entry and the
    Megatron layout on each rank's shards (``local_map``): ``wi`` and
    ``wo`` sharded over model along ``ff`` (their ``fsdp=False`` layout),
    so the intermediate is too (the reference's constraint on it) and the
    second product is a partial sum over model that the residual add
    reduce-scatters back into the sequence-parallel layout. (Left to
    DTensor, ``einsum`` would flatten ``(2, ff)`` with ``ff`` sharded, a
    layout its fake-tensor dry run cannot take.)"""
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        return _mesh_mlp(cfg, mesh_ctx, params, x)
    h = torch.einsum("bsd,dcf->bscf", x, params["wi"])
    if cfg.act == "swiglu":
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    elif cfg.act == "geglu":
        h = F.gelu(h[..., 0, :], approximate="tanh") * h[..., 1, :]
    else:
        h = F.gelu(h[..., 0, :], approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["wo"])


def _mesh_mlp(cfg: ModelConfig, mesh_ctx, params, x):
    x = mesh_ctx.gather_seq(x)         # SP all-gather on TP-region entry
    wi, wo = params["wi"], params["wo"]
    x_pl, wi_pl, wo_pl = (tuple(t.placements) for t in (x, wi, wo))
    m = mesh_ctx.model_dim()
    out_pl = list(x_pl)
    if isinstance(wi_pl[m], Shard):
        out_pl[m] = Partial()

    def body(xl, wil, wol):
        return mlp(cfg, {"wi": wil, "wo": wol}, xl)

    return local_map(body, out_placements=out_pl,
                     in_placements=(x_pl, wi_pl, wo_pl),
                     in_grad_placements=(
                         _partial_where_split(x_pl, wi_pl),
                         _partial_where_split(wi_pl, x_pl),
                         _partial_where_split(wo_pl, x_pl)),
                     device_mesh=mesh_ctx.mesh,
                     redistribute_inputs=True)(x, wi, wo)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig) -> Dict:
    spec = {"tok": p((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        spec["unembed"] = p((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return spec


def embed(cfg: ModelConfig, params, tokens, mesh_ctx=None):
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        return _mesh_embed(cfg, mesh_ctx, params["tok"], tokens)
    h = params["tok"].to(cfg.dtype)[tokens.long()]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def _mesh_embed(cfg: ModelConfig, mesh_ctx, tok, tokens):
    """The vocab-parallel lookup on each rank's shards: the table gathered
    over the FSDP axes (its ``fsdp=False`` layout, vocab over model where
    it divides), the tokens batch over data and whole over model; each
    model rank looks up the rows of its vocab slice and zeros the rest,
    so the output is a partial sum over model (whole where the vocab is
    not sharded), which ``shard_activations`` reduce-scatters."""
    tok = mesh_ctx.constrain_tree(tok, embed_spec(cfg)["tok"], fsdp=False)
    t_pl = mesh_ctx.placements(mesh_ctx.dims_pspec(
        tokens.shape, (mesh_ctx.data_axes, None)))
    m = mesh_ctx.model_dim()
    sharded = isinstance(tok.placements[m], Shard)
    out_pl = list(t_pl)
    out_pl[m] = Partial() if sharded else Replicate()
    scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))

    def body(tl, ids):
        ids = ids.long()
        if sharded:
            v0 = mesh_ctx.model_rank() * tl.shape[0]
            ids = ids - v0
            hit = (ids >= 0) & (ids < tl.shape[0])
            h = tl.to(cfg.dtype)[torch.where(hit, ids, 0)]
            h = torch.where(hit[..., None], h, 0)
        else:
            h = tl.to(cfg.dtype)[ids]
        return h * scale if cfg.embed_scale else h

    tok_pl = tuple(tok.placements)
    return local_map(body, out_placements=out_pl,
                     in_placements=(tok_pl, t_pl),
                     in_grad_placements=(_partial_where_split(tok_pl, t_pl),
                                         t_pl),
                     device_mesh=mesh_ctx.mesh,
                     redistribute_inputs=True)(tok, tokens)


def unembed(cfg: ModelConfig, params, h, mesh_ctx=None):
    """Logits of h. With a mesh: the (tied or own) unembedding in its
    ``fsdp=False`` layout against the sequence-gathered h, the logits
    vocab-parallel (vocab over model)."""
    if mesh_ctx is not None:
        h = mesh_ctx.gather_seq(h)
        spec = embed_spec(cfg)
        name = "tok" if cfg.tie_embeddings else "unembed"
        params = {name: mesh_ctx.constrain_tree(
            params[name], spec[name], fsdp=False)}
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["tok"])
    else:
        logits = torch.einsum("bsd,dv->bsv", h, params["unembed"])
    if mesh_ctx is not None:
        # vocab-parallel logits: the unembedding stays sharded over model;
        # the loss reduces over the vocab shards
        logits = mesh_ctx.constrain_dims(
            logits, (mesh_ctx.data_axes, None, mesh_ctx.model_axis))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.float() / c)).to(logits.dtype)
    return logits
