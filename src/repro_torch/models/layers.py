"""Shared layers: norms, RoPE, embeddings, the paged attention layer and
the MLP; mirrors ``src/repro/models/layers.py``. Plain functions over
param dicts of tensors; fp32 where numerics demand it (norms, softmax,
rope), the model dtype elsewhere.

Ported so far: the dense layers and the paged decode mode of
``attention`` (chunk written into pool rows, attention out of the pool).
The gather-plane, training and cross-attention modes are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import paged_attention_plain, paged_decode_attention
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


def attention(cfg: ModelConfig, params, x, *, positions, cache: Dict,
              cache_pos, paged: Dict):
    """Attention layer (proj → rope → paged write+attend → proj) in the
    paged decode mode, the one mode ported: ``cache`` = {"k","v"} per-layer
    KV *pool* views (num_blocks, bt, KV, D), updated in place, and
    ``paged`` = {"tables": (B, NW) pool rows in chain order, "seq_lens":
    (B,) real tokens per row}. Absolute positions only (G layers).
    Returns (out, cache)."""
    q, k, v = _qkv(cfg, params, x, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out, ck, cv = _paged_write_attend(cfg, q, k, v, cache["k"], cache["v"],
                                      paged["tables"], paged["seq_lens"],
                                      cache_pos)
    return (torch.einsum("bshk,hkd->bsd", out, params["wo"]),
            {"k": ck, "v": cv})


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


def mlp(cfg: ModelConfig, params, x):
    h = torch.einsum("bsd,dcf->bscf", x, params["wi"])
    if cfg.act == "swiglu":
        h = F.silu(h[..., 0, :]) * h[..., 1, :]
    elif cfg.act == "geglu":
        h = F.gelu(h[..., 0, :], approximate="tanh") * h[..., 1, :]
    else:
        h = F.gelu(h[..., 0, :], approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg: ModelConfig) -> Dict:
    spec = {"tok": p((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        spec["unembed"] = p((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return spec


def embed(cfg: ModelConfig, params, tokens):
    h = params["tok"].to(cfg.dtype)[tokens.long()]
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def unembed(cfg: ModelConfig, params, h):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["tok"])
    else:
        logits = torch.einsum("bsd,dv->bsv", h, params["unembed"])
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = (c * torch.tanh(logits.float() / c)).to(logits.dtype)
    return logits
