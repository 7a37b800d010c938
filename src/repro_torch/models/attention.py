"""Memory-efficient attention (flash-style online softmax) in plain
PyTorch; mirrors ``src/repro/models/attention.py``.

``chunked_attention`` is the CPU route of the training forward's attention
for ``attn_impl="chunked"`` and for ``"auto"`` above 2048 tokens: the
reference's algorithm and chunking (query chunks, each walking only the KV
chunks it can see, online softmax in fp32), so the port's CPU forward
matches the reference's at any length. ``reference_attention`` is the
naive full-matrix oracle.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def _chunk_logits(q, k, softcap):
    """q: (B,qc,H,D); k: (B,kc,H,D) -> fp32 (B,H,qc,kc)."""
    D = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(D)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def _mask(q0, k0, qc, kc, *, causal, window, prefix_len, kv_len=None,
          device=None):
    qpos = q0 + torch.arange(qc, device=device)[:, None]
    kpos = k0 + torch.arange(kc, device=device)[None, :]
    m = torch.ones((qc, kc), dtype=torch.bool, device=device)
    if causal:
        m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    if prefix_len:
        m = m | (kpos < prefix_len)
    if kv_len is not None:
        m = m & (kpos < kv_len)         # mask padded KV positions
    return m


def _expand_kv(k, n_rep: int):
    """GQA: (B,S,KV,D) -> (B,S,H,D) by repeating each KV head."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _attend_chunk(state, q, k_chunk, v_chunk, mask, softcap):
    """Online-softmax accumulation of one KV chunk.
    state: (m (B,H,qc), l (B,H,qc), acc (B,H,qc,D))."""
    m_prev, l_prev, acc = state
    logits = _chunk_logits(q, k_chunk, softcap)               # (B,H,qc,kc)
    logits = torch.where(mask[None, None], logits, _NEG_INF)
    m_cur = logits.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    # guard fully-masked rows (m_new == -inf)
    safe_m = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
    p = torch.exp(logits - safe_m[..., None])
    p = torch.where(mask[None, None], p, 0.0)
    alpha = torch.where(m_prev <= _NEG_INF / 2, 0.0,
                        torch.exp(m_prev - safe_m))
    l_new = alpha * l_prev + p.sum(dim=-1)
    acc = alpha[..., None] * acc + torch.einsum(
        "bhqk,bkhd->bhqd", p, v_chunk.float())
    return m_new, l_new, acc


def _finalize(state, dtype):
    _, l, acc = state
    out = acc / l.clamp_min(1e-30)[..., None]                # (B,H,qc,D)
    return out.transpose(1, 2).to(dtype)                      # (B,qc,H,D)


def _init_state(B, H, qc, D, device):
    return (torch.full((B, H, qc), _NEG_INF, device=device),
            torch.zeros((B, H, qc), device=device),
            torch.zeros((B, H, qc, D), device=device))


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      prefix_len: int = 0,
                      q_chunk: int = 2048, kv_chunk: int = 2048,
                      exact_causal: bool = True,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Skv,KV,D) with H % KV == 0. Self-attention
    layout (Sq == Skv, same positions), or with ``q_offset`` the queries
    at rows ``[q_offset, q_offset + Sq)`` of the keys (one model rank's
    query slice under context parallelism; the masks read the absolute
    row). Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    n_rep = H // KV
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    # pad to chunk multiples; padded KV columns are masked, padded query
    # rows are sliced off the output
    Sq_p = -(-Sq // qc) * qc
    Skv_p = -(-Skv // kc) * kc
    if Sq_p != Sq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    if Skv_p != Skv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
    nq, nk = Sq_p // qc, Skv_p // kc
    kv_len = Skv if Skv_p != Skv else None

    outs = []
    for i in range(nq):
        qi = q[:, i * qc:(i + 1) * qc]
        q0 = q_offset + i * qc
        prefix_hi = -(-prefix_len // kc) if prefix_len else 0
        if causal and window is not None:
            # banded: only chunks intersecting [q0 - window + 1, q0 + qc)
            j_lo = max(0, (q0 - window + 1) // kc)
            j_hi = min(nk, max((q0 + qc + kc - 1) // kc, prefix_hi))
            if prefix_len:
                j_lo = 0                      # prefix chunks always visible
        elif causal and exact_causal:
            j_lo = 0
            j_hi = min(nk, max((q0 + qc + kc - 1) // kc, prefix_hi))
        else:
            j_lo, j_hi = 0, nk
        state = _init_state(B, H, qc, D, q.device)
        for j in range(j_lo, j_hi):
            k0 = j * kc
            k_chunk = _expand_kv(k[:, k0:k0 + kc], n_rep)
            v_chunk = _expand_kv(v[:, k0:k0 + kc], n_rep)
            mask = _mask(q0, k0, qc, kc, causal=causal, window=window,
                         prefix_len=prefix_len, kv_len=kv_len,
                         device=q.device)
            state = _attend_chunk(state, qi, k_chunk, v_chunk, mask,
                                  softcap)
        outs.append(_finalize(state, q.dtype))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :Sq] if Sq_p != Sq else out


def reference_attention(q, k, v, *, causal=True, window=None, softcap=None,
                        prefix_len: int = 0) -> torch.Tensor:
    """Naive full-matrix oracle (fp32) — small shapes only."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    ke = _expand_kv(k, H // KV)
    ve = _expand_kv(v, H // KV)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          ke.float()) / math.sqrt(D)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _mask(0, 0, Sq, k.shape[1], causal=causal, window=window,
                 prefix_len=prefix_len, device=q.device)
    logits = torch.where(mask[None, None], logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, ve.float())
    return out.to(q.dtype)
