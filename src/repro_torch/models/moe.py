"""Mixture-of-Experts layer; mirrors ``src/repro/models/moe.py``.

The reference has two execution paths with identical math. The port has
the single-device one, ``_moe_local``: dense compute of every expert on
every token and an exact top-k combine (no capacity drops), plain PyTorch
matrix products, as the reference computes them outside any kernel. The
expert-parallel path (experts sharded over a mesh axis, the reference's
``_moe_ep_device``) belongs with serve tensor parallelism and is not
ported: a mesh raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import ModelConfig, p


def moe_spec(cfg: ModelConfig) -> Dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    nc = 2 if cfg.act in ("swiglu", "geglu") else 1
    spec = {
        "router": p((d, E), ("embed", "experts"), init="scaled"),
        "wi": p((E, d, nc, f), ("experts", "embed", None, "ff"), init="scaled"),
        "wo": p((E, f, d), ("experts", "ff", "embed"), init="scaled"),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        spec["shared_wi"] = p((d, nc, fs), ("embed", None, "ff"), init="scaled")
        spec["shared_wo"] = p((fs, d), ("ff", "embed"), init="scaled")
    return spec


def _act(cfg: ModelConfig, h):
    # h: (..., nc, f)
    if cfg.act == "swiglu":
        return F.silu(h[..., 0, :]) * h[..., 1, :]
    if cfg.act == "geglu":
        return F.gelu(h[..., 0, :], approximate="tanh") * h[..., 1, :]
    return F.gelu(h[..., 0, :], approximate="tanh")


def _route(cfg: ModelConfig, router_w, x_flat):
    """(T,d) -> (T,k) weights and (T,k) expert ids; softmax→top-k→renorm.
    The top k come from a stable descending sort, so equal probabilities
    rank the lower expert index first, as ``jax.lax.top_k`` ranks them
    (``torch.topk`` promises no order among equal values)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :cfg.top_k], topi[:, :cfg.top_k]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    return topw, topi


def _shared(cfg: ModelConfig, params, x_flat):
    h = torch.einsum("td,dcf->tcf", x_flat, params["shared_wi"])
    return torch.einsum("tf,fd->td", _act(cfg, h), params["shared_wo"])


def _moe_local(cfg: ModelConfig, params, x_flat):
    """Exact dense reference: every expert on every token, masked combine.
    The expert products run expert-major, (E,T,...), so each reads its
    stacked weights in place."""
    E = cfg.n_experts
    T, d = x_flat.shape
    topw, topi = _route(cfg, params["router"], x_flat)
    wi = params["wi"]                                        # (E,d,nc,f)
    h = torch.matmul(x_flat, wi.reshape(E, d, -1))           # all experts
    h = h.reshape(E, T, wi.shape[2], wi.shape[3])
    y = torch.bmm(_act(cfg, h), params["wo"])                # (E,T,d)
    experts = torch.arange(E, device=x_flat.device)
    onehot = (topi[..., None] == experts).to(x_flat.dtype)   # (T,k,E)
    w = torch.einsum("tk,tke->te", topw.to(x_flat.dtype), onehot)
    out = torch.einsum("etd,te->td", y, w)
    if cfg.n_shared_experts:
        out = out + _shared(cfg, params, x_flat)
    return out


def moe(cfg: ModelConfig, params, x, mesh_ctx=None):
    """x: (B, S, d) -> (B, S, d)."""
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh belongs with serve tensor "
            "parallelism, which is not ported: only the single-device "
            "_moe_local runs")
    B, S, d = x.shape
    return _moe_local(cfg, params, x.reshape(-1, d)).reshape(B, S, d)
