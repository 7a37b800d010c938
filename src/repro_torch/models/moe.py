"""Mixture-of-Experts layer; mirrors ``src/repro/models/moe.py``.

Two execution paths, as in the reference, both plain PyTorch matrix
products (the reference computes them outside any kernel):

* ``_moe_local`` — without a mesh: dense compute of every expert on every
  token and an exact top-k combine (no capacity drops).
* ``_moe_ep_device`` — with a mesh, at every model-axis size (ep=1
  included), as the reference takes its EP branch whenever a mesh is
  given: experts sharded over the model axis, tokens whole on every model
  rank; each rank gathers the tokens routed to *its* experts into
  fixed-capacity buffers (capacity-factor dropping, Switch-style), runs
  the grouped products, scatters back, and one all-reduce over the model
  group combines the partial outputs (the reference's ``psum``). ``moe``
  runs it on each rank's shards under ``local_map``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..sharding import copy_to_group, reduce_from_group
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


def _expert_compute(cfg: ModelConfig, wi, wo, gathered):
    """gathered: (E_loc, C, d) -> (E_loc, C, d)."""
    h = torch.einsum("ecd,ednf->ecnf", gathered, wi)
    return torch.einsum("ecf,efd->ecd", _act(cfg, h), wo)


def _moe_ep_device(cfg: ModelConfig, group, params, x_flat,
                   dropped: Optional[List[torch.Tensor]] = None):
    """One rank's expert-parallel MoE, line for line the reference's
    per-device body. x_flat: (T, d), whole on every rank of ``group`` (the
    model axis' process group; None: one rank holding every expert);
    ``params``: the router whole, ``wi``/``wo`` this rank's slice of the
    experts, ``shared_wi``/``shared_wo`` its slice of the shared expert's
    ``ff``. Capacity ``C = max(1, ceil(T·k·capacity_factor/E))`` slots an
    expert, filled in token order; an assignment past them is dropped
    (the overflow row). Returns the (T, d) sum over the group. With
    ``dropped``, appends the count of this rank's assignments that
    capacity dropped (a 0-d tensor)."""
    E = cfg.n_experts
    E_loc = params["wi"].shape[0]
    rank = 0 if group is None else dist.get_rank(group)
    T, d = x_flat.shape
    k = cfg.top_k
    C = max(1, math.ceil(T * k * cfg.capacity_factor / E))
    # every rank uses the whole tokens and router for its own experts:
    # their gradients sum over the group
    x_flat = copy_to_group(x_flat, group)
    router = copy_to_group(params["router"], group)

    topw, topi = _route(cfg, router, x_flat)                 # (T,k)
    flat_e = topi.reshape(-1)                                # (T*k,)
    flat_w = topw.reshape(-1)
    tok_of = torch.arange(T, device=x_flat.device).repeat_interleave(k)

    my_first = rank * E_loc
    local = (flat_e >= my_first) & (flat_e < my_first + E_loc)
    eid = torch.where(local, flat_e - my_first, E_loc)      # E_loc = trash bin
    onehot = F.one_hot(eid, E_loc + 1)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1          # (T*k, E_loc+1)
    pos = pos.amax(dim=1)                                   # slot within expert
    keep = local & (pos < C) & (pos >= 0)
    slot = torch.where(keep, eid * C + pos, E_loc * C)      # overflow slot

    # scatter token indices / gates into capacity buffers (+1 overflow row)
    buf_tok = torch.zeros(E_loc * C + 1, dtype=torch.long,
                          device=x_flat.device).scatter(0, slot, tok_of)
    buf_gate = torch.zeros(E_loc * C + 1, dtype=flat_w.dtype,
                           device=x_flat.device).scatter(
        0, slot, torch.where(keep, flat_w, 0.0))
    buf_tok, buf_gate = buf_tok[:-1], buf_gate[:-1]

    gathered = x_flat[buf_tok].reshape(E_loc, C, d)
    y = _expert_compute(cfg, params["wi"], params["wo"], gathered)
    y = y.reshape(E_loc * C, d) * buf_gate[:, None].to(y.dtype)

    # scatter back: each (token, choice) reads its slot's output (the
    # overflow row reads zeros) and a token sums its k in choice order —
    # the reference's scatter-add, in an order fixed on every device
    y_ext = torch.cat([y, y.new_zeros((1, d))])
    out = y_ext[slot].reshape(T, k, d).sum(dim=1)
    if cfg.n_shared_experts:
        # shared expert ff is sharded over the model axis (TP): partial sums
        out = out + _shared(cfg, params, x_flat)
    if dropped is not None:
        dropped.append((local & ~keep).sum().detach())
    return reduce_from_group(out, group)


# the dropped-assignment counts of each ``_moe_ep_device`` call while a
# list is set here (one 0-d tensor a call, this rank's experts only)
DROP_LOG: Optional[List[torch.Tensor]] = None


def moe(cfg: ModelConfig, params, x, mesh_ctx=None):
    """x: (B, S, d) -> (B, S, d). Without a mesh ``_moe_local``. With one
    (DTensor params and x) ``_moe_ep_device`` on each rank's shards under
    ``local_map``, with the reference's ``in_specs``: x batch over the
    data axes and whole over model; ``wi``/``wo`` sharded over model on
    the expert dim; ``shared_wi``/``shared_wo`` over model on ``ff``; the
    router whole. The output is laid out as x."""
    B, S, d = x.shape
    if mesh_ctx is None or mesh_ctx.mesh is None:
        return _moe_local(cfg, params, x.reshape(-1, d)).reshape(B, S, d)
    mc = mesh_ctx

    def pl(spec):
        return tuple(mc.placements(spec))

    x_pl = pl(mc.dims_pspec(x.shape, (mc.data_axes,)))
    if mc.tp_size > 1:
        for name, dim in (("wi", 0), ("shared_wi", 2)):
            if name in params and params[name].shape[dim] % mc.tp_size:
                raise ValueError(
                    f"{name} dim {dim} ({params[name].shape[dim]}) does not "
                    f"divide over the {mc.tp_size} model ranks")
    mdl = mc.model_axis
    specs = {"router": (), "wi": (mdl,), "wo": (mdl,)}
    if cfg.n_shared_experts:
        specs.update(shared_wi=(None, None, mdl), shared_wo=(mdl,))
    keys = sorted(specs)
    in_pl = (x_pl,) + tuple(pl(specs[k]) for k in keys)
    group = mc.model_group()

    def body(xb, *prm):
        Bl, Sl, _ = xb.shape
        out = _moe_ep_device(cfg, group, dict(zip(keys, prm)),
                             xb.reshape(Bl * Sl, d), DROP_LOG)
        return out.reshape(Bl, Sl, d)

    # every data rank's weights see only its own rows: their gradients
    # are partial sums over the data axes (the model axis' sum of x's and
    # the router's is inside the body)
    grad_pl = (x_pl,) + tuple(tuple(Partial() if isinstance(a, Replicate)
                                    and isinstance(b, Shard) else a
                                    for a, b in zip(pl, x_pl))
                              for pl in in_pl[1:])
    return local_map(body, out_placements=list(x_pl), in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mc.mesh,
                     redistribute_inputs=True)(x, *(params[k] for k in keys))
