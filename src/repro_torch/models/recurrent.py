"""Recurrent sequence mixers; mirrors ``src/repro/models/recurrent.py``.

The RG-LRU (Griffin/RecurrentGemma) block and RWKV6's time-mix and
channel-mix, each in two forms. The training and prefill form (no
``state``) runs the gate and projection products in plain PyTorch and the
recurrences through ``kernels.rglru_scan`` and ``kernels.rwkv6_wkv``
(each the CUDA kernel on CUDA tensors, its plain version on CPU tensors).
The decode form (``state=`` carried in) is the reference's one-token
update in plain PyTorch, as the reference computes it outside any Pallas
kernel: ``rglru_step`` and RWKV6's ``S = exp(logw)·S_prev + k vᵀ``, with
the recurrent state (``h``, ``S``) in fp32.

With a ``MeshContext`` over a ``DeviceMesh`` (the mesh path), each mixer
takes its input sequence-gathered (``gather_seq``) and runs, either form,
on each rank's shards (``_mesh_mixer``): the RG-LRU block over
the rank's slice of the lru width (whole gate blocks: the reference's
constraint of ``rec`` and ``gate`` over the model axis), the time mix
over its RWKV heads (``r, k, v, g``, the WKV and the per-head norm), the
channel mix over its slice of ``d_ff`` (``kx``); K5 and K4 then scan the
rank's channels or heads. Each output is a partial sum over the model
axis where the weights are sharded there; the state (``h``/``conv`` over
the width, ``S`` over heads, the shifts whole) comes back laid out as
``cache_pspec`` lays the decode cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import rglru_scan as _rglru_scan_kernel
from ..kernels import rwkv6_wkv as _rwkv6_wkv_kernel
from .common import ModelConfig, p
from .layers import _partial_where_split

# ---------------------------------------------------------------------------
# RG-LRU  (Griffin, arXiv:2402.19427, adapted per RecurrentGemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_NB = 16  # block-diagonal gate blocks (recurrentgemma: per-head)


def rglru_block_spec(cfg: ModelConfig) -> Dict:
    d, W = cfg.d_model, cfg.lru_width
    bs = W // _NB
    return {
        "w_x": p((d, W), ("embed", "rnn"), init="scaled"),
        "w_y": p((d, W), ("embed", "rnn"), init="scaled"),
        "conv_w": p((cfg.conv_width, W), (None, "rnn"), init="scaled"),
        "conv_b": p((W,), ("rnn",), init="zeros"),
        "gate_a": p((_NB, bs, bs), ("rnn_blocks", None, None), init="scaled"),
        "gate_x": p((_NB, bs, bs), ("rnn_blocks", None, None), init="scaled"),
        "lam": p((W,), ("rnn",), init="normal", scale=0.5),
        "w_out": p((W, d), ("rnn", "embed"), init="scaled"),
    }


def _blockdiag(x, w):
    """x: (..., W) @ block-diagonal w: (NB, bs, bs) -> (..., W). NB is w's
    own: on a mesh rank, the whole blocks of its slice of the width."""
    shape = x.shape
    xb = x.reshape(shape[:-1] + (w.shape[0], shape[-1] // w.shape[0]))
    yb = torch.einsum("...nb,nbc->...nc", xb, w)
    return yb.reshape(shape)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv over time. x: (B,S,W); w: (K,W). ``state``:
    (B,K-1,W) trailing context for decode (a zero context without it).
    Returns (y, the trailing K-1 steps of context). The taps are summed in
    the reference's order, in x's dtype."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[K - 1 - i] for i in range(K))
    return y + b, xp[:, -(K - 1):, :]


def _rglru_coeffs(params, x):
    """x: (B,S,W) fp32 -> (log_a, b_in) of the recurrence
    h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t)."""
    r = torch.sigmoid(_blockdiag(x, params["gate_a"].float()))
    i = torch.sigmoid(_blockdiag(x, params["gate_x"].float()))
    # a = sigmoid(lam)^(c*r)  ->  log a = -c * r * softplus(-lam)
    lam = params["lam"].float() + 2.0   # bias toward slow decay
    log_a = -_RGLRU_C * r * F.softplus(-lam)
    b_in = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i * x)
    return log_a, b_in


def rglru_scan(params, x):
    """Training/prefill path. x: (B,S,W) -> (B,S,W); returns (y, h_last).
    The coefficients in plain PyTorch, the recurrence through the kernel
    wrapper."""
    dt = x.dtype
    x = x.float()
    log_a, b_in = _rglru_coeffs(params, x)
    a = torch.exp(log_a)
    h, h_last = _rglru_scan_kernel(a.contiguous(), b_in.contiguous())
    return h.to(dt), h_last


def rglru_step(params, x, h_prev):
    """Decode: x (B,1,W), h_prev (B,W) -> (y (B,1,W), h (B,W) fp32)."""
    xf = x.float()
    log_a, b_in = _rglru_coeffs(params, xf)
    a = torch.exp(log_a)
    h = a[:, 0] * h_prev.float() + b_in[:, 0]
    return h[:, None, :].to(x.dtype), h


def _state_placements(mesh_ctx, x_pl, dim):
    """A state leaf's placements: batch over data as ``x_pl``'s rows, the
    model axis over ``dim`` (None: replicated)."""
    m = mesh_ctx.model_dim()
    pl = [Shard(0) if isinstance(p_, Shard) and p_.dim == 0 else Replicate()
          for p_ in x_pl]
    pl[m] = Replicate() if dim is None else Shard(dim)
    return pl


def _mesh_mixer(mesh_ctx, fn, params, x, state, state_dims, sharded):
    """``fn(params, x, state) -> (out, new_state)`` (a meshless mixer) on
    each rank's shards: ``x`` sequence-gathered, the params sharded over
    model where ``sharded`` (else gathered whole there), the state
    redistributed to its working layout (``state_dims``: its leaves' model
    dims when sharded). The output is a partial sum over model where
    sharded; the new state comes back in the working layout."""
    x = mesh_ctx.gather_seq(x)
    x_pl = tuple(x.placements)
    m = mesh_ctx.model_dim()
    names, args = list(params), []
    for t in params.values():
        if not sharded:
            pl = list(t.placements)
            pl[m] = Replicate()
            t = mesh_ctx._redistribute(t, pl)
        args.append(t)
    keys = list(state_dims)
    st_pl = {k: _state_placements(mesh_ctx, x_pl,
                                  state_dims[k] if sharded else None)
             for k in keys}
    if state is not None:
        args += [mesh_ctx._redistribute(state[k], st_pl[k]) for k in keys]
    out_pl = list(x_pl)
    out_pl[m] = Partial() if sharded else Replicate()
    n = len(names)

    def body(xl, *rest):
        prm = dict(zip(names, rest[:n]))
        st = None if state is None else dict(zip(keys, rest[n:]))
        out, new = fn(prm, xl, st)
        return (out,) + tuple(new[k] for k in keys)

    # the gradient of an input a mesh dim replicates while another input
    # shards it (each rank of that dim does a share of the work with it)
    # is a partial sum over that dim
    args = [x] + args
    pls = [tuple(a.placements) for a in args]
    split = [Shard(0) if any(isinstance(p_[i], Shard) for p_ in pls)
             else Replicate() for i in range(len(x_pl))]
    res = local_map(body,
                    out_placements=(out_pl,) + tuple(st_pl[k] for k in keys),
                    in_placements=tuple(pls),
                    in_grad_placements=tuple(_partial_where_split(p_, split)
                                             for p_ in pls),
                    device_mesh=mesh_ctx.mesh,
                    redistribute_inputs=True)(*args)
    return res[0], dict(zip(keys, res[1:]))


def rglru_block(cfg: ModelConfig, params, x, *, state: Optional[Dict] = None,
                mesh_ctx=None):
    """The Griffin recurrent block: in-proj → causal conv → RG-LRU, gated.
    x: (B,S,d). ``state`` = {"conv": (B,K-1,W), "h": (B,W)} for a one-token
    decode (``rglru_step``); without it the scan over S. Returns (out
    (B,S,d), new state: the conv context in x's dtype, ``h`` in fp32).
    ``mesh_ctx``: the mesh form (the module's docstring), over the rank's
    whole gate blocks; where the model axis does not divide the blocks,
    each rank computes the whole width."""
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        sharded = isinstance(
            params["gate_a"].placements[mesh_ctx.model_dim()], Shard)
        return _mesh_mixer(
            mesh_ctx, lambda prm, xl, st: rglru_block(cfg, prm, xl,
                                                      state=st),
            params, x, state, {"conv": 2, "h": 1}, sharded)
    rec = torch.einsum("bsd,dw->bsw", x, params["w_x"])
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["w_y"]),
                  approximate="tanh")
    rec, new_conv = _causal_conv(rec, params["conv_w"], params["conv_b"],
                                 None if state is None else state["conv"])
    if state is None:
        h, h_last = rglru_scan(params, rec)
    else:
        h, h_last = rglru_step(params, rec, state["h"])
    out = torch.einsum("bsw,wd->bsd", h * gate, params["w_out"])
    return out, {"conv": new_conv.to(x.dtype), "h": h_last}


def rglru_state_shape(cfg: ModelConfig, batch: int):
    W = cfg.lru_width
    return {"conv": (batch, cfg.conv_width - 1, W), "h": (batch, W)}


# ---------------------------------------------------------------------------
# RWKV6  (Finch, arXiv:2404.05892)
# ---------------------------------------------------------------------------

_RWKV_CHUNK = 16
_LOGW_MIN, _LOGW_MAX = -5.0, -1e-6
_LORA_DIM = 64


def rwkv_heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_heads, head_dim), sized to the reference's TP degree (16); the
    config's ``n_heads``/``d_head`` are not used."""
    H = 16 if cfg.d_model % 16 == 0 else 8
    return H, cfg.d_model // H


def rwkv_time_mix_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H, N = rwkv_heads(cfg)
    return {
        "mu_r": p((d,), ("embed",), init="zeros"),
        "mu_k": p((d,), ("embed",), init="zeros"),
        "mu_v": p((d,), ("embed",), init="zeros"),
        "mu_g": p((d,), ("embed",), init="zeros"),
        "mu_w": p((d,), ("embed",), init="zeros"),
        "wr": p((d, H, N), ("embed", "heads", "head_dim"), init="scaled"),
        "wk": p((d, H, N), ("embed", "heads", "head_dim"), init="scaled"),
        "wv": p((d, H, N), ("embed", "heads", "head_dim"), init="scaled"),
        "wg": p((d, H, N), ("embed", "heads", "head_dim"), init="scaled"),
        "w0": p((H, N), ("heads", "head_dim"), init="zeros"),
        "lora_wA": p((d, _LORA_DIM), ("embed", None), init="scaled"),
        "lora_wB": p((_LORA_DIM, H, N), (None, "heads", "head_dim"),
                     init="scaled"),
        "u": p((H, N), ("heads", "head_dim"), init="normal", scale=0.5),
        "ln_out": p((H, N), ("heads", "head_dim"), init="zeros"),
        "wo": p((H, N, d), ("heads", "head_dim", "embed"), init="scaled"),
    }


def _shift(x, state=None):
    """Token shift: x_{t-1}, zero before the first token, or the (B,d)
    carry-in ``state`` for decode."""
    if state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([state[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _rwkv_proj(cfg, params, x, xprev):
    def mix(mu):
        return x + (xprev - x) * mu.to(x.dtype)

    r = torch.einsum("bsd,dhn->bshn", mix(params["mu_r"]), params["wr"])
    k = torch.einsum("bsd,dhn->bshn", mix(params["mu_k"]), params["wk"])
    v = torch.einsum("bsd,dhn->bshn", mix(params["mu_v"]), params["wv"])
    g = torch.einsum("bsd,dhn->bshn", mix(params["mu_g"]), params["wg"])
    xw = mix(params["mu_w"]).float()
    lora = torch.einsum("bsl,lhn->bshn",
                        torch.tanh(xw @ params["lora_wA"].float()),
                        params["lora_wB"].float())
    logw = -torch.exp(params["w0"].float() + lora)
    logw = torch.clamp(logw, _LOGW_MIN, _LOGW_MAX)
    return r, k, v, g, logw


def _rwkv_out(cfg, params, wkv, g):
    """Per-head RMS-norm, gate, out-projection. wkv: (B,S,H,N)."""
    xf = wkv.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + 1e-6)
    xf = xf * (1.0 + params["ln_out"].float())
    out = xf.to(wkv.dtype) * F.silu(g)
    return torch.einsum("bshn,hnd->bsd", out, params["wo"])


def rwkv_time_mix(cfg: ModelConfig, params, x, *,
                  state: Optional[Dict] = None, mesh_ctx=None):
    """x: (B,S,d). state = {"shift": (B,d), "S": (B,H,N,N) fp32} for a
    single-token decode, the reference's one-step update in plain PyTorch;
    without it the training/prefill form, whose WKV goes through
    ``kernels.rwkv6_wkv`` in chunks of ``_RWKV_CHUNK`` (the CUDA kernel on
    CUDA tensors, its plain version on CPU tensors). Returns (out (B,S,d),
    {"shift": (B,d), "S": (B,H,N,N) fp32}). ``mesh_ctx``: the mesh form
    (the module's docstring), over the rank's heads; the shift whole on
    every model rank."""
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        sharded = isinstance(
            params["wr"].placements[mesh_ctx.model_dim()], Shard)
        return _mesh_mixer(
            mesh_ctx, lambda prm, xl, st: rwkv_time_mix(cfg, prm, xl,
                                                        state=st),
            params, x, state, {"shift": None, "S": 1}, sharded)
    xprev = _shift(x, None if state is None else state["shift"])
    r, k, v, g, logw = _rwkv_proj(cfg, params, x, xprev)
    u = params["u"].float()
    if state is not None:                      # single-token decode
        rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))
        S_prev = state["S"]                    # (B,H,N,N) fp32
        # out_t = r (S_prev + u ⊙ k v^T);  S = diag(w) S_prev + k v^T
        kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
        out = torch.einsum("bhn,bhnm->bhm", rf,
                           S_prev + u[None, :, :, None] * kv)
        S_new = torch.exp(logw[:, 0])[..., None] * S_prev + kv
        wkv = out[:, None].to(x.dtype)                  # (B,1,H,N)
        return _rwkv_out(cfg, params, wkv, g), {"shift": x[:, -1, :],
                                                "S": S_new}
    wkv, S_last = _rwkv6_wkv_kernel(r.contiguous(), k.contiguous(),
                                    v.contiguous(), logw.contiguous(),
                                    u.contiguous(), chunk=_RWKV_CHUNK)
    y = _rwkv_out(cfg, params, wkv.to(x.dtype), g)
    return y, {"shift": x[:, -1, :], "S": S_last}


def rwkv_channel_mix_spec(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": p((d,), ("embed",), init="zeros"),
        "mu_r": p((d,), ("embed",), init="zeros"),
        "wk": p((d, f), ("embed", "ff"), init="scaled"),
        "wv": p((f, d), ("ff", "embed"), init="scaled"),
        "wr": p((d, d), ("embed", None), init="scaled"),
    }


def rwkv_channel_mix(cfg: ModelConfig, params, x, *,
                     state: Optional[torch.Tensor] = None, mesh_ctx=None):
    """RWKV6 FFN with token shift. state: (B,d) last token (decode).
    Returns (out (B,S,d), the last token (B,d)). ``mesh_ctx``: the mesh
    form (the module's docstring), over the rank's slice of ``d_ff``."""
    if mesh_ctx is not None and mesh_ctx.mesh is not None:
        sharded = isinstance(
            params["wk"].placements[mesh_ctx.model_dim()], Shard)
        out, new = _mesh_mixer(
            mesh_ctx,
            lambda prm, xl, st: _with_shift(*rwkv_channel_mix(
                cfg, prm, xl, state=None if st is None else st["shift"])),
            params, x, None if state is None else {"shift": state},
            {"shift": None}, sharded)
        return out, new["shift"]
    xprev = _shift(x, state)

    def mix(mu):
        return x + (xprev - x) * mu.to(x.dtype)

    kx = torch.einsum("bsd,df->bsf", mix(params["mu_k"]), params["wk"])
    kx = torch.square(F.relu(kx))
    vx = torch.einsum("bsf,fd->bsd", kx, params["wv"])
    rx = torch.sigmoid(torch.einsum("bsd,de->bse", mix(params["mu_r"]),
                                    params["wr"]))
    return rx * vx, x[:, -1, :]


def _with_shift(out, shift):
    return out, {"shift": shift}


def rwkv_state_shape(cfg: ModelConfig, batch: int):
    H, N = rwkv_heads(cfg)
    return {
        "tm_shift": (batch, cfg.d_model),
        "S": (batch, H, N, N),
        "cm_shift": (batch, cfg.d_model),
    }
