"""Encoder-decoder transformer (whisper-base backbone); mirrors
``src/repro/models/encdec.py``.

The conv frontend is a stub: callers pass precomputed frame embeddings
``(B, T_frames, d_model)`` (what whisper's two stride-2 convs would emit),
so the encoder here is the transformer backbone only. Whisper uses pre-LN
LayerNorm blocks, GELU MLPs, learned positions on the decoder, sinusoidal
ones on the encoder, and MHA (kv == heads). The attention layers apply
RoPE to self-attention as the reference's do.

The decoder caches its self-attention KV (grows with decoding) and the
cross-attention KV (computed once from the encoder output at prefill).
Where the reference scans over the stacked layers, the port loops over
them, each layer of a forward under ``torch.utils.checkpoint`` where the
reference wraps its scan body in ``jax.checkpoint``; the decode step
writes the self-attention cache in place.

With a ``MeshContext`` over a ``DeviceMesh`` (the mesh path; parameters,
batch and cache are DTensors), as in the reference: the residual streams
are laid out by ``shard_activations`` at entry and after each layer, each
layer's weights are gathered over the FSDP axes right before use (as
``lm`` does), the encoder's bidirectional attention, the decoder's causal
self-attention, its cross-attention over the encoder's keys and the MLPs
take their mesh forms (``layers.attention``, ``layers.mlp``), and the
stacked ``(nL, B, S, KV, D)`` decode caches are laid out by
``cache_pspec``: where it shards their sequence, the ranks' partial
attentions merge through K2's log-sum-exp.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .common import ModelConfig, p, tree_map
from .lm import _stack_spec, _on_mesh

# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------


def _enc_layer_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def _dec_layer_spec(cfg: ModelConfig) -> Dict:
    return {
        "ln1": L.norm_spec(cfg),
        "self_attn": L.attention_spec(cfg),
        "ln_x": L.norm_spec(cfg),
        "cross_q": L.attention_spec(cfg),       # wq/wo used; wk/wv unused
        "cross_kv": L.cross_kv_spec(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg),
    }


def encdec_spec(cfg: ModelConfig) -> Dict:
    assert cfg.n_encoder_layers > 0
    return {
        "embed": L.embed_spec(cfg),
        # decoder learned positions (whisper)
        "pos_dec": p((cfg.max_seq_len, cfg.d_model), (None, "embed"),
                     init="normal", scale=0.01),
        "enc_stack": _stack_spec(_enc_layer_spec(cfg), cfg.n_encoder_layers),
        "ln_enc": L.norm_spec(cfg),
        "dec_stack": _stack_spec(_dec_layer_spec(cfg), cfg.n_layers),
        "ln_f": L.norm_spec(cfg),
    }


def _layers(stack, n: int):
    """The per-layer parameter trees of a stacked tree (one unbind per
    leaf, so the backward stacks the layers' gradients once)."""
    parts = tree_map(lambda t: t.unbind(0), stack)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


def _gathered(mesh_ctx, prm, spec):
    """``prm`` as a layer uses it: on a mesh gathered over the FSDP axes
    (``constrain_tree(..., fsdp=False)``), else as it is."""
    if not _on_mesh(mesh_ctx):
        return prm
    return mesh_ctx.constrain_tree(prm, spec, fsdp=False)


def _shard(mesh_ctx, h):
    return mesh_ctx.shard_activations(h) if _on_mesh(mesh_ctx) else h


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _sinusoid(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10_000.0, 2 * dim / d)
    return np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)


def encode(cfg: ModelConfig, params, frames, *, mesh_ctx=None):
    """frames: (B, T, d_model) stub frame embeddings -> (B, T, d_model).
    ``mesh_ctx``: the mesh path (the module's docstring); ``frames`` is
    then a DTensor laid out by ``batch_pspec``."""
    B, T, d = frames.shape
    mesh = _on_mesh(mesh_ctx)
    h = frames.to(cfg.dtype)
    dev = h.to_local().device if mesh else h.device
    sin = torch.from_numpy(_sinusoid(T, d)).to(dev, cfg.dtype)[None]
    if mesh:
        sin = mesh_ctx.distribute(sin, mesh_ctx.replicated())
    h = _shard(mesh_ctx, h + sin)
    positions = torch.arange(T, device=dev)[None, :]
    spec = _enc_layer_spec(cfg)

    def layer(h, prm):
        prm = _gathered(mesh_ctx, prm, spec)
        x = L.norm(cfg, prm["ln1"], h)
        a, _ = L.attention(cfg, prm["attn"], x, positions=positions,
                           bidirectional=True, mesh_ctx=mesh_ctx)
        h = h + a
        h = h + L.mlp(cfg, prm["mlp"], L.norm(cfg, prm["ln2"], h), mesh_ctx)
        return _shard(mesh_ctx, h)

    for prm in _layers(params["enc_stack"], cfg.n_encoder_layers):
        h = checkpoint(layer, h, prm, use_reentrant=False)
    return L.norm(cfg, _gathered(mesh_ctx, params["ln_enc"],
                                 L.norm_spec(cfg)), h)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_layer(cfg: ModelConfig, prm, h, positions, cross_kv, *, cache=None,
               cache_pos=None, mesh_ctx=None):
    """One decoder layer: causal self-attention (with ``cache`` a bulk
    decode at ``cache_pos``, the cache written in place), cross-attention
    over ``cross_kv`` and the MLP, on a mesh each in its mesh form, the
    layer's weights gathered first. Returns h."""
    prm = _gathered(mesh_ctx, prm, _dec_layer_spec(cfg))
    x = L.norm(cfg, prm["ln1"], h)
    a, _ = L.attention(cfg, prm["self_attn"], x, positions=positions,
                       cache=cache, cache_pos=cache_pos, mesh_ctx=mesh_ctx)
    h = h + a
    x = L.norm(cfg, prm["ln_x"], h)
    c, _ = L.attention(cfg, prm["cross_q"], x, positions=positions,
                       cross_kv=cross_kv, mesh_ctx=mesh_ctx)
    h = h + c
    return h + L.mlp(cfg, prm["mlp"], L.norm(cfg, prm["ln2"], h), mesh_ctx)


def _dec_embed(cfg: ModelConfig, params, tokens, mesh_ctx, rows: slice):
    """The decoder's input: the token embedding (on a mesh laid out by
    ``shard_activations``) plus the learned positions ``rows``."""
    mesh = _on_mesh(mesh_ctx)
    h = _shard(mesh_ctx, L.embed(cfg, params["embed"], tokens,
                                 mesh_ctx if mesh else None))
    pos_dec = _gathered(mesh_ctx, params["pos_dec"],
                        encdec_spec(cfg)["pos_dec"])
    return h + pos_dec.to(h.dtype)[rows][None]


def decode_train(cfg: ModelConfig, params, tokens, enc_out, *,
                 mesh_ctx=None, last_logit_only: bool = False):
    """Teacher-forced decoder pass. tokens: (B, S) -> logits (B, S, vocab)
    (or (B, 1, vocab) with ``last_logit_only``). ``mesh_ctx``: the mesh
    path (the module's docstring); the logits are then vocab-parallel."""
    B, S = tokens.shape
    mesh = _on_mesh(mesh_ctx)
    h = _shard(mesh_ctx, _dec_embed(cfg, params, tokens, mesh_ctx,
                                    slice(0, S)))
    dev = h.to_local().device if mesh else h.device
    positions = torch.arange(S, device=dev)[None, :]
    if mesh:
        enc_out = mesh_ctx.gather_seq(enc_out)

    def layer(h, prm, enc_out):
        ckv = L.make_cross_kv(_gathered(mesh_ctx, prm["cross_kv"],
                                        L.cross_kv_spec(cfg)), enc_out)
        return _shard(mesh_ctx, _dec_layer(cfg, prm, h, positions, ckv,
                                           mesh_ctx=mesh_ctx))

    for prm in _layers(params["dec_stack"], cfg.n_layers):
        h = checkpoint(layer, h, prm, enc_out, use_reentrant=False)
    if last_logit_only:
        h = h[:, -1:]
    h = L.norm(cfg, _gathered(mesh_ctx, params["ln_f"], L.norm_spec(cfg)),
               h)
    return L.unembed(cfg, params["embed"], h, mesh_ctx if mesh else None)


def encdec_forward(cfg: ModelConfig, params, tokens, frames, *,
                   mesh_ctx=None, last_logit_only: bool = False):
    enc_out = encode(cfg, params, frames, mesh_ctx=mesh_ctx)
    return decode_train(cfg, params, tokens, enc_out, mesh_ctx=mesh_ctx,
                        last_logit_only=last_logit_only)


# ---------------------------------------------------------------------------
# Incremental decode
# ---------------------------------------------------------------------------


def encdec_cache_shapes(cfg: ModelConfig, batch: int, max_seq: int,
                        enc_len: int) -> Dict:
    nL = cfg.n_layers
    kv = (nL, batch, max_seq, cfg.kv_heads, cfg.d_head)
    ckv = (nL, batch, enc_len, cfg.kv_heads, cfg.d_head)
    return {"k": kv, "v": kv, "ck": ckv, "cv": ckv}


def encdec_prefill_cache(cfg: ModelConfig, params, enc_out, batch: int,
                         max_seq: int):
    """Precompute every layer's cross KV from the encoder output (B, T,
    d_model); allocate the zero self-attention cache, on enc_out's
    device."""
    ck, cv = zip(*(L.make_cross_kv(prm["cross_kv"], enc_out)
                   for prm in _layers(params["dec_stack"], cfg.n_layers)))
    shape = (cfg.n_layers, batch, max_seq, cfg.kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=enc_out.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=enc_out.device),
            "ck": torch.stack(ck).to(cfg.dtype),
            "cv": torch.stack(cv).to(cfg.dtype)}


def encdec_decode_step(cfg: ModelConfig, params, cache, tokens, pos: int,
                       *, mesh_ctx=None):
    """One decode token. tokens: (B,1); pos: one int shared by every row
    (the bulk mode). Writes each layer's self-attention k/v at ``pos`` in
    place and returns (logits (B,1,vocab), cache). ``mesh_ctx``: the mesh
    path (the module's docstring); params, cache and tokens are DTensors,
    the cache laid out by ``cache_pspec``."""
    pos = int(pos)
    mesh = _on_mesh(mesh_ctx)
    # the reference's dynamic_slice clamps the start into the table
    p0 = min(max(pos, 0), params["pos_dec"].shape[0] - 1)
    h = _dec_embed(cfg, params, tokens, mesh_ctx, slice(p0, p0 + 1))
    dev = h.to_local().device if mesh else h.device
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=dev)
    for li, prm in enumerate(_layers(params["dec_stack"], cfg.n_layers)):
        h = _dec_layer(cfg, prm, h, positions,
                       (cache["ck"][li], cache["cv"][li]),
                       cache={"k": cache["k"][li], "v": cache["v"][li]},
                       cache_pos=pos, mesh_ctx=mesh_ctx)
    h = L.norm(cfg, _gathered(mesh_ctx, params["ln_f"], L.norm_spec(cfg)),
               h)
    return L.unembed(cfg, params["embed"], h, mesh_ctx if mesh else None), \
        cache
