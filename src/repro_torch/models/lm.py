"""Decoder-only LM assembly for pattern-based architectures; mirrors
``src/repro/models/lm.py``.

A config's ``layer_pattern`` defines a repeating *unit*. Parameters of
each unit are stacked with a leading repeat axis (``params["stack"]
["0_G"]``) and the remainder layers (n_layers % len(pattern)) form an
explicit tail, exactly as in the reference's parameter tree. Where the
reference scans over the repeat axis, the port loops over it.

Layer kinds: G (global attention + dense MLP), L (local, windowed
attention + dense MLP), M (global attention + MoE MLP), R (RG-LRU
recurrent block + dense MLP) and W (RWKV6 time-mix + channel-mix). The
training/prefill forward ``lm_forward`` and ``lm_loss`` run all five, and
for the image-prefix (vlm) family take the frontend's patch embeddings as
a bidirectional prefix (PaliGemma's prefix-LM). The decode step is
text-only, as the reference's is; it runs every kind one token at a time
on the gather plane; chunks (S > 1) and the paged plane need
absolute-position KV caches, G and M layers only, and raise elsewhere, as
the reference does. ``lm_decode_step`` takes a (B, S) grid of every
slot's feed; ``lm_packed_step``, the serve engine's paged step, takes the
same feeds as packed token rows, one row a real token, and computes the
same function without the grid's padding rows.

With a ``MeshContext`` over a ``DeviceMesh`` (the mesh path: parameters,
batch and cache are DTensors), each sublayer's weights are gathered over
the FSDP axes right before use (``constrain_tree(..., fsdp=False)``) and
the residual stream is laid out batch over data, sequence over model
(``shard_activations``) at entry and after each sublayer of the unit, as
in the reference. Every layer kind runs on a mesh, in the forward and in
the decode step: the R and W mixers on each rank's channel or head shard
(``recurrent``), and a decode cache that shards the sequence through a
merge of the ranks' partial attentions (``layers._mesh_decode_attention``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from . import layers as L
from ..sharding import all_max, reduce_from_group
from .common import ModelConfig, ParamSpec, p, tree_map
from .moe import moe, moe_spec
from .recurrent import (rglru_block, rglru_block_spec, rglru_state_shape,
                        rwkv_channel_mix, rwkv_channel_mix_spec,
                        rwkv_state_shape, rwkv_time_mix, rwkv_time_mix_spec)

# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _sublayer_spec(cfg: ModelConfig, kind: str) -> Dict:
    if kind == "R":
        return {
            "ln1": L.norm_spec(cfg),
            "rec": rglru_block_spec(cfg),
            "ln2": L.norm_spec(cfg),
            "mlp": L.mlp_spec(cfg),
        }
    if kind == "W":
        return {
            "ln1": L.norm_spec(cfg),
            "tm": rwkv_time_mix_spec(cfg),
            "ln2": L.norm_spec(cfg),
            "cm": rwkv_channel_mix_spec(cfg),
        }
    if kind not in ("G", "L", "M"):
        raise ValueError(f"unknown layer kind {kind!r}")
    d_ff = None
    if kind == "G" and cfg.n_experts and cfg.dense_d_ff:
        d_ff = cfg.dense_d_ff
    spec = {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "ln2": L.norm_spec(cfg),
    }
    if kind == "M":
        spec["moe"] = moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg, d_ff)
    if cfg.post_norms:
        spec["ln1_post"] = L.norm_spec(cfg)
        spec["ln2_post"] = L.norm_spec(cfg)
    return spec


def _stack_spec(tree, n: int):
    def stack(s: ParamSpec):
        return ParamSpec((n,) + s.shape, ("layer",) + s.axes, s.init,
                         s.scale, s.dtype)
    return tree_map(stack, tree)


def unit_pattern(cfg: ModelConfig) -> Tuple[str, int, str]:
    """(pattern, n_repeats, tail): n_layers = n_repeats*len(pattern)+len(tail)."""
    pat = cfg.layer_pattern
    n_rep = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers - n_rep * len(pat)]
    return pat, n_rep, tail


def lm_spec(cfg: ModelConfig) -> Dict:
    pat, n_rep, tail = unit_pattern(cfg)
    spec: Dict[str, Any] = {"embed": L.embed_spec(cfg)}
    unit = {f"{i}_{k}": _sublayer_spec(cfg, k) for i, k in enumerate(pat)}
    spec["stack"] = _stack_spec(unit, n_rep)
    for i, k in enumerate(tail):
        spec[f"tail_{i}_{k}"] = _sublayer_spec(cfg, k)
    spec["ln_f"] = L.norm_spec(cfg)
    if cfg.frontend == "patch_embed":
        spec["frontend_proj"] = p((cfg.frontend_dim, cfg.d_model),
                                  (None, "embed"), init="scaled")
    return spec


def _unit_keys(pat: str) -> List[str]:
    return [f"{i}_{k}" for i, k in enumerate(pat)]


# ---------------------------------------------------------------------------
# Sublayer application
# ---------------------------------------------------------------------------


def _on_mesh(mesh_ctx) -> bool:
    return mesh_ctx is not None and mesh_ctx.mesh is not None


def _apply_sublayer(cfg: ModelConfig, kind: str, prm, h, *, positions,
                    cache=None, cache_pos=None, cache_valid_len=None,
                    paged=None, packed=None, prefix_len: int = 0,
                    kv_shard=None, mesh_ctx=None):
    """One sublayer. Without ``cache`` the training/prefill form (L and R
    layers see ``cfg.window``; attention sees an image prefix of
    ``prefix_len`` positions); with it a decode, which writes the layer's
    cache (or pool pages) in place: G, L and M layers their KV, R and W
    layers their recurrent state, each leaf cast to its own dtype, as the
    reference casts the state it returns. With a mesh the sublayer's
    weights are first gathered over the FSDP axes (``constrain_tree(...,
    fsdp=False)``). Returns h."""
    if _on_mesh(mesh_ctx):
        # FSDP: gather this sublayer's weights (in bf16) right before use
        prm = mesh_ctx.constrain_tree(prm, _sublayer_spec(cfg, kind),
                                      fsdp=False)
    else:
        mesh_ctx = None
    if kind == "W":
        x = L.norm(cfg, prm["ln1"], h)
        tm_out, tm_state = rwkv_time_mix(
            cfg, prm["tm"], x,
            state=None if cache is None else {"shift": cache["tm_shift"],
                                              "S": cache["S"]},
            mesh_ctx=mesh_ctx)
        h = h + tm_out
        cm_out, cm_shift = rwkv_channel_mix(
            cfg, prm["cm"], L.norm(cfg, prm["ln2"], h),
            state=None if cache is None else cache["cm_shift"],
            mesh_ctx=mesh_ctx)
        if cache is not None:
            _write_state(cache, {"tm_shift": tm_state["shift"],
                                 "S": tm_state["S"], "cm_shift": cm_shift})
        return h + cm_out
    if kind == "R":
        x = L.norm(cfg, prm["ln1"], h)
        rec_out, state = rglru_block(cfg, prm["rec"], x, state=cache,
                                     mesh_ctx=mesh_ctx)
        if cache is not None:
            _write_state(cache, state)
        h = h + rec_out
        return h + L.mlp(cfg, prm["mlp"], L.norm(cfg, prm["ln2"], h),
                         mesh_ctx)
    window = cfg.window if kind == "L" else None
    x = L.norm(cfg, prm["ln1"], h)
    attn_out, _ = L.attention(cfg, prm["attn"], x, positions=positions,
                              window=window, cache=cache,
                              cache_pos=cache_pos,
                              cache_valid_len=cache_valid_len, paged=paged,
                              packed=packed, prefix_len=prefix_len,
                              kv_shard=kv_shard, mesh_ctx=mesh_ctx)
    if cfg.post_norms:
        attn_out = L.norm(cfg, prm["ln1_post"], attn_out)
    h = h + attn_out
    x = L.norm(cfg, prm["ln2"], h)
    ff = (moe(cfg, prm["moe"], x, mesh_ctx) if kind == "M"
          else L.mlp(cfg, prm["mlp"], x, mesh_ctx))
    if cfg.post_norms:
        ff = L.norm(cfg, prm["ln2_post"], ff)
    return h + ff


def _write_state(cache: Dict, state: Dict) -> None:
    """A recurrent layer's new state into its cache views, in place, each
    leaf cast to the cache leaf's dtype; on a mesh first laid out as the
    cache leaf is (where the mixer computed it whole, a local slice)."""
    for name, value in state.items():
        if isinstance(value, DTensor):
            value = value.redistribute(value.device_mesh,
                                       cache[name].placements)
        cache[name].copy_(value)


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------


def lm_forward(cfg: ModelConfig, params, tokens, *, mesh_ctx=None,
               patches=None, last_logit_only: bool = False):
    """tokens: (B,S) int. For the image-prefix (vlm) family, ``patches``
    (B,P,frontend_dim) are projected, scaled by sqrt(d_model) under
    ``embed_scale`` and prepended as a bidirectional prefix of P
    positions. Returns logits (B,S',vocab), S' = P + S for vlm, or
    (B,1,vocab) with ``last_logit_only``. Each repeat of the stacked unit
    runs under activation checkpointing (``torch.utils.checkpoint``,
    non-reentrant), where the reference wraps its scan body in
    ``jax.checkpoint``: its inputs are kept and its inside is recomputed
    in the backward. The tail layers are not checkpointed, as in the
    reference. ``mesh_ctx``: the mesh path (see the module's docstring);
    ``tokens`` and ``patches`` are then DTensors laid out by
    ``batch_pspec``."""
    pat, n_rep, tail = unit_pattern(cfg)
    mesh = _on_mesh(mesh_ctx)
    h = L.embed(cfg, params["embed"], tokens, mesh_ctx if mesh else None)
    prefix_len = 0
    if cfg.frontend == "patch_embed":
        assert patches is not None, "the vlm family needs patches"
        if mesh:
            # the concatenation runs on the sequence-gathered parts
            patches = mesh_ctx.gather_seq(patches)
            h = mesh_ctx.gather_seq(h)
            proj = mesh_ctx.constrain_tree(
                params["frontend_proj"], lm_spec(cfg)["frontend_proj"],
                fsdp=False)
            pe = patches.to(cfg.dtype) @ proj
            if cfg.embed_scale:
                # the bf16-rounded factor the meshless path multiplies by
                pe = pe * float(torch.tensor(math.sqrt(cfg.d_model),
                                             dtype=pe.dtype))
        else:
            pe = patches.to(cfg.dtype) @ params["frontend_proj"]
            if cfg.embed_scale:
                pe = pe * torch.tensor(math.sqrt(cfg.d_model),
                                       dtype=pe.dtype)
        h = torch.cat([pe, h], dim=1)
        prefix_len = patches.shape[1]
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    if mesh:
        h = mesh_ctx.shard_activations(h)

    def unit(h, prm_r):
        for key in _unit_keys(pat):
            h = _apply_sublayer(cfg, key.split("_")[1], prm_r[key], h,
                                positions=positions, prefix_len=prefix_len,
                                mesh_ctx=mesh_ctx)
            if mesh:
                h = mesh_ctx.shard_activations(h)
        return h

    if n_rep > 0:
        # one unbind per stacked leaf: its backward stacks the layers'
        # gradients once
        layers = tree_map(lambda t: t.unbind(0), params["stack"])
        for li in range(n_rep):
            h = checkpoint(unit, h, tree_map(lambda ts: ts[li], layers),
                           use_reentrant=False)
    for i, k in enumerate(tail):
        h = _apply_sublayer(cfg, k, params[f"tail_{i}_{k}"], h,
                            positions=positions, prefix_len=prefix_len,
                            mesh_ctx=mesh_ctx)
    if last_logit_only:
        h = h[:, -1:]
    return L.unembed(cfg, params["embed"],
                     L.norm(cfg, _final_norm(cfg, params, mesh_ctx), h),
                     mesh_ctx if mesh else None)


def _final_norm(cfg: ModelConfig, params, mesh_ctx):
    """``ln_f``'s params; on a mesh gathered over the FSDP axes, so the
    norm runs on the activations' own layout."""
    if not _on_mesh(mesh_ctx):
        return params["ln_f"]
    return mesh_ctx.constrain_tree(params["ln_f"], L.norm_spec(cfg),
                                   fsdp=False)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    """Cache layout mirroring the param stacking: stacked leading repeat
    axis for the unit, explicit entries for the tail. G and M layers hold
    KV at absolute positions, L layers a rolling window ``min(window,
    max_seq)`` slots wide, R and W layers their recurrent state."""
    pat, n_rep, tail = unit_pattern(cfg)

    def sub_shapes(kind: str):
        if kind == "G" or kind == "M":
            s = (batch, max_seq, cfg.kv_heads, cfg.d_head)
            return {"k": s, "v": s}
        if kind == "L":
            w = min(cfg.window or max_seq, max_seq)
            s = (batch, w, cfg.kv_heads, cfg.d_head)
            return {"k": s, "v": s}
        if kind == "R":
            return rglru_state_shape(cfg, batch)
        if kind == "W":
            return rwkv_state_shape(cfg, batch)
        raise ValueError(kind)

    out: Dict[str, Any] = {"stack": {}}
    for key in _unit_keys(pat):
        kind = key.split("_")[1]
        out["stack"][key] = {n: (n_rep,) + s
                             for n, s in sub_shapes(kind).items()}
    for i, k in enumerate(tail):
        out[f"tail_{i}_{k}"] = sub_shapes(k)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: torch.device | str):
    """The zero cache of ``cache_shapes``, every leaf in ``cfg.dtype``, as
    the reference's ``init_cache`` makes it (``api.init_decode_cache``
    keeps the recurrent state in fp32 instead)."""
    return tree_map(lambda s: torch.zeros(s, dtype=cfg.dtype, device=device),
                    cache_shapes(cfg, batch, max_seq))


def lm_decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                   mesh_ctx=None, seq_lens=None, paged_tables=None,
                   kv_shard=None):
    """One decode step over a chunk of S tokens per row. tokens: (B,S);
    pos: (B,) int32 per-slot start positions (continuous batching), or one
    int shared by every row (bulk decode). For L layers the cache is a
    rolling window written at ``pos % window``.

    ``seq_lens`` (B,) gives the number of *real* tokens per row (rows are
    right-padded to S); the logits returned are those of each row's last
    real token. Without ``seq_lens`` the last column is used.

    Gather plane (no ``paged_tables``): ``cache`` is the per-slot
    contiguous KV tree (leaves (*lead, B, S_cache, KV, D)). Paged plane
    (``paged_tables`` (B, NW) int32, with per-slot ``pos`` and
    ``seq_lens``): ``cache`` is the KV *pool* tree (leaves (*lead,
    num_blocks, bt, KV, D)) and row b's chunk is written into — and
    attended out of — the pool rows its block table names. Chunks (S > 1)
    and the paged plane need absolute-position caches (G and M layers).
    R and W layers decode one token from their recurrent state. Either
    way the cache is written in place. ``kv_shard`` (a
    ``sharding.KVShardCtx``, serve tensor parallelism, paged plane only):
    the pool leaves hold this rank's KV heads and each attention runs on
    the rank's head slice, its outputs all-gathered over heads.

    ``mesh_ctx`` (the mesh path): params, cache and tokens are DTensors
    laid out by the rules (``cache_pspec`` for the cache); a bulk step
    (one shared ``pos``) of one token runs each attention on the rank's
    cache shard (``layers._mesh_decode_attention``; where the shard is a
    slice of the sequence, the ranks' partial attentions merge through
    K2's log-sum-exp) and each R and W layer on the rank's state shard.
    Per-slot positions, chunks and the paged plane raise
    ``NotImplementedError`` there.

    Returns (logits (B,1,vocab), cache)."""
    pat, _, tail = unit_pattern(cfg)
    B, S = tokens.shape
    mesh = _on_mesh(mesh_ctx)
    if mesh:
        _check_mesh_decode(pos, S, seq_lens, paged_tables, kv_shard)
    if S > 1 or paged_tables is not None:
        unsupported = set(pat + tail) - {"G", "M"}
        if unsupported:
            raise NotImplementedError(
                "chunked prefill and paged decode need absolute-position "
                f"KV caches; layer kinds {sorted(unsupported)} are "
                "rolling/recurrent")
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    paged = None
    if paged_tables is not None:
        assert per_slot and seq_lens is not None, \
            "paged decode needs per-slot positions and seq_lens"
        paged = {"tables": paged_tables, "seq_lens": seq_lens}
    assert kv_shard is None or paged is not None, \
        "serve TP (kv_shard) only shards the paged data plane"
    h = L.embed(cfg, params["embed"], tokens, mesh_ctx if mesh else None)
    if mesh:
        h = mesh_ctx.shard_activations(h)
    steps = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
    positions = pos[:, None].int() + steps if per_slot else pos + steps

    def sub_cache_pos(kind):
        if kind == "L":
            return pos % (cfg.window or 1)
        return pos

    def sub_valid_len(kind):
        # L caches are rolling windows: once wrapped, every slot is valid
        if kind == "L":
            w = cfg.window or 1
            return (torch.clamp(pos + 1, max=w) if per_slot
                    else min(pos + 1, w))
        return pos + 1

    def apply(kind, prm, layer_cache, h):
        return _apply_sublayer(cfg, kind, prm, h, positions=positions,
                               cache=layer_cache,
                               cache_pos=sub_cache_pos(kind),
                               cache_valid_len=sub_valid_len(kind),
                               paged=paged, kv_shard=kv_shard,
                               mesh_ctx=mesh_ctx)

    for kind, prm, layer_cache in _decode_layers(cfg, params, cache):
        h = apply(kind, prm, layer_cache, h)
    if S > 1 or seq_lens is not None:
        # unembed only each row's last real token (padded rows are junk and
        # a full (B,S,V) logit tensor is wasted work)
        last = (torch.clamp(seq_lens.long() - 1, min=0)
                if seq_lens is not None
                else torch.full((B,), S - 1, device=h.device))
        h = h[torch.arange(B, device=h.device), last][:, None]
    h = L.norm(cfg, _final_norm(cfg, params, mesh_ctx), h)
    return L.unembed(cfg, params["embed"], h, mesh_ctx if mesh else None), \
        cache


def _decode_layers(cfg: ModelConfig, params, cache):
    """(kind, params, cache) of each layer in order: the stacked unit's
    repeats, then the tail."""
    pat, n_rep, tail = unit_pattern(cfg)
    for li in range(n_rep):
        for key in _unit_keys(pat):
            yield (key.split("_")[1],
                   tree_map(lambda t: t[li], params["stack"][key]),
                   {n: c[li] for n, c in cache["stack"][key].items()})
    for i, k in enumerate(tail):
        key = f"tail_{i}_{k}"
        yield k, params[key], cache[key]


def lm_packed_step(cfg: ModelConfig, params, pool, tokens,
                   rows: L.PackedRows, *, kv_shard=None):
    """One step of the paged plane on packed token rows: ``tokens`` (T,)
    holds every token the step feeds, a decoding slot's one and a
    prefilling slot's chunk, and padding rows after them; ``rows`` (a
    ``layers.PackedRows``) gives each row's position, pool write and place
    in K1's query tile. Every layer runs on the T rows as one (1, T, d)
    sequence, RoPE at each row's own position; each row's K/V is written
    into ``pool`` (the KV pool tree, as ``lm_decode_step``'s paged plane
    takes it) in place, a padding row's into the junk row 0 only, and the
    attention runs K1 on the (B, S) tile. G and M layers only. ``kv_shard``
    as in ``lm_decode_step``.

    The same function as ``lm_decode_step``'s paged plane on the (B, S)
    grid of the same feeds, without its padding rows. Returns (the logits
    (B, 1, vocab) of each slot's last row, ``rows.last``; pool)."""
    pat, _, tail = unit_pattern(cfg)
    unsupported = set(pat + tail) - {"G", "M"}
    if unsupported:
        raise NotImplementedError(
            "packed rows need absolute-position KV caches; layer kinds "
            f"{sorted(unsupported)} are rolling/recurrent")
    h = L.embed(cfg, params["embed"], tokens[None])
    positions = rows.pos[None]
    for kind, prm, layer_cache in _decode_layers(cfg, params, pool):
        h = _apply_sublayer(cfg, kind, prm, h, positions=positions,
                            cache=layer_cache, packed=rows,
                            kv_shard=kv_shard)
    h = L.norm(cfg, params["ln_f"], h[0, rows.last][:, None])
    return L.unembed(cfg, params["embed"], h), pool


def _check_mesh_decode(pos, S, seq_lens, paged_tables, kv_shard) -> None:
    """What the mesh path's decode step does not take raises here."""
    if (S != 1 or seq_lens is not None or paged_tables is not None
            or kv_shard is not None
            or (isinstance(pos, torch.Tensor) and pos.ndim == 1)):
        raise NotImplementedError(
            "the mesh path decodes one token a row at one shared position; "
            "the serve engines' chunks, per-slot positions and paged plane "
            "take a KVShardCtx instead")


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def lm_loss(cfg: ModelConfig, logits, targets, mask=None, mesh_ctx=None):
    """Next-token cross entropy; fp32 log-softmax. targets already shifted.
    With a mesh the logits are vocab-parallel DTensors and the loss is
    ``_mesh_lm_loss``'s."""
    if _on_mesh(mesh_ctx):
        return _mesh_lm_loss(mesh_ctx, logits, targets, mask)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _mesh_lm_loss(mesh_ctx, logits, targets, mask=None):
    """The cross entropy of vocab-parallel logits on each rank's shards
    (``local_map``): rows batch over data, whole over model, the vocab
    over model where it divides. The log-sum-exp and the gold logit
    reduce over the vocab shards (a max and two sums over the model
    group), so no rank gathers the (B, S, V) logits. Each data rank sums
    its rows' losses and mask; the two sums are partial over the data
    axes, and their quotient is the mean."""
    l_pl = tuple(logits.placements)
    m = mesh_ctx.model_dim()
    # the vocab split over several model ranks; over one (or none) the
    # rank's logits are whole and the loss is the meshless expression
    sharded = isinstance(l_pl[m], Shard) and mesh_ctx.tp_size > 1
    group = mesh_ctx.model_group() if sharded else None
    rows = list(l_pl)
    rows[m] = Replicate()
    out_pl = [Partial() if isinstance(pl, Shard) else Replicate()
              for pl in rows]
    args = [logits, targets] + ([] if mask is None else [mask])

    def body(lg, tg, mk=None):
        lg = lg.float()
        if sharded:
            v0 = mesh_ctx.model_rank() * lg.shape[-1]
            mx = all_max(lg.detach().amax(dim=-1), group)
            se = reduce_from_group(torch.exp(lg - mx[..., None]).sum(-1),
                                   group)
            logz = mx + torch.log(se)
            t = tg.long() - v0
            hit = (t >= 0) & (t < lg.shape[-1])
            gold = torch.gather(lg, -1,
                                torch.where(hit, t, 0)[..., None])[..., 0]
            gold = reduce_from_group(torch.where(hit, gold, 0.0), group)
        else:
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, tg[..., None].long())[..., 0]
        nll = logz - gold
        if mk is None:
            return nll.sum(), torch.tensor(float(nll.numel()),
                                           device=nll.device)
        mk = mk.float()
        return (nll * mk).sum(), mk.sum()

    total, count = local_map(
        body, out_placements=(out_pl, out_pl),
        in_placements=(l_pl, rows, rows)[:len(args)],
        device_mesh=mesh_ctx.mesh, redistribute_inputs=True)(*args)
    if mask is None:
        return total / count
    return total / count.clamp_min(1.0)
