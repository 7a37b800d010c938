"""Decoder-only LM assembly for pattern-based architectures; mirrors
``src/repro/models/lm.py``.

A config's ``layer_pattern`` defines a repeating *unit*. Parameters of
each unit are stacked with a leading repeat axis (``params["stack"]
["0_G"]``) and the remainder layers (n_layers % len(pattern)) form an
explicit tail, exactly as in the reference's parameter tree. Where the
reference scans over the repeat axis, the port loops over it.

Ported so far: the paged decode step for G (global attention + dense
MLP) layers. Other layer kinds and the training forward raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import layers as L
from .common import ModelConfig, ParamSpec, tree_map

# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------


def _sublayer_spec(cfg: ModelConfig, kind: str) -> Dict:
    if kind != "G":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    d_ff = None
    if kind == "G" and cfg.n_experts and cfg.dense_d_ff:
        d_ff = cfg.dense_d_ff
    spec = {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_spec(cfg, d_ff),
    }
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
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported")
    pat, n_rep, tail = unit_pattern(cfg)
    spec: Dict[str, Any] = {"embed": L.embed_spec(cfg)}
    unit = {f"{i}_{k}": _sublayer_spec(cfg, k) for i, k in enumerate(pat)}
    spec["stack"] = _stack_spec(unit, n_rep)
    for i, k in enumerate(tail):
        spec[f"tail_{i}_{k}"] = _sublayer_spec(cfg, k)
    spec["ln_f"] = L.norm_spec(cfg)
    return spec


def _unit_keys(pat: str) -> List[str]:
    return [f"{i}_{k}" for i, k in enumerate(pat)]


# ---------------------------------------------------------------------------
# Sublayer application
# ---------------------------------------------------------------------------


def _apply_sublayer(cfg: ModelConfig, prm, h, *, positions, cache,
                    cache_pos, paged):
    """One G sublayer on the paged plane; the layer's pool pages in
    ``cache`` are written in place. Returns h."""
    x = L.norm(cfg, prm["ln1"], h)
    attn_out, _ = L.attention(cfg, prm["attn"], x, positions=positions,
                              cache=cache, cache_pos=cache_pos, paged=paged)
    if cfg.post_norms:
        attn_out = L.norm(cfg, prm["ln1_post"], attn_out)
    h = h + attn_out
    ff = L.mlp(cfg, prm["mlp"], L.norm(cfg, prm["ln2"], h))
    if cfg.post_norms:
        ff = L.norm(cfg, prm["ln2_post"], ff)
    return h + ff


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> Dict:
    """Cache layout mirroring the param stacking: stacked leading repeat
    axis for the unit, explicit entries for the tail. G layers only."""
    pat, n_rep, tail = unit_pattern(cfg)

    def sub_shapes(kind: str):
        if kind != "G":
            raise NotImplementedError(
                f"layer kind {kind!r} has no ported decode cache")
        s = (batch, max_seq, cfg.kv_heads, cfg.d_head)
        return {"k": s, "v": s}

    out: Dict[str, Any] = {"stack": {}}
    for key in _unit_keys(pat):
        kind = key.split("_")[1]
        out["stack"][key] = {n: (n_rep,) + s
                             for n, s in sub_shapes(kind).items()}
    for i, k in enumerate(tail):
        out[f"tail_{i}_{k}"] = sub_shapes(k)
    return out


def lm_decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                   seq_lens, paged_tables):
    """One paged decode step over a chunk of S tokens per row. tokens:
    (B,S); pos: (B,) int32 per-slot start positions; ``seq_lens`` (B,) the
    number of *real* tokens per row (rows are right-padded to S);
    ``paged_tables`` (B, NW) int32 pool rows in chain order.

    ``cache`` is the KV *pool* tree (leaves (*lead, num_blocks, bt, KV,
    D)); row b's chunk is written into — and attended out of — the pool
    rows its block table names, in place. Only the paged plane of G
    layers is ported: other layer kinds raise, as the reference's paged
    decode does for rolling/recurrent ones.

    Returns (logits (B,1,vocab) of each row's last real token, cache)."""
    pat, n_rep, tail = unit_pattern(cfg)
    B, S = tokens.shape
    unsupported = set(pat + tail) - {"G"}
    if unsupported:
        raise NotImplementedError(
            "the port's paged decode covers global-attention (G) layers; "
            f"layer kinds {sorted(unsupported)} are not ported")
    if paged_tables is None or seq_lens is None or pos.ndim != 1:
        raise NotImplementedError(
            "only the paged plane is ported: pass per-slot pos, seq_lens "
            "and paged_tables")
    paged = {"tables": paged_tables, "seq_lens": seq_lens}
    h = L.embed(cfg, params["embed"], tokens)
    positions = (pos[:, None].int()
                 + torch.arange(S, dtype=torch.int32,
                                device=tokens.device)[None, :])
    for li in range(n_rep):
        for key in _unit_keys(pat):
            prm = tree_map(lambda t: t[li], params["stack"][key])
            layer_cache = {n: c[li] for n, c in cache["stack"][key].items()}
            h = _apply_sublayer(cfg, prm, h, positions=positions,
                                cache=layer_cache, cache_pos=pos,
                                paged=paged)
    for i, k in enumerate(tail):
        key = f"tail_{i}_{k}"
        h = _apply_sublayer(cfg, params[key], h, positions=positions,
                            cache=cache[key], cache_pos=pos, paged=paged)
    # unembed only each row's last real token (padded rows are junk and a
    # full (B,S,V) logit tensor is wasted work)
    last = torch.clamp(seq_lens.long() - 1, min=0)
    h = h[torch.arange(B, device=h.device), last][:, None]
    h = L.norm(cfg, params["ln_f"], h)
    return L.unembed(cfg, params["embed"], h), cache
