"""Plain reference of the Qwen2 / Qwen1.5 decoder (Qwen2ForCausalLM): the
weights the benchmark makes from a seed, and the forward pass in float32
that judges what the program served.

Architecture, as Hugging Face's ``modeling_qwen2`` computes it: token
embedding; per layer RMSNorm (eps ``rms_norm_eps``), Q/K/V projections
with bias, rotary embedding on Q and K (half-split rotation, frequency
``rope_theta ** (-i / (head_dim / 2))``), causal grouped-query attention
(query head h reads KV head h // (heads / KV heads)) scaled by
1/sqrt(head_dim), output projection without bias, residual; RMSNorm,
SwiGLU MLP (down(silu(gate(x)) * up(x))), residual; final RMSNorm and an
untied head. Departures, both of layout only: an RMSNorm's weight is
stored as an offset from 1 (it multiplies by ``1 + scale``), and the gate
and up projections are one ``(hidden, 2, intermediate)`` array, gate
first, because that is the layout the program takes its weights in.

Nothing here imports the program or JAX. The forward runs layer by layer
over every sequence, each layer's weights cast to float32 once, with
TF32 off, so that it fits beside nothing else on the card once the
program's state is freed. ``precision="fp8"`` is the control: the same
forward with every matrix product's weights and inputs, and the keys and
values, rounded to float8 e4m3 with one scale a tensor.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0     # largest finite float8 e4m3fn


def _dims(cfg: Dict):
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    KV = cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or d // H
    return d, H, KV, D, cfg["intermediate_size"], cfg["vocab_size"], \
        cfg["num_hidden_layers"]


def weight_layout(cfg: Dict) -> Dict[str, tuple]:
    """{path: (shape, std)} of the weights, in the program's tree layout
    (the stacked unit ``stack/0_G`` with a leading layer axis). Standard
    deviations: the embedding 1; the head 1/sqrt(hidden), so logits are of
    order 1; Q and K 1.7/sqrt(hidden), so attention scores spread with a
    standard deviation near 3 and each query attends a few keys, not a
    flat average (which a wrong key or value would barely move); V, the
    MLP inputs 1/sqrt(fan-in) and the output projections 1/sqrt(fan-in);
    biases and norm offsets 0.1."""
    d, H, KV, D, f, V, L = _dims(cfg)
    qk = 1.7 / math.sqrt(d)
    u = "stack/0_G/"
    return {
        "embed/tok": ((V, d), 1.0),
        "embed/unembed": ((d, V), 1.0 / math.sqrt(d)),
        u + "ln1/scale": ((L, d), 0.1),
        u + "ln2/scale": ((L, d), 0.1),
        u + "attn/wq": ((L, d, H, D), qk),
        u + "attn/wk": ((L, d, KV, D), qk),
        u + "attn/wv": ((L, d, KV, D), 1.0 / math.sqrt(d)),
        u + "attn/wo": ((L, H, D, d), 1.0 / math.sqrt(H * D)),
        u + "attn/bq": ((L, H, D), 0.1),
        u + "attn/bk": ((L, KV, D), 0.1),
        u + "attn/bv": ((L, KV, D), 0.1),
        u + "mlp/wi": ((L, d, 2, f), 1.0 / math.sqrt(d)),
        u + "mlp/wo": ((L, f, d), 1.0 / math.sqrt(f)),
        "ln_f/scale": ((d,), 0.1),
    }


def make_weights(cfg: Dict, seed: int, device, dtype=torch.bfloat16):
    """The weights of ``seed``, on ``device`` in ``dtype``: one normal
    draw a leaf (each layer-stacked leaf is one call) from a generator on
    the device. The same seed gives the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: Dict = {}
    for path, (shape, std) in weight_layout(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        t.normal_(0.0, std, generator=gen)
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (amax to the
    format's largest value), back in float32."""
    scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _rms(x: torch.Tensor, offset: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + offset)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(T, heads, D) at positions 0..T-1."""
    T, _, D = x.shape
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, rows: int = 512) -> torch.Tensor:
    """Causal GQA. q (T, H, D), k and v (T, KV, D); blocks of query rows
    so the score matrix stays small."""
    T, H, D = q.shape
    KV = k.shape[1]
    G = H // KV
    kh = k.permute(1, 0, 2)                       # (KV, T, D)
    vh = v.permute(1, 0, 2)
    out = torch.empty_like(q)
    for r0 in range(0, T, rows):
        r1 = min(r0 + rows, T)
        qb = q[r0:r1].reshape(r1 - r0, KV, G, D).permute(1, 2, 0, 3)
        s = torch.einsum("hgqd,hkd->hgqk", qb, kh[:, :r1]) / math.sqrt(D)
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(r1, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("hgqk,hkd->hgqd", p, vh[:, :r1])
        out[r0:r1] = o.permute(2, 0, 1, 3).reshape(r1 - r0, H, D)
    return out


@contextmanager
def _exact_fp32():
    """TF32 off for the reference's products, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


@torch.no_grad()
def logits_at(cfg: Dict, weights, sequences: Sequence[Sequence[int]],
              first: Sequence[int], precision: str = "fp32"
              ) -> List[torch.Tensor]:
    """For each token sequence, the float32 logits of positions
    ``first[i]`` .. end - 1 (the positions whose next token was served),
    shape (len - first[i], vocab). ``precision``: "fp32" (the reference)
    or "fp8" (the control)."""
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    q8 = _fp8 if precision == "fp8" else (lambda t: t)
    d, H, KV, D, f, V, L = _dims(cfg)
    eps = float(cfg.get("rms_norm_eps", 1e-6))
    theta = float(cfg["rope_theta"])
    dev = weights["embed"]["tok"].device
    unit = weights["stack"]["0_G"]
    with _exact_fp32():
        hs = [weights["embed"]["tok"][torch.as_tensor(
            list(s), dtype=torch.long, device=dev)].float()
            for s in sequences]
        for li in range(L):
            w = {name: q8(unit["attn"][name][li].float())
                 for name in ("wq", "wk", "wv", "wo")}
            b = {name: unit["attn"][name][li].float()
                 for name in ("bq", "bk", "bv")}
            wi = q8(unit["mlp"]["wi"][li].float())
            wo = q8(unit["mlp"]["wo"][li].float())
            ln1, ln2 = unit["ln1"]["scale"][li].float(), \
                unit["ln2"]["scale"][li].float()
            for i, x in enumerate(hs):
                T = x.shape[0]
                a = q8(_rms(x, ln1, eps))
                q = (a @ w["wq"].reshape(d, H * D)).reshape(T, H, D) + b["bq"]
                k = (a @ w["wk"].reshape(d, KV * D)).reshape(T, KV, D) \
                    + b["bk"]
                v = (a @ w["wv"].reshape(d, KV * D)).reshape(T, KV, D) \
                    + b["bv"]
                o = _attention(_rope(q, theta), q8(_rope(k, theta)), q8(v))
                x = x + q8(o.reshape(T, H * D)) @ w["wo"].reshape(H * D, d)
                a = q8(_rms(x, ln2, eps))
                m = torch.nn.functional.silu(a @ wi[:, 0]) * (a @ wi[:, 1])
                hs[i] = x + q8(m) @ wo
            del w, wi, wo
        head = q8(weights["embed"]["unembed"].float())
        lnf = weights["ln_f"]["scale"].float()
        return [q8(_rms(x[s:], lnf, eps)) @ head for x, s in zip(hs, first)]
