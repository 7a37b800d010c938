"""AdamW with fp32 moments over bf16 parameters, global-norm clipping and
warmup-cosine/linear schedules; mirrors ``src/repro/train/optimizer.py``,
whose math it repeats line for line (``torch.optim.AdamW`` orders weight
decay and bias correction differently).

Memory layout (per parameter): bf16 weight + fp32 m + fp32 v = 10 bytes.
Unlike the reference, which returns new trees, ``adamw_update`` updates
the parameters and moments IN PLACE, one leaf at a time, so the fp32
temporaries of one leaf are all it adds to the state's memory.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..models.common import tree_map, tree_paths


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | linear | constant
    min_lr_frac: float = 0.1
    # moment storage dtype: fp32 (default) or bf16 ("memory-efficient
    # AdamW", halves optimizer state — the update math stays fp32)
    moments_dtype: str = "float32"  # float32 | bfloat16


def schedule_lr(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as an fp32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    if oc.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - oc.warmup_steps)
                        / max(oc.total_steps - oc.warmup_steps, 1),
                        0.0, 1.0)
        if oc.schedule == "cosine":
            decay = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
                1 + torch.cos(math.pi * t))
        else:
            decay = 1.0 - (1 - oc.min_lr_frac) * t
    return oc.lr * warm * decay


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum()
                          for _, l in tree_paths(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, tree), norm


def adamw_init(params, oc: Optional[OptConfig] = None) -> Dict[str, Any]:
    mdt = getattr(torch, oc.moments_dtype if oc else "float32")
    first = next(t for _, t in tree_paths(params))

    def zeros(p):       # laid out as p (a DTensor's placements too)
        return torch.zeros_like(p, dtype=mdt,
                                memory_format=torch.contiguous_format)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def adamw_update(oc: OptConfig, params, grads, opt_state):
    """One AdamW step on ``params`` (updated in place, as are the moments
    in ``opt_state``) with ``grads``, clipped by their global norm first.
    Returns (params, opt_state, stats) with stats {"grad_norm", "lr"}."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / gnorm.clamp_min(1e-9), max=1.0)
    lr = schedule_lr(oc, step)
    b1, b2 = oc.beta1, oc.beta2
    fstep = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=fstep.device), fstep)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=fstep.device), fstep)
    g_flat, m_flat, v_flat = (dict(tree_paths(t)) for t in
                              (grads, opt_state["m"], opt_state["v"]))
    for path, p in tree_paths(params):
        # the reference's expressions, each product and sum rounded as
        # there, computed in place where an operand is not needed again
        g = g_flat[path].float() * scale
        m, v = m_flat[path], v_flat[path]
        mf = m.float().mul_(b1).add_(g * (1 - b1))
        vf = v.float().mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        delta = (mf / bc1).div_((vf / bc2).sqrt_().add_(oc.eps))
        m.copy_(mf)
        v.copy_(vf)
        del mf, vf
        pf = p.float()
        pf.sub_((pf * oc.weight_decay).add_(delta).mul_(lr))
        p.copy_(pf)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}

