"""Train-step builder: loss and gradients → (optional) microbatch
accumulation in fp32 → (optional) cross-pod gradient compression → AdamW;
mirrors ``src/repro/train/step.py``.

Where the reference jits a pure function of the state, the port's step
runs eagerly and updates the state's parameters and moments in place
(``optimizer.adamw_update``); it returns the same state dict. Gradients
come from ``torch.autograd.grad`` on detached leaves, so the parameters
carry no ``.grad``. With ``compress_pod_grads`` the state carries the
error-feedback residuals under ``"ef"`` and AdamW sees the int8 round
trip of each gradient (``compression.compress_grads``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from ..models import init_params, loss_fn, model_spec
from ..models.common import ModelConfig, tree_paths, unflatten
from .compression import compress_grads, ef_init
from .optimizer import OptConfig, adamw_init, adamw_update


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    microbatches: int = 1           # gradient accumulation steps
    compress_pod_grads: bool = False


def make_train_state(cfg: ModelConfig, tc: TrainConfig,
                     generator: torch.Generator,
                     device: torch.device | str) -> Dict[str, Any]:
    """Seeded parameters (``init_params`` from ``generator``, which lives
    on ``device``) in the model dtype, zero AdamW moments and, with
    ``compress_pod_grads``, zero error-feedback residuals."""
    params = init_params(model_spec(cfg), generator, device, dtype=cfg.dtype)
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    if tc.compress_pod_grads:
        state["ef"] = ef_init(params)
    return state


def build_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds (B, S) int tensors on the parameters' device, and metrics are
    0-d tensors {"loss", "grad_norm", "lr"}."""

    def value_and_grad(params, batch):
        """(loss, {path: gradient}) of one (micro)batch; a leaf the loss
        does not use (the encoder-decoder's ``cross_q`` k/v projections)
        gets a zero gradient, as the reference's autodiff gives it."""
        leaves = {path: t.detach().requires_grad_(True)
                  for path, t in tree_paths(params)}
        loss = loss_fn(cfg, unflatten(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves.values(), grads)]
        return loss.detach(), dict(zip(leaves, grads))

    def compute_grads(params, batch):
        k = tc.microbatches
        if k <= 1:
            loss, grads = value_and_grad(params, batch)
            return loss, unflatten(grads)
        loss_sum, gsum = 0.0, {}
        for i in range(k):
            mb = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                  for n, x in batch.items()}
            loss, grads = value_and_grad(params, mb)
            loss_sum = loss_sum + loss
            for path, g in grads.items():
                gsum[path] = (gsum[path] + g.float() if path in gsum
                              else g.float())
        return loss_sum / k, unflatten({path: g / k
                                        for path, g in gsum.items()})

    def train_step(state, batch):
        loss, grads = compute_grads(state["params"], batch)
        if tc.compress_pod_grads:
            grads, state["ef"] = compress_grads(grads, state["ef"])
        params, opt, stats = adamw_update(tc.opt, state["params"], grads,
                                          state["opt"])
        state["params"], state["opt"] = params, opt
        return state, {"loss": loss, **stats}

    return train_step
