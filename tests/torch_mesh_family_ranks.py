"""The port's side of ``tests/test_torch_mesh_families.py``; imports no JAX.

``main(jobdir)`` is a rank of a (2, 2) mesh over four gloo ranks
(``python -m repro_torch.launch.ranks torch_mesh_family_ranks:main
JOBDIR``). For each case of ``JOBDIR/job.pkl`` (an arch's smoke config in
f32, optionally with ``overrides``, the reference's weights as numpy):

* ``"loss"``: the loss and the full gradients of a batch on the mesh;
* ``"decode"``: a prompt fed a token a step through ``decode_step`` at one
  shared position, then greedy tokens, on the mesh: the cache made
  meshless (zeros, or for the encoder-decoder the prefill of the case's
  frames) and laid out by ``cache_pspec``; every step's logits and the
  greedy tokens.

Rank 0 writes ``JOBDIR/port_families.pkl``.
"""
from __future__ import annotations

import pickle
from pathlib import Path


def smoke_config(configs, arch, overrides, dtype):
    """``arch``'s smoke config with a case's overrides, in ``dtype``, from
    either package's ``configs`` module."""
    return configs.get(arch, smoke=True).replace(dtype=dtype, **overrides)


def _loss(case, cfg, mc):
    import numpy as np
    import torch

    from repro_torch.models import loss_fn, model_spec, params_from_numpy
    from repro_torch.models.common import tree_map, tree_paths, unflatten

    spec = model_spec(cfg)
    params = tree_map(lambda t, s: mc.distribute(t, mc.param_sharding(s)),
                      params_from_numpy(case["params"]), spec)
    batch = {k: mc.distribute(torch.from_numpy(v), mc.placements(
        mc.batch_pspec(v.shape))) for k, v in case["batch"].items()}
    leaves = {p: t.detach().requires_grad_(True)
              for p, t in tree_paths(params)}
    loss = loss_fn(cfg, mc.constrain_tree(unflatten(leaves), spec), batch,
                   mesh_ctx=mc)
    # whisper's cross_q wk/wv are in the tree but unused, as in the
    # reference, whose gradient of them is zero
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return {"loss": float(loss.full_tensor()),
            "grads": {"/".join(p): (np.zeros(t.shape, np.float32)
                                    if g is None else
                                    g.full_tensor().numpy())
                      for (p, t), g in zip(leaves.items(), grads)}}


def _decode(case, cfg, mc):
    import torch

    from repro_torch.models import (decode_step, init_decode_cache,
                                    model_spec, params_from_numpy)
    from repro_torch.models.common import tree_map, tree_paths, unflatten
    from repro_torch.models.encdec import encdec_prefill_cache, encode

    whole = params_from_numpy(case["params"])
    prompt = torch.from_numpy(case["prompt"])
    B, P = prompt.shape
    max_seq = case["max_seq"]
    with torch.no_grad():
        if case.get("frames") is not None:
            enc = encode(cfg, whole, torch.from_numpy(case["frames"]))
            cache = encdec_prefill_cache(cfg, whole, enc, B, max_seq)
        else:
            cache = init_decode_cache(cfg, B, max_seq, device="cpu")
    params = tree_map(lambda t, s: mc.distribute(t, mc.param_sharding(s)),
                      whole, model_spec(cfg))
    cache = unflatten({path: mc.distribute(leaf, mc.placements(
        mc.cache_pspec(path, tuple(leaf.shape))))
        for path, leaf in tree_paths(cache)})
    placements = {"/".join(path): [str(pl) for pl in leaf.placements]
                  for path, leaf in tree_paths(cache)}
    logits, tokens = [], []
    tok = prompt[:, :1]
    with torch.no_grad():
        for pos in range(P + case["new"]):
            if pos < P:
                tok = prompt[:, pos:pos + 1]
            out, _ = decode_step(cfg, params, cache, mc.distribute(
                tok, mc.placements(mc.batch_pspec(tuple(tok.shape)))), pos,
                mesh_ctx=mc)
            last = mc.gather_seq(out[:, -1]).full_tensor()
            logits.append(last.numpy())
            tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
            if pos >= P - 1:
                tokens.append(tok[:, 0].tolist())
    return {"logits": logits, "tokens": tokens, "placements": placements}


def main(jobdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_debug_mesh_context

    job = pickle.loads(Path(jobdir, "job.pkl").read_bytes())
    mc = make_debug_mesh_context((2, 2))
    out = {}
    for case in job["cases"]:
        cfg = smoke_config(configs, case["arch"], case["overrides"],
                           torch.float32)
        run = _loss if case["kind"] == "loss" else _decode
        out[case["name"]] = run(case, cfg, mc)
    if dist.get_rank() == 0:
        Path(jobdir, "port_families.pkl").write_bytes(pickle.dumps(out))

