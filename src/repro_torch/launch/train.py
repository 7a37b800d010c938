"""Trainer entry point of the port; mirrors ``src/repro/launch/train.py``
without checkpointing (its ``--ckpt-dir``, ``--ckpt-every``, ``--keep`` and
``--resume`` flags are absent until ``train/checkpoint.py`` is ported).
Runs on the GPU unless ``--device cpu`` is given, and raises without one.

Smoke scale on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma_9b --smoke --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from .. import configs
from ..data import LoaderConfig, TrainLoader
from ..serve import resolve_device
from ..train import OptConfig, TrainConfig, build_train_step, make_train_state


def train_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                         "one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    if not args.smoke:
        print("WARNING: full config on this host — expect OOM; "
              "use the cluster launcher / --smoke locally", file=sys.stderr)
    tc = TrainConfig(opt=OptConfig(lr=args.lr, total_steps=args.steps,
                                   warmup_steps=max(args.steps // 10, 1)),
                     microbatches=args.microbatches)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = make_train_state(cfg, tc, gen, dev)
    loader = TrainLoader(LoaderConfig(global_batch=args.global_batch,
                                      seq_len=args.seq_len, vocab=cfg.vocab,
                                      seed=args.seed))
    step_fn = build_train_step(cfg, tc)

    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in loader.build_batch(step).items()}
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {step:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}  "
                  f"({(time.time()-t0):.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(train_main())
