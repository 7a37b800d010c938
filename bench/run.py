#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each number
compared beside its limit, which also close standard error). With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Without a card, or with fewer cards
than the cell asks for, or where anything of JAX or the JAX package was
loaded, it exits non-zero and prints no result.

The program's kernel build (``src/repro_torch/kernels/_build``) and every
other compiler cache stay inside the checkout, at fixed paths.
"""
import os
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parent.parent
_CACHE = ROOT / "bench" / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def process_start() -> float:
    """The process's start on the wall clock, from /proc; where that is
    not readable, this module's first line."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        started = int(Path("/proc/self/stat").read_text()
                      .rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return T_START
    return min(T_START, time.time() - (uptime - started))


def main(argv) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_process = process_start()

    import torch

    from bench import harness

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    print(f"device: {harness.power_limit()}", file=sys.stderr)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_process)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: nothing of JAX or the "
              f"JAX package may be loaded", file=sys.stderr)
        return 4
    chk = result["check"]["max_logit_gap"]
    print(f"check max_logit_gap {chk['value']!r} limit {chk['limit']!r}",
          file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
