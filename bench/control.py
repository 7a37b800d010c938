#!/usr/bin/env python3
"""The check's readings over many seeds, in one process:

    python3 bench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

runs the cell once a seed (its set-up, warm-up and a window of
``--seconds``) and prints one JSON line a seed with ``program``, the
widest logit gap of what the program served (the check's number), and
``control``, the widest gap of the tokens that the reference in float8
e4m3 puts first at the same positions. The limit in the configuration's
``check`` is set between the largest ``program`` reading and the smallest
``control`` one. The benchmark's own runs never read the control.
"""
import sys
import time

import run as entry     # sets the cache directories and the import path


def main(argv) -> int:
    import argparse
    import json

    import torch

    from bench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    manifest = json.loads((entry.ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, args.workload)
    print(f"device: {harness.power_limit()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda", t,
                               control=True)
        chk = res["check"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": chk["max_logit_gap"]["value"],
                          "control": chk["control_gap"],
                          "requests": chk["requests_checked"],
                          "tokens": chk["tokens_checked"],
                          "restored": chk["restored_checked"],
                          "check_s": chk["check_s"],
                          "metrics": res["metrics"]}), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
