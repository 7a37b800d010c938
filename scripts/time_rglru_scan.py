"""Times the RG-LRU scan kernel (K5) of a checkout on one GPU: forward and
reverse mode at B=1 and B=2, T=4096, W=4096 (fp32), each call timed alone
by CUDA events with a cold L2, as ``chip_smoke.py`` times its kernels.

    python3 scripts/time_rglru_scan.py [SRC ...]

Each SRC is the ``src`` directory of a checkout (default: this one's), and
each is timed in its own process, in the order given, so that two commits
compare on one card in one run: unpack the other commit with ``git
archive`` into a directory ``.gitignore`` lists and pass both, as in
``old/src src src old/src``. Prints the card's name and power limit, then
one JSON line for each SRC. Exits non-zero without a GPU."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = [(1, 4096, 4096), (2, 4096, 4096)]


def time_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each after a 64 MiB
    write that evicts L2 and a ~1 ms device sleep that lets the host
    enqueue the call before the card reaches it."""
    import torch
    fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


def time_src(src: str) -> dict:
    """K5 of the package under ``src``, at every shape of ``SHAPES``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.rglru_scan import (rglru_scan_forward,
                                                rglru_scan_reverse)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"src": src}
    for B, T, W in SHAPES:
        a = torch.sigmoid(torch.randn((B, T, W), generator=g, device=dev))
        b = torch.randn((B, T, W), generator=g, device=dev)
        dy = torch.randn((B, T, W), generator=g, device=dev)
        y = rglru_scan_forward(a, b)
        out[f"B{B}"] = {
            "forward_ms": time_ms(lambda: rglru_scan_forward(a, b), 20,
                                  flush),
            "reverse_ms": time_ms(lambda: rglru_scan_reverse(a, y, dy), 20,
                                  flush)}
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_src(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_rglru_scan: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    here = Path(__file__).resolve().parent.parent / "src"
    for src in argv or [str(here)]:
        rc = subprocess.run([sys.executable, __file__, "--one",
                             str(Path(src).resolve())]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
