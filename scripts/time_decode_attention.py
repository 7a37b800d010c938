"""Times the flash-decoding kernel (K2) of a checkout on one GPU, bf16, at
the shapes ``PERF.md``'s table gives it: gemma2-27b's widths (B=8, H=32,
KV=16, D=128, softcap 50) at S=128 with ragged valid lengths and at
S=4096 full, and recurrentgemma-9b's L-layer decode (B=8, S=2048, H=16,
KV=1, D=256); each call timed alone by CUDA events with a cold L2, as
``chip_smoke.py`` times its kernels. Where the checkout's K2 takes
``return_lse``, the call with the log-sum-exp is timed too.

    python3 scripts/time_decode_attention.py [SRC ...]

Each SRC is the ``src`` directory of a checkout (default: this one's), and
each is timed in its own process, in the order given, so that two commits
compare on one card in one run: unpack the other commit with ``git
archive`` into a directory ``.gitignore`` lists and pass both, as in
``old/src src src old/src``. Prints the card's name and power limit, then
one JSON line for each SRC. Exits non-zero without a GPU."""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

# name: (B, S, H, KV, D, softcap, valid lengths)
SHAPES = {
    "S128": (8, 128, 32, 16, 128, 50.0, [80, 128, 1, 96, 33, 64, 127, 5]),
    "S4096": (8, 4096, 32, 16, 128, 50.0, [4096] * 8),
    "recurrentgemma_L": (8, 2048, 16, 1, 256, None,
                         [2048, 1000, 1, 2048, 517, 2048, 33, 1500]),
}


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
    """K2 of the package under ``src``, at every shape of ``SHAPES``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import decode_attention
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    has_lse = "return_lse" in inspect.signature(decode_attention).parameters
    out = {"src": src}
    for name, (B, S, H, KV, D, softcap, valid) in SHAPES.items():
        q = torch.randn((B, H, D), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((B, S, KV, D), generator=g, device=dev)
                .bfloat16() for _ in range(2))
        vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        out[name] = {"ms": time_ms(lambda: decode_attention(
            q, k, v, vl, softcap=softcap), 50, flush)}
        if has_lse:
            out[name]["lse_ms"] = time_ms(lambda: decode_attention(
                q, k, v, vl, softcap=softcap, return_lse=True), 50, flush)
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_src(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_decode_attention: CUDA is not available",
              file=sys.stderr)
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
