"""Times the flash-attention kernel's forward (K3, bf16) of a checkout on
one GPU, each call timed alone by CUDA events with a cold L2, as
``chip_smoke.py`` times its kernels: recurrentgemma-9b's L layer and
gemma2-27b's G layer at S=4096 and, where the checkout's K3 takes their
masks, whisper-base's encoder and cross-attention and paligemma-3b's
prefix-LM layer.

    python3 scripts/time_flash_attention.py [SRC ...]

Each SRC is the ``src`` directory of a checkout (default: this one's), and
each is timed in its own process, in the order given, so that two commits
compare on one card in one run: unpack the other commit with ``git
archive`` into a directory ``.gitignore`` lists and pass both, as in
``old/src src src old/src``. Prints the card's name and power limit, then
one JSON line for each SRC (the median and the mean of 20 calls a shape).
Exits non-zero without a GPU."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (B, Sq, Skv, H, KV, D, keyword arguments of the call)
SHAPES = {
    "recurrentgemma_L": (2, 4096, 4096, 16, 1, 256, dict(window=2048)),
    "gemma2_G": (2, 4096, 4096, 32, 16, 128, dict(softcap=50.0)),
    "whisper_enc": (8, 1500, 1500, 8, 8, 64, dict(causal=False)),
    "whisper_cross": (8, 448, 1500, 8, 8, 64, dict(causal=False)),
    "paligemma_prefix": (4, 512, 512, 8, 1, 256, dict(prefix_len=256)),
}


def time_ms(fn, iters: int, flush) -> list:
    """Device times of ``iters`` calls of ``fn``, each after a 64 MiB
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
    return [a.elapsed_time(b) for a, b in evs]


def time_src(src: str) -> dict:
    """K3 of the package under ``src``, at every shape of ``SHAPES`` its
    wrapper takes (a checkout from before the encoder and prefix masks
    takes the first two)."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention_forward
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"src": src}
    for name, (B, Sq, Skv, H, KV, D, kw) in SHAPES.items():
        rng = np.random.default_rng(1)
        q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   .to(dev, torch.bfloat16) for s in
                   [(B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)])
        try:
            t = sorted(time_ms(lambda: flash_attention_forward(q, k, v, **kw),
                               20, flush))
        except (TypeError, ValueError):
            continue                   # an older K3 without this mask
        out[name] = {"median_ms": t[len(t) // 2], "mean_ms": sum(t) / len(t)}
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(time_src(argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_flash_attention: CUDA is not available", file=sys.stderr)
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
