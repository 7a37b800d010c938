"""repro_torch.configs — model configurations, mirroring
``src/repro/configs/__init__.py``.

Each ``<arch>.py`` exposes ``full()`` (the exact published config) and
``smoke()`` (same family, reduced), with the numbers copied from the
reference.

``SHAPES`` are the assigned input shapes; ``cells()`` enumerates the
(arch x shape) grid of the dry run with the reference's skips:
``long_500k`` needs sub-quadratic decode state, so it runs only for the
hybrid/ssm archs (+ gemma2, whose decode step is O(L) with half the layers
window-bounded).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..models.common import ModelConfig

ARCH_IDS = [
    "codeqwen1_5_7b",
    "gemma2_27b",
    "llama4_maverick_400b_a17b",
    "moonshot_v1_16b_a3b",
    "paligemma_3b",
    "qwen1_5_110b",
    "qwen2_7b",
    "recurrentgemma_9b",
    "rwkv6_3b",
    "whisper_base",
]


# aliases accepted on the CLI (--arch qwen2-7b etc.)
def canonical(arch: str) -> str:
    a = arch.replace("-", "_").replace(".", "_")
    if a not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return a


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}

# archs whose decode state is sub-quadratic enough for the 500k cell
_LONG_OK = {"recurrentgemma_9b", "rwkv6_3b", "gemma2_27b"}

# the reference's order of the architectures, which ``cells()`` walks
CELL_ORDER = [
    "recurrentgemma_9b",
    "qwen1_5_110b",
    "codeqwen1_5_7b",
    "gemma2_27b",
    "qwen2_7b",
    "paligemma_3b",
    "moonshot_v1_16b_a3b",
    "llama4_maverick_400b_a17b",
    "whisper_base",
    "rwkv6_3b",
]


def get(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(arch)}", __name__)
    return mod.smoke() if smoke else mod.full()


def cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) pair exercised by the dry-run."""
    out: List[Tuple[str, str]] = []
    for a in CELL_ORDER:
        for s in SHAPES:
            if s == "long_500k" and a not in _LONG_OK:
                continue
            out.append((a, s))
    return out


def skipped_cells() -> List[Tuple[str, str, str]]:
    return [(a, "long_500k",
             "pure full attention at 524288: quadratic prefill; skipped per "
             "assignment (DESIGN.md §5)")
            for a in CELL_ORDER if a not in _LONG_OK]
