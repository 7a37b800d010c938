"""repro_torch.configs — model configurations, mirroring
``src/repro/configs/__init__.py``.

Each ``<arch>.py`` exposes ``full()`` (the exact published config) and
``smoke()`` (same family, reduced), with the numbers copied from the
reference. Only the architectures the port runs are listed.
"""
from __future__ import annotations

import importlib

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


def get(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f".{canonical(arch)}", __name__)
    return mod.smoke() if smoke else mod.full()
