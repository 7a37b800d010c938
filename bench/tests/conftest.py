"""Shared pieces of the benchmark's CPU tests: the import path, and each
cell of ``BENCHMARK.json`` cut to a size a CPU test run holds (two layers
of width 64, four slots, eight short documents) with the program's plain
versions underneath."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

# The check's limit at this size, set as the cells' own limits are, from
# readings on the CPU over seeds 1-12 of each cell (4 s windows): the
# program's widest logit gap read 0 to 0.014 (rag-zipf) and 0 to 0.033
# (unique-backlog); the float8 control's 0.156 to 0.419 and 0.200 to
# 0.398. The limit lies between 0.033 and 0.156, nearer the geometric
# mean, with more room above the lower reading.
TINY_LIMIT = 0.08


def tiny_cell(workload: str, manifest=None) -> harness.Cell:
    manifest = manifest or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve_cell(manifest, workload)
    c = copy.deepcopy(cell.config)
    c.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
             num_key_value_heads=2, num_hidden_layers=2, vocab_size=512,
             store_blocks=24)
    c["program"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        d_head=16, d_ff=128, vocab=512)
    c["serve"].update(max_slots=4, max_seq=512, prefill_chunk=16)
    c["check"].update(max_logit_gap=TINY_LIMIT, served_tokens=64)
    t = copy.deepcopy(cell.traffic)
    if t.get("documents"):
        t["documents"].update(count=8, tokens=[64, 128])
        t.update(question_tokens=[8, 32], output_tokens=[4, 16])
        t["arrival"]["rate_per_s"] = 4.0
    else:
        t.update(question_tokens=[32, 96], output_tokens=[8, 24])
    t["block"] = 16
    cell.config, cell.traffic = c, t
    return cell


@pytest.fixture
def cuda_device():
    """Skips a card-only test where there is no card (decided here, not
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
