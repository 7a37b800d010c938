"""The comparison that decides ``correct``, at a size a test run holds:
sound runs of each cell pass, the float8 control fails, and a run with
the timed path broken underneath comes out not correct, for each fault a
serving cell can have."""
import time

import pytest
import torch

from conftest import TINY_LIMIT, tiny_cell
from bench import harness

CELLS = ["qwen2-7b.rag-zipf", "qwen1.5-110b-s10.unique-backlog"]


def run(workload, seed, control=False):
    return harness.run_cell(tiny_cell(workload), seed, 4.0, False, "cpu",
                            time.time(), control=control)


@pytest.mark.parametrize("seed", [3, 2**31 + 5, 9876543210])
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload, seed):
    res = run(workload, seed, control=True)
    chk = res["check"]
    assert res["correct"] and res["failed"] == 0
    assert chk["max_logit_gap"]["value"] <= TINY_LIMIT
    assert chk["control_gap"] > TINY_LIMIT
    assert chk["tokens_checked"] >= 64
    if workload.endswith("rag-zipf"):
        assert chk["restored_checked"] >= 1


def _alter_token(monkeypatch):
    """The served token altered where the step produces it."""
    from repro_torch.serve import step_graph
    real = step_graph.StepProgram._run

    def run_and_alter(self, kv, tok):
        real(self, kv, tok)
        self.out.copy_((self.out + 1) % self.cfg.vocab)
        self.prev.copy_(self.out)

    monkeypatch.setattr(step_graph.StepProgram, "_run", run_and_alter)


def _state_unchanged(monkeypatch):
    """The step writes no K or V into the pool: attention reads the state
    as it was."""
    from repro_torch.models import layers

    def attend_only(cfg, q, k, v, kp, vp, tables, lens, cache_pos):
        steps = torch.arange(q.shape[1], dtype=torch.int32)
        tpos = cache_pos[:, None].int() + steps[None, :]
        return layers._paged_attention(cfg, q, kp, vp, tables, tpos), kp, vp

    monkeypatch.setattr(layers, "_paged_write_attend", attend_only)


def _restore_wrong_block(monkeypatch):
    """A prefix hit restores another block's keys and values in place of
    the chain's first block. (Restoring the right blocks in another order
    is no fault: every restored key precedes every new query, and
    attention does not depend on the order of the keys it sees.)"""
    from repro_torch.serve.prefix_store import PrefixStore
    real = PrefixStore.lookup

    def lookup(self, tokens):
        usable = real(self, tokens)
        return usable[1:2] + usable[1:] if len(usable) > 1 else usable

    monkeypatch.setattr(PrefixStore, "lookup", lookup)


FAULTS = [("qwen2-7b.rag-zipf", _alter_token),
          ("qwen1.5-110b-s10.unique-backlog", _alter_token),
          ("qwen2-7b.rag-zipf", _state_unchanged),
          ("qwen1.5-110b-s10.unique-backlog", _state_unchanged),
          ("qwen2-7b.rag-zipf", _restore_wrong_block)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    res = run(workload, 2**31 + 99)
    assert res["check"]["requests_checked"] > 0
    assert res["correct"] is False and res["failed"] > 0


def test_card_run_is_correct(cuda_device):
    """On the card: a short run of the rag cell through the benchmark's
    own command, correct by the configuration's own limit."""
    import json
    import subprocess
    import sys

    from conftest import ROOT
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed",
         "2147483701", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
