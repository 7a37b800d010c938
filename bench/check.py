"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the window finished,
drawn from the seed, is judged by the configuration's plain reference
(``reference/<name>.py``) in float32: the reference runs once over each
prompt followed by its served tokens, and at each served position reads
how far the served token's logit lies below the reference's best. The
number compared is the widest such gap over the sample
(``max_logit_gap``), against the limit in the configuration's ``check``.

The sample holds the longest finished request (prompt and output), at
least one whose prefix came from the store where any did, and then
requests in the seed's order until it holds ``served_tokens`` served
tokens. Greedy decoding (the engine's argmax) makes every served token
the program's best, so the gap is the reference's verdict on it.

The control (``precision="fp8"``): the reference in float8 in the
program's place; at each position of the same prompts and tokens, the gap
of the token the float8 forward puts first.
"""
from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch


@dataclass
class Served:
    prompt: List[int]
    tokens: List[int]           # what the program served, in order
    restored: int               # prompt tokens restored from the store


def load_reference(bench_dir: Path, name: str):
    path = bench_dir / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_reference_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def choose_sample(done: Sequence[Served], seed: int,
                  served_tokens: int) -> List[Served]:
    if not done:
        return []
    order = list(np.random.default_rng(
        np.random.SeedSequence([int(seed), 7])).permutation(len(done)))
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + len(done[i].tokens))
    picks = [longest]
    restored = [i for i in order if done[i].restored > 0]
    if restored and done[longest].restored == 0:
        picks.append(restored[0])
    for i in order:
        if sum(len(done[j].tokens) for j in picks) >= served_tokens:
            break
        if i not in picks:
            picks.append(i)
    return [done[i] for i in picks]


def gaps(ref_logits: Sequence[torch.Tensor],
         chosen: Sequence[torch.Tensor]) -> List[float]:
    """Per sequence, the widest gap between the reference's best logit and
    its logit of the chosen token, over the positions."""
    out = []
    for lg, tok in zip(ref_logits, chosen):
        best = lg.max(dim=-1).values
        got = lg.gather(-1, tok[:, None].long())[:, 0]
        out.append(float((best - got).max()))
    return out


def judge(reference, cfg: Dict, weights, sample: Sequence[Served],
          control: bool = False) -> Dict[str, List[float]]:
    """{"program": per-request widest gap of the served tokens} and, with
    ``control``, {"control": the same of the float8 forward's first
    choices}."""
    if not sample:
        return {"program": [], "control": []}
    seqs = [s.prompt + s.tokens[:-1] for s in sample]
    first = [len(s.prompt) - 1 for s in sample]
    ref = reference.logits_at(cfg, weights, seqs, first, "fp32")
    dev = ref[0].device
    served = [torch.as_tensor(s.tokens, device=dev) for s in sample]
    out = {"program": gaps(ref, served)}
    if control:
        low = reference.logits_at(cfg, weights, seqs, first, "fp8")
        out["control"] = gaps(ref, [lg.argmax(dim=-1) for lg in low])
    return out
