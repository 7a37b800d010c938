"""The pre-pool serve engine, frozen as a measured baseline; mirrors
``src/repro/serve/legacy.py``.

Token-at-a-time scheduling (ONE prompt token per dispatch per slot) with
host-resident KV payloads: every prefix-cache hit copies all chain blocks
host→device (``_copy_chain_in``) and every insert copies slot KV
device→host (``_extract_blocks``) into numpy arrays. ``serve.engine.
ServeEngine`` replaces both hot paths (chunked prefill + device-resident
block pool); this module is kept so the equivalence tests can prove
token-identical generations and identical eviction decisions, and so the
old-vs-new gap can be measured on the same workload. Its step is one eager
``decode_step`` and an argmax (the reference jits it; it is not captured
into a CUDA graph here). Do not optimize this file.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models import decode_step, init_decode_cache
from ..models.common import ModelConfig, tree_map, tree_paths
from .engine import Request, resolve_device
from .prefix_store import PrefixStore


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a numpy array (bf16 as its 16-bit patterns,
    which numpy has no type for); a copy on the CPU too, where ``numpy()``
    alone would alias the cache."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).numpy()


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_to_host``, on ``like``'s device and dtype."""
    t = torch.from_numpy(a)
    if like.dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


class LegacyServeEngine:
    """Seed-era engine: per-token prefill, host KV round-trips. Runs on the
    card unless ``device`` asks for another."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 4,
                 max_seq: int = 256, store: Optional[PrefixStore] = None,
                 eos_id: int = -1,
                 device: Union[str, torch.device, None] = None) -> None:
        self.device = resolve_device(device)
        for path, _ in tree_paths(init_decode_cache(cfg, 1, 8,
                                                    device="meta")):
            assert path[-1] in ("k", "v"), (
                "LegacyServeEngine supports uniform-KV patterns; got leaf "
                f"{'/'.join(path)}")
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.B = max_slots
        self.max_seq = max_seq
        self.store = store or PrefixStore(capacity_bytes=1 << 62,
                                          policy="lerc")
        self.eos_id = eos_id
        self.cache = init_decode_cache(cfg, self.B, max_seq,
                                       device=self.device)
        self._rid = itertools.count(1)
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * self.B
        self.steps = 0
        self.decoded_tokens = 0
        self.prefill_tokens = 0
        self.prefill_tokens_skipped = 0

    # ------------------------------------------------------------- requests
    def submit(self, prompt: Sequence[int], max_new: int = 16) -> Request:
        req = Request(next(self._rid), list(prompt), max_new)
        req.prefix_rid = self.store.register_request(prompt)
        self.queue.append(req)
        return req

    # -------------------------------------------------------- cache plumbing
    def _copy_chain_in(self, slot: int, payloads: List[Dict]) -> int:
        """Write resident chain payloads into the slot cache; returns the
        number of prefix tokens restored (host→device copy)."""
        if not payloads:
            return 0
        bt = self.store.block_tokens
        per_leaf: Dict[Tuple[str, ...], List[np.ndarray]] = {}
        for payload in payloads:
            for path, arr in payload.items():
                per_leaf.setdefault(path, []).append(np.asarray(arr))
        n_tok = len(payloads) * bt
        for path, blocks in per_leaf.items():
            leaf = self._leaf(path)
            chain = _from_host(np.concatenate(blocks, axis=-3), leaf)
            leaf[..., slot, 0:n_tok, :, :] = chain
        return n_tok

    def _leaf(self, path):
        node = self.cache
        for p in path:
            node = node[p]
        return node

    def _extract_blocks(self, slot: int, n_tokens: int) -> List[Dict]:
        """Read KV payloads for the first n_tokens of ``slot``, one dict
        per full block (device→host copy)."""
        bt = self.store.block_tokens
        n_blocks = n_tokens // bt
        payloads: List[Dict] = []
        leaves = list(tree_paths(self.cache))
        for j in range(n_blocks):
            t0 = j * bt
            payloads.append({
                path: _to_host(arr[..., slot, t0:t0 + bt, :, :])
                for path, arr in leaves})
        return payloads

    def _block_nbytes(self) -> int:
        bt = self.store.block_tokens
        total = 0
        for _, arr in tree_paths(self.cache):
            nbytes = arr.numel() * arr.element_size()
            per_tok = nbytes // (arr.shape[-3] * self.B)
            total += per_tok * bt
        return total

    # ---------------------------------------------------------------- admit
    def _admit(self) -> None:
        for i in range(self.B):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            usable = self.store.lookup(req.prompt)
            payloads = [n.payload for n in usable]
            restored = self._copy_chain_in(i, payloads) if payloads else 0
            # the last prompt token is always recomputed: its logits seed
            # generation and were never cached (vLLM does the same)
            restored = min(restored, len(req.prompt) - 1)
            req.slot = i
            req.pos = restored
            req.prefill_skipped = restored
            self.prefill_tokens_skipped += restored
            self.slots[i] = req

    # ----------------------------------------------------------------- step
    @torch.no_grad()
    def _step_fn(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        logits, self.cache = decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device))
        return logits[:, -1, :].argmax(-1).int().cpu().numpy()

    def step(self) -> List[Request]:
        """One engine iteration; returns requests that finished."""
        self._admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            return []
        tokens = np.zeros((self.B, 1), np.int32)
        pos = np.zeros((self.B,), np.int32)
        for r in active:
            if r.pos < len(r.prompt):                  # prefill phase
                tokens[r.slot, 0] = r.prompt[r.pos]
                self.prefill_tokens += 1
            else:                                      # decode phase
                tokens[r.slot, 0] = (r.generated[-1] if r.generated
                                     else r.prompt[-1])
                self.decoded_tokens += 1
            pos[r.slot] = r.pos
        out = self._step_fn(tokens, pos)
        self.steps += 1

        finished: List[Request] = []
        for r in active:
            r.pos += 1
            in_decode = r.pos >= len(r.prompt)
            if in_decode:
                r.generated.append(int(out[r.slot]))
            if r.pos == len(r.prompt):
                # prefill complete: publish the prompt's KV chain
                n_pub = len(r.prompt)
                self.store.insert(r.prompt,
                                  self._extract_blocks(r.slot, n_pub),
                                  self._block_nbytes())
            if in_decode and (len(r.generated) >= r.max_new
                              or (self.eos_id >= 0
                                  and r.generated[-1] == self.eos_id)):
                r.done = True
                finished.append(r)
                self.store.complete_request(r.prefix_rid)
                self.slots[r.slot] = None
        return finished

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()

    # -------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, float]:
        m = dict(self.store.metrics())
        m.update({
            "engine_steps": self.steps,
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "decoded_tokens": self.decoded_tokens,
            "prefill_saved_frac": (
                self.prefill_tokens_skipped
                / max(self.prefill_tokens + self.prefill_tokens_skipped, 1)),
        })
        return m
