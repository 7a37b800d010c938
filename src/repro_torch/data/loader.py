"""Per-host training loader; a verbatim copy of ``src/repro/data/loader.py``.

Deterministic sharding, prefetch, resume, and work-stealing straggler
mitigation.

Determinism contract: batch content is a pure function of
``(seed, step, host_id, n_hosts)`` — restarting from a checkpoint at step
k replays exactly the batches k, k+1, ... regardless of how many times the
process died in between (tests/test_data.py proves bitwise equality).

Straggler mitigation: block preparation fans out over a small thread pool
with a shared work queue — a slow block (cold cache, disk re-read) never
blocks its siblings; idle workers steal the remaining work. Prefetch keeps
``prefetch_depth`` batches ahead of the training loop.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


@dataclass(frozen=True)
class LoaderConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    prefetch_depth: int = 2
    n_workers: int = 2          # block-preparation threads (work stealing)


class SyntheticTokenSource:
    """Deterministic synthetic corpus: block ``i`` is a pure function of
    (seed, i). Stands in for a tokenized shard on NFS/GCS; the LERC cache
    sits between this and the device feed (examples/train_lm.py)."""

    def __init__(self, vocab: int, block_tokens: int, seed: int = 0) -> None:
        self.vocab = vocab
        self.block_tokens = block_tokens
        self.seed = seed

    def block(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        return rng.integers(0, self.vocab, self.block_tokens,
                            dtype=np.int32)


class TrainLoader:
    """Yields {tokens, targets} host-local batches.

    ``fetch_block(step, slot)`` is pluggable so the LERC-managed pipeline
    executor can sit underneath (examples/train_lm.py wires that up); the
    default reads the synthetic source directly.
    """

    def __init__(self, cfg: LoaderConfig,
                 fetch_block: Optional[Callable[[int, int], np.ndarray]]
                 = None) -> None:
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self.source = SyntheticTokenSource(cfg.vocab,
                                           (cfg.seq_len + 1), cfg.seed)
        self._fetch = fetch_block or self._default_fetch
        self._queue: "queue.Queue" = queue.Queue(cfg.prefetch_depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._next_step = 0

    # ---------------------------------------------------------------- state
    def state_dict(self) -> Dict:
        return {"next_step": self._next_step}

    def load_state_dict(self, state: Dict) -> None:
        self._next_step = int(state["next_step"])

    # --------------------------------------------------------------- blocks
    def _global_slot(self, step: int, slot: int) -> int:
        """Unique block index for (step, row-of-global-batch)."""
        return step * self.cfg.global_batch \
            + self.cfg.host_id * self.local_batch + slot

    def _default_fetch(self, step: int, slot: int) -> np.ndarray:
        return self.source.block(self._global_slot(step, slot))

    def build_batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for ``step`` (work-stealing thread pool)."""
        rows: List[Optional[np.ndarray]] = [None] * self.local_batch
        work: "queue.Queue" = queue.Queue()
        for s in range(self.local_batch):
            work.put(s)
        errors: List[BaseException] = []

        def worker():
            while True:
                try:
                    s = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    rows[s] = self._fetch(step, s)
                except BaseException as e:   # surfaced to the caller
                    errors.append(e)

        n = min(self.cfg.n_workers, self.local_batch)
        threads = [threading.Thread(target=worker) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        seqs = np.stack(rows)                       # (B_loc, seq+1)
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "targets": seqs[:, 1:].astype(np.int32)}

    # -------------------------------------------------------------- iterate
    def _producer(self) -> None:
        step = self._next_step
        while not self._stop.is_set():
            batch = self.build_batch(step)
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._stop.clear()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        try:
            while True:
                step, batch = self._queue.get()
                self._next_step = step + 1
                yield batch
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # drain so the producer can observe the stop flag
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None
