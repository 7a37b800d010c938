"""Mirrors ``src/repro/serve/disk_pool.py`` verbatim (own copy).

Disk-backed KV block pool — tier 2 of the serving data plane.

The cheapest rung of the cost hierarchy: one ``np.memmap`` row file per KV
cache leaf, laid out exactly like ``HostBlockPool``'s buffers
``(*lead, num_blocks, block_tokens, KV, D)``, so host↔disk demotion is a
row copy (plus an optional numpy transcode to a narrower dtype) and the
tiered store's payload stays a single int in every tier. Scale arrays are
tiny (one f32 per row per layer sub-block) and stay in RAM — only the bulk
KV bytes live on disk.

Restoring from this tier costs a page-in + host→device transfer, which the
LERC store prices against prefill recompute: a complete chain here is
still cheaper to promote than to regenerate, an incomplete one is pure
waste — the paper's all-or-nothing property applied to the storage ladder.

With ``directory=None`` the files live in a ``TemporaryDirectory`` owned
by the pool (vanishing with the process); pass ``--disk-dir`` to place
them on a chosen filesystem. The pool never grows; the tiered store's
third eviction index frees rows before the byte budget is exceeded.

``close()`` (or the context manager) tears the row files down
deterministically — memmaps closed, files unlinked, the owned temp
directory removed — instead of leaning on ``TemporaryDirectory``'s
finalizer order at interpreter exit, which is undefined relative to the
memmaps' own finalizers and leaks the files entirely when the operator
supplied ``--disk-dir``.

The pool is also the injection point for disk-tier I/O faults: with a
``repro.faults.FaultInjector`` attached (``self.faults``), ``read_rows``
and ``write_rows`` raise ``OSError`` with the plan's configured
probability — exactly the failure surface a real spindle/NVMe presents —
and ``TieredKVStore`` handles quarantine + degraded fallback above.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

from ..quant import QuantSpec
from .host_pool import HostBlockPool


class DiskBlockPool(HostBlockPool):
    """``HostBlockPool`` whose row buffers are file-backed memmaps.

    Same alloc/free/read_rows/write_rows surface (quantized mode
    included); only ``_alloc_buffer`` differs.
    """

    def __init__(self, cache_template, block_tokens: int, num_blocks: int,
                 quant: Optional[QuantSpec] = None,
                 directory: Optional[str] = None) -> None:
        if directory is None:
            self._tmpdir = tempfile.TemporaryDirectory(
                prefix="repro-kv-disk-")
            directory = self._tmpdir.name
        else:
            os.makedirs(directory, exist_ok=True)
            self._tmpdir = None
        self.directory = directory
        self._n_files = 0
        self._memmaps: list = []
        self._paths: list = []
        self.closed = False
        # repro.faults.FaultInjector (None = healthy disk); attached by
        # TieredKVStore so one seeded generator serves the whole run
        self.faults = None
        super().__init__(cache_template, block_tokens, num_blocks,
                         quant=quant)

    def _alloc_buffer(self, shape, dtype) -> np.ndarray:
        path = os.path.join(self.directory, f"leaf{self._n_files}.kv")
        self._n_files += 1
        if any(d == 0 for d in shape):      # zero-row pool: no file
            return np.zeros(shape, dtype)
        buf = np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        self._memmaps.append(buf)
        self._paths.append(path)
        return buf

    # ------------------------------------------------------------ transfers
    def read_rows(self, idxs):
        if self.faults is not None and self.faults.disk_read_fails():
            raise OSError("injected disk read error")
        return super().read_rows(idxs)

    def write_rows(self, idxs, host_blocks, scales=None) -> None:
        if self.faults is not None and self.faults.disk_write_fails():
            raise OSError("injected disk write error")
        super().write_rows(idxs, host_blocks, scales=scales)

    # ------------------------------------------------------------- lifetime
    def close(self) -> None:
        """Deterministic teardown: close every row-file memmap, unlink the
        files, and remove the owned temp directory. Idempotent; reads or
        writes after close fail (the mmaps are gone), which is the point —
        a closed pool must not silently resurrect its files."""
        if self.closed:
            return
        self.closed = True
        for buf in self._memmaps:
            mm = getattr(buf, "_mmap", None)
            if mm is not None:
                mm.close()
        self._memmaps.clear()
        for path in self._paths:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._paths.clear()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None

    def __enter__(self) -> "DiskBlockPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
