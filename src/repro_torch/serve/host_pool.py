"""Host-memory KV block pool — tier 1 of the serving data plane; a port of
``src/repro/serve/host_pool.py``.

Mirrors ``serve.kv_pool.KVBlockPool`` on the host side: one preallocated
host buffer per KV cache leaf, shaped ``(*lead, num_blocks, block_tokens,
KV, D)``, plus a free list of row indices. A demoted prefix-cache block
occupies ONE row across every leaf, so the tiered store's payloads stay
single ints in both tiers.

**Quantized mode**: with a ``quant`` spec the buffers store 1-byte
elements (int8 / float8_e4m3fn) plus one f32 scale per (row,
layer-sub-block), and rows are exchanged with the device pool in
``KVBlockPool.read_rows(quant=...)``'s ``(blocks, scales)`` pair format.
``block_nbytes`` then prices the *transcoded* row — a byte budget buys
``compression_ratio``-times more blocks: the paper's all-or-nothing
property makes complete chains per byte, not raw bytes, the capacity that
matters.

Buffers are numpy arrays in the host storage dtypes of ``quant`` (bf16 as
``uint16``, fp8 as ``uint8``; the bytes the reference's ``ml_dtypes``
arrays hold). With ``pin_memory`` (the engine asks for it when its device
pool is on CUDA) each buffer is a view of a page-locked
``torch.zeros(..., pin_memory=True)`` allocation, kept in ``pinned``; a
failed pinned allocation raises. The tier never grows: its size is the
operator's ``--host-cache-kb`` budget, and the tiered store's second
eviction index frees rows before the byte budget is exceeded (blocks are
uniform-size, so byte-room implies row-room).

Under serve tensor parallelism each rank's tier holds the rank's head
slice of every row (``for_device_pool`` builds it from the device pool's
``tp``), and ``block_nbytes`` stays the global row's price: the budget,
the row count and the byte metrics are those of the tier at tp=1.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import quant as quantlib
from ..models.common import tree_map
from ..quant import QuantSpec
from .kv_pool import (KVBlockPool, _pool_leaf_shape, _row_axis,
                      quant_chain_block_nbytes, rank_template)


class HostBlockPool:
    """Preallocated host-side paged block pool over an engine's KV cache
    tree, optionally storing rows quantized. Rows are exchanged with a
    ``KVBlockPool`` via its ``read_rows``/``write_rows`` stacked-block
    format (the ``(blocks, scales)`` pair variant when quantized)."""

    def __init__(self, cache_template, block_tokens: int, num_blocks: int,
                 quant: Optional[QuantSpec] = None,
                 pin_memory: bool = False) -> None:
        self.block_tokens = block_tokens
        self.num_blocks = max(int(num_blocks), 0)
        self.quant = quant
        self.pin_memory = pin_memory
        self.pinned: List[torch.Tensor] = []    # page-locked allocations
        self.buffers = tree_map(
            lambda leaf: self._alloc_buffer(
                _pool_leaf_shape(leaf.shape, self.num_blocks, block_tokens),
                quant.storage if quant is not None
                else quantlib.storage_dtype(leaf.dtype)),
            cache_template)
        if quant is not None:
            # one f32 scale per (row, *lead) sub-block; tiny, always RAM
            self.scales = tree_map(
                lambda leaf: np.zeros((self.num_blocks,)
                                      + tuple(leaf.shape[:-4]),
                                      quantlib.SCALE_DTYPE),
                cache_template)
        else:
            self.scales = None
        self.block_nbytes = quant_chain_block_nbytes(
            cache_template, block_tokens, quant)
        self.free_list: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.high_water = 0           # max rows ever simultaneously in use

    # subclass hook: DiskBlockPool swaps the allocation for an np.memmap
    def _alloc_buffer(self, shape, dtype) -> np.ndarray:
        if not self.pin_memory:
            return np.zeros(shape, dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) \
            * np.dtype(dtype).itemsize
        raw = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
        self.pinned.append(raw)
        return raw.numpy().view(dtype).reshape(shape)

    @classmethod
    def for_device_pool(cls, cache_template, device_pool: KVBlockPool,
                        capacity_bytes: int,
                        quant: Optional[QuantSpec] = None,
                        **kwargs) -> "HostBlockPool":
        """Size a pool to a byte budget, in whole blocks priced at the
        TRANSCODED row size — the same budget holds ~``itemsize`` times
        more blocks when quantized. ``cache_template`` has the global
        shapes; the rows hold the device pool's head slice of them, priced
        at the global row."""
        blk = quant_chain_block_nbytes(cache_template,
                                       device_pool.block_tokens, quant)
        num = capacity_bytes // max(blk, 1)
        pool = cls(rank_template(cache_template, device_pool.tp),
                   device_pool.block_tokens, num, quant=quant, **kwargs)
        pool.block_nbytes = blk
        return pool

    # -------------------------------------------------------------- indices
    def alloc(self) -> int:
        idx = self.free_list.pop()      # tiered store guarantees room
        self.high_water = max(self.high_water, self.blocks_in_use)
        return idx

    def free(self, idx: int) -> None:
        self.free_list.append(int(idx))

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self.free_list)

    @property
    def bytes_in_use(self) -> int:
        return self.blocks_in_use * self.block_nbytes

    # ------------------------------------------------------------ transfers
    def read_rows(self, idxs: List[int]):
        """Stacked per-leaf copies of rows ``idxs`` (numpy fancy indexing
        copies), row axis leading — the host half of a promotion; feed the
        result to ``KVBlockPool.write_rows``. Quantized pools return the
        ``(blocks, scales)`` pair the device scatter dequantizes from."""
        sel = np.asarray(idxs, np.int64)

        def take(hbuf):
            lead = _row_axis(hbuf)
            return np.moveaxis(np.take(hbuf, sel, axis=lead), lead, 0)

        blocks = tree_map(take, self.buffers)
        if self.quant is None:
            return blocks
        return blocks, tree_map(lambda s: s[sel], self.scales)

    def write_rows(self, idxs: List[int], host_blocks,
                   scales=None) -> None:
        """Store stacked per-leaf block arrays (``KVBlockPool.read_rows``
        output, row axis leading) into rows ``idxs`` — the host half of a
        demotion; values in another dtype are cast to the buffer's.
        Quantized pools additionally store the per-row ``scales`` tree
        the transcoding read produced."""
        assert (scales is None) == (self.quant is None), \
            "scales must accompany writes exactly when the pool quantizes"
        sel = np.asarray(idxs, np.int64)

        def put(hbuf, blk):
            lead = _row_axis(hbuf)
            ix = (slice(None),) * lead + (sel,)
            hbuf[ix] = np.moveaxis(quantlib.as_storage(blk, hbuf.dtype),
                                   0, lead)

        tree_map(put, self.buffers, host_blocks)
        if scales is not None:
            tree_map(lambda sbuf, s: sbuf.__setitem__(sel, s),
                     self.scales, scales)
