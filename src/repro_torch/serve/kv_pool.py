"""Device-resident paged KV block pool; mirrors
``src/repro/serve/kv_pool.py`` (its untiered, unsharded half).

The serving data plane's ONLY KV storage: one preallocated device buffer
per KV cache leaf, shaped ``(*lead, num_blocks, block_tokens, KV, D)``
(with ``lead`` the leaf's leading layer-stack axes), plus a host-side free
list and per-row reference counts. A ``PrefixStore`` payload is ONE
``int`` — the pool row holding that chain block's KV for every layer.

The paged engine decodes straight out of the pool via per-slot block
tables: a prefix hit is a host-side table write, publish transfers
ownership of already-written rows to the store (``share``), and eviction
drops a reference — rows are reclaimed when the last referent (store, or
an engine slot still reading the row) lets go. The model writes rows in
place; ``copy_row`` is the only copy the engine issues. The gather engine
(the fallback for rolling-window layer patterns) copies chains pool→slot
on a hit (``gather_into``) and slot→pool on publish (``scatter_from``);
every row then has exactly one referent. When the free list runs dry under
an unbounded-capacity store the pool doubles.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from ..models.common import tree_map, tree_paths


def _pool_leaf_shape(leaf_shape: Tuple[int, ...], num_blocks: int,
                     block_tokens: int) -> Tuple[int, ...]:
    """Cache leaf (*lead, B, S, KV, D) -> pool (*lead, nb, bt, KV, D)."""
    return tuple(leaf_shape[:-4]) + (num_blocks, block_tokens) \
        + tuple(leaf_shape[-2:])


def _row_axis(pbuf: torch.Tensor) -> int:
    """The row axis of a pool leaf (after any layer-stack lead axes)."""
    return pbuf.ndim - 4


def _leaves(tree) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_paths(tree)]


def chain_block_nbytes(cache_template, block_tokens: int) -> int:
    """Bytes of ONE chain block across every KV leaf of ``cache_template``
    (leaves shaped (*lead, B, S, KV, D); meta tensors will do) — the
    store's nbytes_per_block. The single source of truth for pool sizing
    AND byte accounting, equal to the reference's count."""
    return sum(leaf.numel() * leaf.element_size()
               // (leaf.shape[-4] * leaf.shape[-3]) * block_tokens
               for leaf in _leaves(cache_template))


class KVBlockPool:
    """Refcounted paged block pool over an engine's KV cache tree, its
    buffers on ``device``. ``cache_template`` gives the leaves' shapes and
    dtypes (meta tensors will do)."""

    def __init__(self, cache_template, block_tokens: int,
                 num_blocks: int, device: torch.device | str) -> None:
        self.block_tokens = block_tokens
        self.num_blocks = max(int(num_blocks), 1)
        self.device = torch.device(device)
        self.buffers = tree_map(
            lambda leaf: torch.zeros(
                _pool_leaf_shape(leaf.shape, self.num_blocks, block_tokens),
                dtype=leaf.dtype, device=self.device),
            cache_template)
        self.free_list: List[int] = list(range(self.num_blocks - 1, -1, -1))
        self.refs: List[int] = [0] * self.num_blocks
        self.block_nbytes = chain_block_nbytes(cache_template, block_tokens)
        self.high_water = 0           # max rows ever simultaneously in use

    # -------------------------------------------------------------- indices
    def alloc(self) -> int:
        if not self.free_list:
            self._grow()
        idx = self.free_list.pop()
        self.refs[idx] = 1
        self.high_water = max(self.high_water, self.blocks_in_use)
        return idx

    def share(self, idx: Any) -> int:
        """Take another reference on a live row (a slot's block table
        entry, or store ownership at publish). Returns the row."""
        idx = int(idx)
        assert self.refs[idx] > 0, f"share of free row {idx}"
        self.refs[idx] += 1
        return idx

    def free(self, idx: Any) -> None:
        """Drop one reference; the row returns to the free list when the
        last referent (store or engine slot) lets go."""
        idx = int(idx)
        self.refs[idx] -= 1
        assert self.refs[idx] >= 0, f"double free of row {idx}"
        if self.refs[idx] == 0:
            self.free_list.append(idx)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self.free_list)

    @property
    def nbytes(self) -> int:
        """Pool bytes (the quantity the store's byte budget prices)."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in _leaves(self.buffers))

    def _grow(self) -> None:
        """Double the pool (unbounded-capacity stores never evict, so the
        byte budget cannot free indices for us)."""
        old = self.num_blocks
        self.num_blocks = old * 2
        self.buffers = tree_map(
            lambda pbuf: torch.cat([pbuf, torch.zeros_like(pbuf)],
                                   dim=_row_axis(pbuf)),
            self.buffers)
        self.free_list.extend(range(self.num_blocks - 1, old - 1, -1))
        self.refs.extend([0] * old)

    # ------------------------------------------------------------ transfers
    def gather_into(self, cache, slot: int, idxs: List[int]):
        """Restore chain blocks ``idxs`` into ``slot``'s cache rows at token
        positions [0, n*bt), in place; returns the cache. Device-to-device
        only. (Gather-engine hit path.)"""
        rows = torch.tensor(idxs, dtype=torch.long, device=self.device)
        n = len(idxs)
        for leaf, pbuf in zip(_leaves(cache), _leaves(self.buffers)):
            ax = _row_axis(pbuf)
            blocks = pbuf.index_select(ax, rows)   # (*lead, n, bt, KV, D)
            chain = blocks.reshape(blocks.shape[:ax]
                                   + (n * self.block_tokens,)
                                   + blocks.shape[-2:])
            leaf.select(ax, slot).narrow(ax, 0, chain.shape[ax]).copy_(chain)
        return cache

    def scatter_from(self, cache, slot: int, block_positions: List[int],
                     idxs: List[int]) -> None:
        """Capture the blocks at chain positions ``block_positions`` of
        ``slot``'s cache into pool rows ``idxs``. A block's start is
        clamped so the block fits the leaf, as the reference's
        ``dynamic_slice`` clamps it: a rolling-window leaf narrower than
        the chain gives its first ``bt`` slots for every late block.
        Device-to-device only. (Gather-engine publish path.)"""
        bt = self.block_tokens
        rows = torch.tensor(idxs, dtype=torch.long, device=self.device)
        starts = torch.tensor([p * bt for p in block_positions],
                              dtype=torch.long, device=self.device)
        steps = torch.arange(bt, device=self.device)
        for leaf, pbuf in zip(_leaves(cache), _leaves(self.buffers)):
            ax = _row_axis(pbuf)
            width = leaf.shape[ax + 1]
            tok = starts.clamp(0, width - bt)[:, None] + steps[None, :]
            row = leaf.select(ax, slot)             # (*lead, S, KV, D)
            blocks = row.index_select(ax, tok.reshape(-1))
            pbuf.index_copy_(ax, rows, blocks.reshape(
                blocks.shape[:ax] + (len(idxs), bt) + blocks.shape[-2:]))

    def copy_row(self, src: int, dst: int) -> None:
        """One-row device copy (paged-engine copy-on-write)."""
        for pbuf in _leaves(self.buffers):
            ax = _row_axis(pbuf)
            pbuf.select(ax, dst).copy_(pbuf.select(ax, src))
