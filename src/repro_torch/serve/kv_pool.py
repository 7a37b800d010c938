"""Device-resident paged KV block pool; mirrors
``src/repro/serve/kv_pool.py``.

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

The tiered store moves rows to and from the host (``read_rows``,
``write_rows``): one gather (and an on-device quantize) and ONE
device→host copy a demotion batch, ONE host→device copy and an in-place
scatter (``index_copy_``) a promotion batch. Rows are written in place,
so the CUDA graphs of the engine's step, which hold the buffers by
address, stay valid across promotions. Every transfer runs on the
current stream, after the steps already queued on it: a demotion reads
the rows those steps wrote, and the host reads its copy only once the
copy has landed.

Under serve tensor parallelism (``shard_ctx``, a ``sharding.KVShardCtx``)
each rank's buffers hold its ``KV/tp`` heads of every leaf; row indices,
refcounts and the free list stay rank-invariant, and every byte count the
store prices (``block_nbytes``, ``nbytes``) is the global one, so every
rank's store makes the decisions of the reference's. ``read_rows`` and
``write_rows`` move the rank's head slice; a quantizing read scales each
(row, layer) block by its amax over the group (the spec the engine binds
to the context), as the whole block scales at tp=1.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import quant as quantlib
from ..models.common import tree_map, tree_paths, unflatten
from ..quant import QuantSpec


def _pool_leaf_shape(leaf_shape: Tuple[int, ...], num_blocks: int,
                     block_tokens: int) -> Tuple[int, ...]:
    """Cache leaf (*lead, B, S, KV, D) -> pool (*lead, nb, bt, KV, D)."""
    return tuple(leaf_shape[:-4]) + (num_blocks, block_tokens) \
        + tuple(leaf_shape[-2:])


def rank_template(cache_template, tp: int):
    """``cache_template``'s leaves (*lead, B, S, KV, D) as meta tensors of
    one tensor-parallel rank's ``KV/tp`` heads."""
    return tree_map(
        lambda leaf: torch.empty(
            tuple(leaf.shape[:-2]) + (leaf.shape[-2] // tp, leaf.shape[-1]),
            dtype=leaf.dtype, device="meta"),
        cache_template)


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


def quant_chain_block_nbytes(cache_template, block_tokens: int,
                             spec: Optional[QuantSpec]) -> int:
    """Bytes of ONE *transcoded* chain block: narrow payload plus one f32
    scale per (layer-stack) sub-block of every leaf. This is the number a
    quantized tier's byte budget divides by."""
    if spec is None:
        return chain_block_nbytes(cache_template, block_tokens)
    total = 0
    for leaf in _leaves(cache_template):
        lead_numel = 1
        for d in leaf.shape[:-4]:
            lead_numel *= d
        block_numel = (lead_numel * block_tokens
                       * leaf.shape[-2] * leaf.shape[-1])
        total += (spec.itemsize * block_numel
                  + quantlib.SCALE_DTYPE.itemsize * lead_numel)
    return total


def _aligned(n: int) -> int:
    """``n`` bytes rounded up to 16, so every tensor packed into one byte
    buffer starts aligned for any element width."""
    return -(-n // 16) * 16


def _to_host(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host arrays (storage dtypes) of device ``tensors``: on the card ONE
    device→host copy of all of them, packed into one byte buffer, into
    page-locked memory, waited on before the arrays are handed out; on the
    CPU the tensors' own memory (they are fresh copies already)."""
    if not tensors or tensors[0].device.type == "cpu":
        return [quantlib.to_host(t.contiguous()) for t in tensors]
    parts, offs, total = [], [], 0
    for t in tensors:
        raw = t.contiguous().view(-1).view(torch.uint8)
        pad = _aligned(raw.numel()) - raw.numel()
        parts.append(raw)
        if pad:
            parts.append(raw.new_zeros(pad))
        offs.append(total)
        total += raw.numel() + pad
    flat = torch.cat(parts)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    # the copy is queued behind the steps on the stream; wait for it
    # before the host reads a byte
    torch.cuda.current_stream(flat.device).synchronize()
    buf = host.numpy()
    out = []
    for t, off in zip(tensors, offs):
        dt = quantlib.storage_dtype(t.dtype)
        n = t.numel() * t.element_size()
        out.append(buf[off:off + n].view(dt).reshape(tuple(t.shape)))
    return out


def _to_device(arrays: List[np.ndarray], dtypes: List[torch.dtype],
               device: torch.device) -> List[torch.Tensor]:
    """Tensors of ``dtypes`` on ``device`` from host ``arrays`` (storage
    dtypes, values cast where a dtype differs): on the card ONE
    host→device copy from a fresh page-locked buffer, which PyTorch's host
    allocator keeps until the copy has run; on the CPU the arrays' own
    memory where no cast is needed."""
    arrays = [quantlib.as_storage(a, quantlib.storage_dtype(d))
              for a, d in zip(arrays, dtypes)]
    if device.type == "cpu":
        # a read-only array (a memmap opened for reading, an array of
        # another framework) is copied: torch shares only writable memory
        return [quantlib.from_host(np.ascontiguousarray(a) if a.flags.writeable
                                   else a.copy()) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += _aligned(a.nbytes)
    host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for a, off in zip(arrays, offs):
        buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a
    flat = host.to(device, non_blocking=True)
    return [flat[off:off + a.nbytes].view(d).view(a.shape)
            for a, d, off in zip(arrays, dtypes, offs)]


class KVBlockPool:
    """Refcounted paged block pool over an engine's KV cache tree, its
    buffers on ``device``. ``cache_template`` gives the leaves' global
    shapes and dtypes (meta tensors will do); with ``shard_ctx`` the
    buffers hold this rank's head slice of them."""

    def __init__(self, cache_template, block_tokens: int,
                 num_blocks: int, device: torch.device | str,
                 shard_ctx=None) -> None:
        self.block_tokens = block_tokens
        self.num_blocks = max(int(num_blocks), 1)
        self.device = torch.device(device)
        self.shard_ctx = shard_ctx
        if shard_ctx is not None:
            for leaf in _leaves(cache_template):
                if leaf.shape[-2] % shard_ctx.tp:
                    raise ValueError(
                        f"KV pool leaf with {leaf.shape[-2]} KV heads "
                        f"cannot shard over tp={shard_ctx.tp}")
        self.buffers = tree_map(
            lambda leaf: torch.zeros(
                _pool_leaf_shape(leaf.shape, self.num_blocks, block_tokens),
                dtype=leaf.dtype, device=self.device),
            rank_template(cache_template, self.tp))
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
    def tp(self) -> int:
        return self.shard_ctx.tp if self.shard_ctx is not None else 1

    @property
    def nbytes(self) -> int:
        """GLOBAL pool bytes, summed over every rank (the quantity the
        store's byte budget prices)."""
        return self.nbytes_per_device * self.tp

    @property
    def nbytes_per_device(self) -> int:
        """Bytes this rank's device holds: ``nbytes / tp``."""
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
        A leaf narrower than one block raises ``TypeError``, as the
        reference's ``dynamic_slice`` does, checked from the shapes before
        any device op. Device-to-device only. (Gather-engine publish
        path.)"""
        bt = self.block_tokens
        for path, leaf in tree_paths(cache):
            width = leaf.shape[_row_axis(leaf) + 1]
            if width < bt:
                name = "/".join(map(str, path))
                raise TypeError(
                    f"cache leaf {name!r} keeps a window of {width} tokens, "
                    f"narrower than the store's block of {bt} tokens: give "
                    f"the store blocks of at most {width} tokens")
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

    # ------------------------------------------------- host-tier transfers
    def read_rows(self, idxs: List[int], quant: Optional[QuantSpec] = None):
        """Copy pool rows ``idxs`` to host memory: one gather per leaf,
        then ONE device→host copy of the stacked result. Returns a tree of
        host arrays shaped ``(len(idxs), *lead, bt, KV, D)`` (bf16 as
        ``uint16``, see ``quant``).

        With ``quant`` the gather *transcodes*: rows quantize on device
        (per-layer-per-block f32 scales over each leaf's trailing
        ``(bt, KV, D)`` axes) and the return value is a ``(blocks,
        scales)`` pair of trees — only 1-byte elements plus the tiny
        scale arrays cross the device boundary."""
        rows = torch.tensor(idxs, dtype=torch.long, device=self.device)
        paths = [p for p, _ in tree_paths(self.buffers)]
        stacked = [pbuf.index_select(_row_axis(pbuf), rows)
                   .movedim(_row_axis(pbuf), 0)
                   for pbuf in _leaves(self.buffers)]
        if quant is None:
            return unflatten(dict(zip(paths, _to_host(stacked))))
        pairs = [quantlib.quantize_blocks(b, quant) for b in stacked]
        host = _to_host([q for q, _ in pairs] + [s for _, s in pairs])
        n = len(pairs)
        return (unflatten(dict(zip(paths, host[:n]))),
                unflatten(dict(zip(paths, host[n:]))))

    def write_rows(self, idxs: List[int], host_blocks,
                   scales=None) -> None:
        """Scatter host-side stacked block arrays (the tree ``read_rows``
        returns) into pool rows ``idxs``: ONE host→device copy of the
        whole batch (with ``scales``, the narrow bytes and the scales),
        the dequantize on device when ``scales`` is given, then an
        in-place ``index_copy_`` per leaf into the existing buffers."""
        rows = torch.tensor(idxs, dtype=torch.long, device=self.device)
        pbufs = _leaves(self.buffers)
        blocks = _leaves(host_blocks)
        if scales is None:
            dev = _to_device(blocks, [p.dtype for p in pbufs], self.device)
        else:
            sc = _leaves(scales)
            qdtypes = [quantlib.logical_dtype(b.dtype) for b in blocks]
            dev = _to_device(blocks + sc,
                             qdtypes + [torch.float32] * len(sc),
                             self.device)
            n = len(blocks)
            dev = [quantlib.dequantize_blocks(q, s, p.dtype)
                   for q, s, p in zip(dev[:n], dev[n:], pbufs)]
        for pbuf, blk in zip(pbufs, dev):
            ax = _row_axis(pbuf)
            pbuf.index_copy_(ax, rows, blk.movedim(0, ax))
