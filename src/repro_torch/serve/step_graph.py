"""The serve engine's step as one program over static device buffers,
captured into a CUDA graph per step signature on the card; the port's
counterpart of the reference's jitted ``_step_fn``
(``src/repro/serve/engine.py``).

``StepProgram`` owns the step's device state: the previous step's argmax
(``prev``), the EOS mask (``done``), the step's output (``out``), and the
buffers a step's host inputs are copied into, one for each feed's shape,
and on the paged plane the block tables per table width NW. One call
uploads a step's feed and runs the step, which writes its results in
place. The two planes take different feeds:

* the paged plane a ``PackedFeed`` (``pack_feed``): the step's tokens as
  packed rows, a decoding slot's one token and a prefilling slot's chunk,
  each row with its slot's position, pool write and place in K1's query
  tile, padded to T rows: B when the step feeds at most B tokens, else the
  next multiple of the prefill chunk (at most the B x S rows of the dense
  grid); ``models.lm_packed_step`` runs it;
* the gather plane a ``DenseFeed``: a (B, S) grid of every slot's tokens
  right-padded to the widest feed S, and per-slot meta; its per-slot
  caches are indexed by (slot, position), and its rolling-window layers by
  ``pos % window``, so it keeps the grid (``lm_decode_step``).

Each call runs:

* eagerly (the CPU, or ``capture=False``): the ops run one by one;
* captured (the card's default): a step signature, (T, S, NW) on the
  paged plane (rows, K1's tile width: 1 when every fed slot feeds one
  token, else the chunk, and table width) and (S,) on the gather plane, as
  the reference's jit cache keys on the step's shapes, runs eagerly the
  first time it is seen (the warm-up: cuBLAS handles, the kernels' cached
  plans), is captured into a CUDA graph the second time, and replays that
  graph from then on, so a shape seen once never pays for a capture. The
  graphs share one memory pool (they never replay concurrently), and a
  change of the KV buffers (the pool's growth replaces them) drops them
  all. A capture that fails raises: nothing falls back to the eager step.

Under serve tensor parallelism (``kv_shard``) the step holds the
attention's all-gather over heads, and a captured graph holds the
collective with it: the context warmed its group up by an eager
collective when it was made, and a signature's first, eager run comes
before its capture. The gather's output lives in the graph's memory pool,
so a replay still overwrites only buffers the program owns.

A kernel wrapper counts its launches on the host where it launches, so
its ``launches`` counts the eager steps' launches and, once for each
capture, the launch it records into the graph; a replay calls no
wrapper. What a replay launches is read from the graph itself: each
capture lists its graph's kernel nodes by kernel name (``graph_kernels``,
through libcuda's graph calls), summed in ``captured_kernels``, and each
replay adds its graph's list to ``replayed_kernels``.

How each call ran is counted and, with a recorder attached
(``ServeEngine.attach_trace``), spanned on the engine lane under the
category ``program``, with the signature in the span's args (``T``,
``S``, ``NW``; T and NW None on the gather plane): ``eager`` (a first
sighting, or every call of an uncaptured program; counted in
``eager_steps``), ``capture`` (the recording; ``captures``) and
``replay`` (each graph launch, the one right after a capture included;
``replays``). So on a captured program ``eager_steps + replays`` is the
number of calls. ``mode`` is the last call's, and ``signatures`` every
signature seen. ``rows_real`` counts the token rows the calls fed and
``rows_run`` the rows they computed (T, or B x S on the gather plane).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..models.common import ModelConfig
from ..models.layers import PackedRows
from ..models.lm import lm_decode_step, lm_packed_step
from ..obs.trace import TID_ENGINE as _TID_ENGINE

# CUgraphNodeType (cuda.h)
_KERNEL_NODE, _CHILD_GRAPH_NODE = 0, 4


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h, CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_kernels(raw_graph: int) -> Counter:
    """{kernel name (mangled): nodes} of a CUDA graph (a ``cudaGraph_t``,
    child graphs included), read with libcuda's graph calls: the kernels
    every replay of the graph launches."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(result: int) -> None:
        if result:
            name = ctypes.c_char_p()
            cu.cuGetErrorName(result, ctypes.byref(name))
            raise RuntimeError(f"libcuda call failed: {name.value}")

    graph, n = ctypes.c_void_p(raw_graph), ctypes.c_size_t()
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)))
    kernels: Counter = Counter()
    for node in map(ctypes.c_void_p, nodes):
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        if kind.value == _CHILD_GRAPH_NODE:
            child = ctypes.c_void_p()
            check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)))
            kernels += graph_kernels(child.value)
        elif kind.value == _KERNEL_NODE:
            p, name = _KernelNodeParams(), ctypes.c_char_p()
            check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)))
            # a node holds a function of the context or a context-free
            # kernel, whichever the launch named
            if p.func:
                check(cu.cuFuncGetName(ctypes.byref(name),
                                       ctypes.c_void_p(p.func)))
            else:
                check(cu.cuKernelGetName(ctypes.byref(name),
                                         ctypes.c_void_p(p.kern)))
            kernels[name.value.decode()] += 1
    return kernels


@dataclass
class DenseFeed:
    """The gather plane's step: ``tokens`` (B, S) int32, each slot's feed
    right-padded to the widest S, and ``meta`` (5, B) int32 (rows:
    position, real tokens, route ``prev`` into column 0, output counts as
    generated, clear ``done``)."""
    tokens: np.ndarray
    meta: np.ndarray

    @property
    def key(self) -> Tuple[int, ...]:
        return (self.tokens.shape[1],)

    @property
    def real(self) -> int:
        return int(self.meta[1].sum())

    @property
    def run(self) -> int:
        return self.tokens.size


@dataclass
class PackedFeed:
    """The paged plane's step on ``T`` packed token rows (``pack_feed``):
    ``data`` one int32 array, laid out as ``unpack`` reads it; ``S`` K1's
    tile width; ``real`` the rows that carry a token."""
    data: np.ndarray
    T: int
    S: int
    real: int

    @property
    def key(self) -> Tuple[int, ...]:
        return (self.T, self.S)

    @property
    def run(self) -> int:
        return self.T


def packed_rows(B: int, chunk: int, n: np.ndarray) -> Tuple[int, int]:
    """(T, S) of a step whose fed slots feed ``n`` tokens each: K1's tile
    width S is 1 when every one feeds one token, else the chunk (or the
    widest feed, should one be wider); the rows T are B up to B tokens,
    else the next multiple of the chunk, and never more than the B x S'
    rows of the dense grid over the same feeds (S' the widest feed)."""
    total, widest = int(n.sum()), int(n.max())
    S = 1 if widest == 1 else max(chunk, widest)
    if total <= B:
        return B, S
    return min(-(-total // chunk) * chunk, B * widest), S


def pack_feed(B: int, chunk: int, bt: int, tables: np.ndarray,
              slot: np.ndarray, pos: np.ndarray, n: np.ndarray,
              route: np.ndarray, emit: np.ndarray, reset: np.ndarray,
              tokens: np.ndarray) -> PackedFeed:
    """The packed feed of a paged step, built over whole arrays. The F fed
    slots, in slot order: ``slot``, their first ``pos``ition, the ``n``
    tokens each feeds, ``route`` (a decoding slot: its token is the last
    step's argmax, routed on the device), ``emit`` (its output counts as
    generated); ``tokens`` (sum n,) every fed token in that order (a
    routed one a placeholder); ``reset`` (B,) the slots whose ``done``
    clears; ``tables`` (B, NW) the block tables, for each row's pool
    write. With S = 1 row b is slot b (an unfed slot's row is padding);
    else the rows are the feeds one after another, then padding."""
    T, S = packed_rows(B, chunk, n)
    real = int(n.sum())
    start = np.cumsum(n) - n
    tslot = np.repeat(slot, n)
    col = np.arange(real) - np.repeat(start, n)
    tpos = np.repeat(pos, n) + col
    row = slot if S == 1 else np.arange(real)
    data = np.zeros(B * S + 4 * B + 6 * T + 1, np.int32)
    qpos = data[:B * S].reshape(B, S)
    last, rte, emt, rst = data[B * S:B * S + 4 * B].reshape(4, B)
    (rpos, wrow, woff, tile,
     back) = data[B * S + 4 * B:-T - 1].reshape(5, T)
    tok = data[-T - 1:]
    qpos[tslot, col] = tpos
    last[slot] = row[start + n - 1]
    # a decoding slot's one row takes the argmax; every other slot's goes
    # one past the rows
    rte[:] = T
    rte[slot[route]] = row[start[route]]
    emt[slot] = emit
    rst[:] = reset
    rpos[row] = tpos
    wrow[row] = tables[tslot, tpos // bt]
    woff[row] = tpos % bt
    tile[:] = B * S
    tile[row] = back[row] = tslot * S + col
    tok[row] = tokens
    return PackedFeed(data, T, S, real)


def unpack(buf: torch.Tensor, B: int, T: int, S: int,
           tables: torch.Tensor):
    """The parts of a packed feed's buffer (``pack_feed``'s layout), as
    views: the tokens (T + 1: the last takes the routes of the slots that
    do not decode), the rows' ``PackedRows``, and per slot the route (the
    row its argmax goes into), emit and reset rows."""
    qpos = buf[:B * S].view(B, S)
    last, route, emit, reset = buf[B * S:B * S + 4 * B].view(4, B)
    pos, wrow, woff, tile, back = buf[B * S + 4 * B:-T - 1].view(5, T)
    rows = PackedRows(pos=pos, write=(wrow, woff), tile=tile, back=back,
                      qpos=qpos, tables=tables, last=last)
    return buf[-T - 1:], rows, route, emit, reset


class StepProgram:
    """One batched decode step of ``slots`` rows over the KV tree it is
    handed (the pool's buffers on the paged plane, the per-slot caches on
    the gather plane), on ``device``; ``capture`` runs it as CUDA graphs
    (card only); ``kv_shard`` runs the paged attention on this rank's
    heads."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, paged: bool,
                 eos_id: int, device: torch.device, capture: bool,
                 kv_shard=None) -> None:
        self.cfg = cfg
        self.params = params
        self.B = slots
        self.paged = paged
        self.kv_shard = kv_shard
        self.eos_id = eos_id
        self.device = device
        self.capture = capture
        self.prev = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.done = torch.zeros((slots,), dtype=torch.bool, device=device)
        self.out = torch.zeros((slots,), dtype=torch.int32, device=device)
        # the gather plane's per-slot meta (the paged plane's is in its
        # packed feed)
        self.meta = None if paged else torch.zeros(
            (5, slots), dtype=torch.int32, device=device)
        # per feed key: the gather plane's (B, S) tokens, the paged plane's
        # packed feed
        self._feeds: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._tables: Dict[int, torch.Tensor] = {}       # per NW
        self.tables: Optional[torch.Tensor] = None       # the current NW's
        self._seen: set = set()
        # per signature: the graph and its kernel nodes by name
        self._graphs: Dict[Tuple[int, ...], tuple] = {}
        self._kv = None              # the KV tree the graphs were taken on
        self._pool = None
        self.eager_steps = 0
        self.captures = 0
        self.replays = 0
        self.rows_real = 0
        self.rows_run = 0
        # the last call's: eager / capture / replay, and its signature
        self.mode: Optional[str] = None
        self.key: Optional[Tuple[int, ...]] = None
        # obs: an attached TraceRecorder and the engine's trace pid (None:
        # each span site is one predicate)
        self.trace = None
        self.trace_pid = 0
        self.captured_kernels: Counter = Counter()
        self.replayed_kernels: Counter = Counter()

    def __call__(self, kv, feed: Union[PackedFeed, DenseFeed],
                 tables: Optional[np.ndarray] = None) -> torch.Tensor:
        """One step of ``feed`` (a ``PackedFeed`` on the paged plane, a
        ``DenseFeed`` on the gather plane), and on the paged plane the (B,
        NW) block ``tables`` when they changed (None: the last ones).
        Returns this step's (B,) argmax, a tensor of its own that later
        steps do not overwrite, left on the device."""
        src = feed.data if self.paged else feed.tokens
        buf = self._feeds.get(feed.key)
        if buf is None:
            buf = self._feeds[feed.key] = torch.zeros(
                src.shape, dtype=torch.int32, device=self.device)
        # from pageable host memory the copy has read its source when it
        # returns, and it does not wait on the steps still on the card
        buf.copy_(torch.from_numpy(src), non_blocking=True)
        if not self.paged:
            self.meta.copy_(torch.from_numpy(feed.meta), non_blocking=True)
        if tables is not None:
            NW = tables.shape[1]
            tab = self._tables.get(NW)
            if tab is None:
                tab = self._tables[NW] = torch.zeros(
                    tables.shape, dtype=torch.int32, device=self.device)
            tab.copy_(torch.from_numpy(tables), non_blocking=True)
            self.tables = tab
        self.key = feed.key + ((self.tables.shape[1],) if self.paged
                               else ())
        self.rows_real += feed.real
        self.rows_run += feed.run
        if self.capture:
            self._graph_step(kv, buf)
        else:
            self._seen.add(self.key)
            self._eager(kv, buf)
        # a replayed graph writes every step's argmax into the same
        # ``out``: each step hands out a copy for the pipelined readback
        return self.out.clone()

    def _run(self, kv, buf: torch.Tensor) -> None:
        """The step's ops: route ``prev`` into the decoding slots' rows,
        run the model (KV written in place), write the argmax into
        ``out``, fold it into ``done`` under the EOS mask, and keep it in
        ``prev``."""
        if self.paged:
            T, S, _ = self.key
            tok, rows, route, emit, reset = unpack(buf, self.B, T, S,
                                                   self.tables)
            tok[route] = self.prev
            logits, _ = lm_packed_step(self.cfg, self.params, kv, tok[:-1],
                                       rows, kv_shard=self.kv_shard)
        else:
            meta = self.meta
            pos, lens, use_prev = meta[0], meta[1], meta[2].bool()
            buf[:, 0] = torch.where(use_prev, self.prev, buf[:, 0])
            logits, _ = lm_decode_step(self.cfg, self.params, kv, buf, pos,
                                       seq_lens=lens)
            emit, reset = meta[3], meta[4]
        self.out.copy_(torch.argmax(logits[:, -1, :], dim=-1))
        if self.eos_id >= 0:
            self.done.copy_((self.done & ~reset.bool())
                            | (emit.bool() & (self.out == self.eos_id)))
        self.prev.copy_(self.out)

    @property
    def signatures(self) -> frozenset:
        """Every step signature seen: (T, S, NW) on the paged plane, (S,)
        on the gather plane."""
        return frozenset(self._seen)

    @property
    def key_args(self) -> Dict[str, Optional[int]]:
        """The last call's signature by name: T, S and NW (T and NW None
        on the gather plane)."""
        key = self.key
        return ({"T": key[0], "S": key[1], "NW": key[2]} if self.paged
                else {"T": None, "S": key[0], "NW": None})

    def _span(self, name: str):
        return self.trace.span(name, "program", self.trace_pid, _TID_ENGINE,
                               args=self.key_args).begin()

    def _eager(self, kv, buf: torch.Tensor) -> None:
        self.mode = "eager"
        self.eager_steps += 1
        if self.trace is None:
            self._run(kv, buf)
            return
        span = self._span("eager")
        self._run(kv, buf)
        span.end()

    def _graph_step(self, kv, buf: torch.Tensor) -> None:
        if kv is not self._kv:
            # the graphs read the KV buffers they were captured on
            self._graphs.clear()
            self._pool = None
            self._kv = kv
        key = self.key
        entry = self._graphs.get(key)
        self.mode = "replay"
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                self._eager(kv, buf)
                return
            span = None if self.trace is None else self._span("capture")
            entry = self._graphs[key] = self._record(
                lambda: self._run(kv, buf))
            if span is not None:
                span.end()
            self.captured_kernels.update(entry[1])
            self.captures += 1
            self.mode = "capture"
        graph, kernels = entry
        if self.trace is None:
            graph.replay()
        else:
            span = self._span("replay")
            graph.replay()
            span.end()
        self.replays += 1
        self.replayed_kernels.update(kernels)

    def _record(self, fn) -> tuple:
        """Capture ``fn`` into a CUDA graph in the program's memory pool:
        (the graph, its kernel nodes by name). A capture that fails raises
        with the process as it was before it: PyTorch's capture context,
        when the capture ends in error, leaves its own stream current and
        the CUDA generators in capture mode (every later random op would
        raise), so the caller's stream is made current again and a
        capture that ends cleanly takes the generators out of capture
        mode."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # kept after capture, so that its nodes can be read
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.current_stream()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                fn()
        except BaseException:
            torch.cuda.set_stream(stream)
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                torch.zeros(1, device=self.device)
            raise
        finally:
            torch.cuda.set_stream(stream)
        return graph, graph_kernels(graph.raw_cuda_graph())
