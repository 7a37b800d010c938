"""The serve engine's step as one program over static device buffers,
captured into a CUDA graph per step signature on the card; the port's
counterpart of the reference's jitted ``_step_fn``
(``src/repro/serve/engine.py``).

``StepProgram`` owns the step's device state: the previous step's argmax
(``prev``), the EOS mask (``done``), the step's output (``out``), and the
buffers a step's host inputs are copied into: ``tokens`` per chunk width
S, ``meta``, and on the paged plane the block tables per table width NW.
One call uploads a step's inputs and runs the step, which writes its
results in place:

* eagerly (the CPU, or ``capture=False``): the ops run one by one;
* captured (the card's default): a step signature, (S, NW) on the paged
  plane and S on the gather plane, as the reference's jit cache keys on
  the step's shapes, runs eagerly the first time it is seen (the warm-up:
  cuBLAS handles, the kernels' cached plans), is captured into a CUDA
  graph the second time, and replays that graph from then on, so a shape
  seen once never pays for a capture. The graphs share one memory pool
  (they never replay concurrently), and a change of the KV buffers (the
  pool's growth replaces them) drops them all. A capture that fails
  raises: nothing falls back to the eager step.

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
category ``program``, with the signature in the span's args: ``eager``
(a first sighting, or every call of an uncaptured program; counted in
``eager_steps``), ``capture`` (the recording; ``captures``) and
``replay`` (each graph launch, the one right after a capture included;
``replays``). So on a captured program ``eager_steps + replays`` is the
number of calls. ``mode`` is the last call's, and ``signatures`` every
signature seen.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.common import ModelConfig
from ..models.lm import lm_decode_step
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
        self.paged = paged
        self.kv_shard = kv_shard
        self.eos_id = eos_id
        self.device = device
        self.capture = capture
        self.prev = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.done = torch.zeros((slots,), dtype=torch.bool, device=device)
        self.out = torch.zeros((slots,), dtype=torch.int32, device=device)
        self.meta = torch.zeros((5, slots), dtype=torch.int32, device=device)
        self._tokens: Dict[int, torch.Tensor] = {}       # per S
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
        # the last call's: eager / capture / replay, and its signature
        self.mode: Optional[str] = None
        self.key: Optional[Tuple[int, ...]] = None
        # obs: an attached TraceRecorder and the engine's trace pid (None:
        # each span site is one predicate)
        self.trace = None
        self.trace_pid = 0
        self.captured_kernels: Counter = Counter()
        self.replayed_kernels: Counter = Counter()

    def __call__(self, kv, tokens: np.ndarray, meta: np.ndarray,
                 tables: Optional[np.ndarray] = None) -> torch.Tensor:
        """One step: ``tokens`` (B, S) and ``meta`` (5, B) int32 (rows:
        position, real tokens, route ``prev`` into column 0, output counts
        as generated, clear ``done``), and on the paged plane the (B, NW)
        block ``tables`` when they changed (None: the last ones). Returns
        this step's (B,) argmax, a tensor of its own that later steps do
        not overwrite, left on the device."""
        S = tokens.shape[1]
        tok = self._tokens.get(S)
        if tok is None:
            tok = self._tokens[S] = torch.zeros(
                tokens.shape, dtype=torch.int32, device=self.device)
        # from pageable host memory the copy has read its source when it
        # returns, and it does not wait on the steps still on the card
        tok.copy_(torch.from_numpy(tokens), non_blocking=True)
        self.meta.copy_(torch.from_numpy(meta), non_blocking=True)
        if tables is not None:
            NW = tables.shape[1]
            buf = self._tables.get(NW)
            if buf is None:
                buf = self._tables[NW] = torch.zeros(
                    tables.shape, dtype=torch.int32, device=self.device)
            buf.copy_(torch.from_numpy(tables), non_blocking=True)
            self.tables = buf
        if self.capture:
            self._graph_step(kv, tok)
        else:
            self._seen.add(self._key(tok))
            self._eager(kv, tok)
        # a replayed graph writes every step's argmax into the same
        # ``out``: each step hands out a copy for the pipelined readback
        return self.out.clone()

    def _run(self, kv, tok: torch.Tensor) -> None:
        """The step's ops: route ``prev`` into decode feeds, run the model
        (KV written in place), write the argmax into ``out``, fold it into
        ``done`` under the EOS mask, and keep it in ``prev``."""
        meta = self.meta
        pos, lens, use_prev = meta[0], meta[1], meta[2].bool()
        tok[:, 0] = torch.where(use_prev, self.prev, tok[:, 0])
        logits, _ = lm_decode_step(self.cfg, self.params, kv, tok, pos,
                                   seq_lens=lens,
                                   paged_tables=self.tables if self.paged
                                   else None, kv_shard=self.kv_shard)
        self.out.copy_(torch.argmax(logits[:, -1, :], dim=-1))
        if self.eos_id >= 0:
            emit, reset = meta[3].bool(), meta[4].bool()
            self.done.copy_((self.done & ~reset)
                            | (emit & (self.out == self.eos_id)))
        self.prev.copy_(self.out)

    @property
    def signatures(self) -> frozenset:
        """Every step signature seen: (S, NW) on the paged plane, (S,) on
        the gather plane."""
        return frozenset(self._seen)

    def _key(self, tok: torch.Tensor) -> Tuple[int, ...]:
        self.key = ((tok.shape[1], self.tables.shape[1]) if self.paged
                    else (tok.shape[1],))
        return self.key

    def _span(self, name: str):
        key = self.key
        return self.trace.span(name, "program", self.trace_pid, _TID_ENGINE,
                               args={"S": key[0], "NW": key[1]
                                     if len(key) > 1 else None}).begin()

    def _eager(self, kv, tok: torch.Tensor) -> None:
        self.mode = "eager"
        self.eager_steps += 1
        if self.trace is None:
            self._run(kv, tok)
            return
        span = self._span("eager")
        self._run(kv, tok)
        span.end()

    def _graph_step(self, kv, tok: torch.Tensor) -> None:
        if kv is not self._kv:
            # the graphs read the KV buffers they were captured on
            self._graphs.clear()
            self._pool = None
            self._kv = kv
        key = self._key(tok)
        entry = self._graphs.get(key)
        self.mode = "replay"
        if entry is None:
            if key not in self._seen:
                self._seen.add(key)
                self._eager(kv, tok)
                return
            span = None if self.trace is None else self._span("capture")
            entry = self._graphs[key] = self._record(
                lambda: self._run(kv, tok))
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
