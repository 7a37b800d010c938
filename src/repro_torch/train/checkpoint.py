"""Atomic, async-capable checkpointing; mirrors
``src/repro/train/checkpoint.py`` and keeps its on-disk format byte for
byte, so a checkpoint written by either package loads in the other.

Layout:  <dir>/step_<N>/
           manifest.json        # written LAST: {step, leaves: {name: meta}}
           <name>.bin           # raw little-endian bytes per leaf

A leaf's name is its tree path, keys sorted and joined by ``/``; its file
is the name with ``/`` turned into ``.`` plus ``.bin``; its meta is
``{"file", "shape", "dtype"}`` with numpy's dtype name. A bf16 tensor has
no numpy dtype here, so its bytes go out through an ``int16`` view under
the name ``bfloat16`` (what the reference writes through ``ml_dtypes``)
and come back through ``torch.frombuffer``. Plain Python numbers go
through ``np.asarray`` as in the reference (an ``int`` is ``int64``).

Atomicity: a checkpoint is written into ``step_<N>.tmp-<pid>`` and
``os.rename``d into place only after the manifest lands, so a crash
mid-write never produces a loadable-but-corrupt checkpoint; ``latest()``
ignores directories without a manifest.

The port's train step updates parameters and moments in place
(``optimizer.adamw_update``), so ``AsyncCheckpointer.save`` copies every
tensor before it returns: into pinned host memory from the card (and
waits for the copies), by ``clone`` on the CPU, where ``.cpu()`` would
hand back the live tensor.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (str(k),)))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(leaves: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for name, value in leaves.items():
        parts = name.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _host_bytes(leaf) -> Tuple[np.ndarray, str]:
    """(array whose raw bytes are the leaf's, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, state) -> str:
    """Write one checkpoint synchronously; returns its final path. Leaves
    may be tensors on any device, numpy arrays or Python numbers."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for name, leaf in _flatten(state):
        arr, dtype = _host_bytes(leaf)
        fname = name.replace("/", ".") + ".bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(memoryview(arr.reshape(-1)).cast("B"))
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype


def load(path: str, device: torch.device | str) -> Tuple[int, Any]:
    """Load a checkpoint onto ``device``. Returns (step, state), every leaf
    a tensor. The reference's ``shardings`` (re-laying leaves out onto a
    mesh) has no counterpart on one card."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves: Dict[str, Any] = {}
    for name, meta in manifest["leaves"].items():
        fpath = os.path.join(path, meta["file"])
        buf = bytearray(os.path.getsize(fpath))
        with open(fpath, "rb") as f:
            f.readinto(buf)
        dtype = _torch_dtype(meta["dtype"])
        t = (torch.frombuffer(buf, dtype=dtype) if buf
             else torch.empty(0, dtype=dtype))
        leaves[name] = t.reshape(meta["shape"]).to(device)
    return manifest["step"], _unflatten(leaves)


def latest(ckpt_dir: str) -> Optional[str]:
    """Newest *complete* checkpoint path (manifest present), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        full = os.path.join(ckpt_dir, d)
        if m and os.path.exists(os.path.join(full, "manifest.json")):
            s = int(m.group(1))
            if s > best_step:
                best, best_step = full, s
    return best


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` complete checkpoints, remove the rest."""
    steps = []
    for d in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append((int(m.group(1)), os.path.join(ckpt_dir, d)))
    for _, path in sorted(steps)[:-keep]:
        shutil.rmtree(path)


def _snapshot(state):
    """A private host copy of ``state``: card tensors into pinned host
    memory (waited for), CPU tensors cloned, other leaves as numpy
    arrays. Nothing the train step later updates in place reaches it."""
    on_card = []

    def copy(leaf):
        if not isinstance(leaf, torch.Tensor):
            return np.array(leaf)
        leaf = leaf.detach()
        if leaf.device.type == "cpu":
            return leaf.clone()
        out = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        out.copy_(leaf, non_blocking=True)
        on_card.append(leaf.device)
        return out

    host = _unflatten({name: copy(leaf) for name, leaf in _flatten(state)})
    for dev in set(on_card):
        torch.cuda.synchronize(dev)
    return host


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training: ``save`` snapshots to host
    memory synchronously, serializes on a background thread. At most one
    write is in flight; a new save waits for the previous one (bounded
    memory)."""

    def __init__(self, ckpt_dir: str, keep: int = 3) -> None:
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host_state = _snapshot(state)

        def work():
            try:
                save(self.ckpt_dir, step, host_state)
                gc_old(self.ckpt_dir, self.keep)
            except BaseException as e:      # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
