"""One process per rank: the serve plane's tensor parallelism and the
training mesh path, at any world size.

``spawn(args, world)`` starts ``python ARGS...`` once a rank, each with
``RANK``, ``WORLD_SIZE`` and the path of a ``FileStore`` for the group's
rendezvous in its environment (and the port's ``src`` on its
``PYTHONPATH``), and waits for them with a deadline: as soon as one rank
fails, or the deadline passes, the others are killed, so a rank that dies
cannot leave its peers blocked in a collective. ``init_rank`` joins this
process to the group those variables describe: a ``FileStore`` when
``spawn`` made it, else ``env://`` (``MASTER_ADDR``/``MASTER_PORT``, as
``torchrun`` sets them); NCCL on CUDA (one card a rank, ``LOCAL_RANK`` or
the rank), gloo on the CPU. ``init_local_group`` makes a one-rank group
of its own over a ``FileStore`` (a (1, 1) mesh on one card).

    python -m repro_torch.launch.ranks MODULE:FUNCTION [ARG ...]

joins the group on the CPU (gloo) and calls ``FUNCTION(*ARGS)``: a rank
entry point for code that is not a launcher, such as the tests' cases
(``repro_torch.launch.serve --tp N`` spawns itself).
"""
from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

STORE_ENV = "REPRO_RANK_STORE"
# the port's src directory, so that a rank imports the same package
SRC = str(Path(__file__).resolve().parents[2])


def spawn(args: Sequence[str], world: int, *, timeout: float,
          env: Optional[dict] = None) -> int:
    """Run ``python args...`` as ranks 0..world-1 of one group and wait.
    Returns 0 when every rank exits 0, else the first failing rank's exit
    code, or 124 when the deadline ``timeout`` (seconds) passed; every
    rank still running then is killed."""
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        procs: List[subprocess.Popen] = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, *args],
                    env={**base, "RANK": str(r), "WORLD_SIZE": str(world),
                         STORE_ENV: os.path.join(tmp, "store")}))
            return _wait(procs, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()


def _wait(procs: List[subprocess.Popen], deadline: float) -> int:
    while True:
        rcs = [p.poll() for p in procs]
        failed = [rc for rc in rcs if rc not in (None, 0)]
        if failed:
            return failed[0]
        if all(rc == 0 for rc in rcs):
            return 0
        if time.monotonic() > deadline:
            return 124
        time.sleep(0.05)


def init_rank(device_type: str, timeout: float = 120.0) -> torch.device:
    """Join this process to the group its environment describes, with
    ``timeout`` seconds for any collective to wait on its peers. Returns
    the rank's device."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kw = dict(backend="nccl" if device_type == "cuda" else "gloo",
              rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout))
    path = os.environ.get(STORE_ENV)
    if path:
        dist.init_process_group(store=dist.FileStore(path, world), **kw)
    else:
        dist.init_process_group(init_method="env://", **kw)
    if device_type != "cuda":
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    torch.cuda.set_device(dev)
    return dev


def init_local_group(device_type: str, timeout: float = 120.0) -> None:
    """A one-rank group of this process's own over a ``FileStore`` in a
    temporary file: NCCL on CUDA, gloo on the CPU."""
    with tempfile.NamedTemporaryFile(prefix="repro-rank-",
                                     delete=False) as f:
        path = f.name
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        store=dist.FileStore(path, 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=timeout))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    module, func = argv[0].split(":")
    init_rank("cpu")
    try:
        getattr(importlib.import_module(module), func)(*argv[1:])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
