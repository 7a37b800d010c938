"""The cases of ``tests/test_torch_tp.py`` as data, and what a run of one
shows; imports no JAX, so a rank of the port runs it
(``python -m repro_torch.launch.ranks torch_tp_ranks:main JOBDIR``) as
well as the test process and the reference's forced-device subprocess.

A case is a dict: ``kind`` ("engine", "frontend" or "refuse"), ``store``
(``{"tiered": bool, **TieredKVStore/PrefixStore kwargs}``), ``faults``
(attach an empty fault plan's injector to the store), ``engine`` (engine
or frontend kwargs), ``shards``, ``requests`` and ``max_new``. ``run``
builds it on one package's ``serve`` module and returns what the test
compares: tokens, the store's three eviction logs, ERC counts, prefill
skipped, steps and ``metrics()`` (per shard for a frontend, with the
replicas' logs), and an engine's host and disk tiers' rows and scales
(``tiers``)."""
from __future__ import annotations

import os
import pickle

import numpy as np


def _store(serve, spec):
    kw = dict(spec)
    if kw.pop("tiered"):
        return serve.TieredKVStore(**kw)
    return serve.PrefixStore(**kw)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {"/".join(path): tree}


def _tier_bytes(store):
    """Every row of the host and disk tiers, with their scales, as flat
    {leaf path: array} dicts (None for a tier the store lacks)."""
    out = {}
    for tier in ("host_pool", "disk_pool"):
        pool = getattr(store, tier, None)
        out[tier] = None if pool is None else (
            {k: np.array(v) for k, v in _flat(pool.buffers).items()},
            None if pool.scales is None else
            {k: np.array(v) for k, v in _flat(pool.scales).items()})
    return out


def _engine_obs(eng, store, rs):
    return {"tokens": [r.generated for r in rs],
            "eviction_log": store.eviction_log,
            "host_eviction_log": getattr(store, "host_eviction_log", None),
            "disk_eviction_log": getattr(store, "disk_eviction_log", None),
            "ref_count": dict(store.state.ref_count),
            "eff_ref_count": dict(store.state.eff_ref_count),
            "prefill_skipped": [r.prefill_skipped for r in rs],
            "steps": eng.steps, "tp": eng.tp,
            "pool_nbytes": eng.pool.nbytes,
            "pool_nbytes_per_device": eng.pool.nbytes_per_device,
            "metrics": eng.metrics()}


def run(serve, cfg, params, case, faults_mod=None, **kw):
    """One case on ``serve`` (a package's ``serve`` module); ``kw`` goes
    to every engine (the port's ``device``, a ``tp``)."""
    if case["kind"] == "refuse":
        try:
            serve.ServeEngine(cfg, params, **case["engine"], **kw)
        except ValueError as e:
            return str(e)
        raise AssertionError("the engine took an indivisible head count")
    if case["kind"] == "frontend":
        fe = serve.ShardedFrontend(cfg, params, case["shards"],
                                   **case["engine"], **kw)
        rs = [fe.submit(r, max_new=case["max_new"])[1]
              for r in case["requests"]]
        fe.run()
        fe.verify_replicas()
        out = {"tokens": [r.generated for r in rs],
               "shards": [_engine_obs(e, e.store, []) for e in fe.shards],
               "replica_logs": [tr.eviction_log for tr in fe.trackers],
               "metrics": fe.metrics()}
        fe.close()
        return out
    store = _store(serve, case["store"])
    if case.get("faults"):
        store.faults = faults_mod.FaultPlan().injector()
    eng = serve.ServeEngine(cfg, params, store=store, **case["engine"], **kw)
    rs = [eng.submit(r, max_new=case["max_new"]) for r in case["requests"]]
    eng.run()
    out = _engine_obs(eng, store, rs)
    out["tiers"] = _tier_bytes(store)
    eng.close()
    return out


def main(jobdir: str) -> None:
    """A rank of the port: every case of ``JOBDIR/job.pkl`` (written by
    the test) on the CPU at the group's tp, its results in
    ``JOBDIR/rank{r}.pkl``."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs, faults, serve
    from repro_torch.models import ModelConfig, params_from_numpy

    with open(os.path.join(jobdir, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    cfg = ModelConfig(**job["cfg"], dtype=torch.float32)
    params = params_from_numpy(job["params"])
    tp = dist.get_world_size()
    out = {}
    for case in job["cases"]:
        if case["kind"] == "refuse":
            out[case["name"]] = run(serve, configs.get(case["arch"],
                                                       smoke=True), {},
                                    case, device="cpu", tp=tp)
        else:
            out[case["name"]] = run(serve, cfg, params, case, faults,
                                    device="cpu", tp=tp)
    with open(os.path.join(jobdir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
