"""The last families of the port's mesh path against the reference, on the
CPU: the R and W layers, the encoder-decoder, and decode caches whose
``cache_pspec`` shards the sequence, merged across ranks through K2's
log-sum-exp.

* Loss and full gradients on four gloo ranks, a (2, 2) mesh, against the
  reference on four forced CPU devices (a (2, 2) ``Auto`` mesh), f32
  smoke, the reference's weights carried across by ``params_from_numpy``:
  recurrentgemma (R and L layers), rwkv6 (W layers), whisper (MHA, heads
  over model) and whisper with three heads (the context-parallel
  fallback in the decoder, its cross-attention included).
* Decode on the same mesh, caches laid out by ``cache_pspec``: a prompt a
  token a step, then greedy tokens; every step's logits and the tokens
  against the reference's. qwen2 (one KV head: its G cache shards the
  sequence), recurrentgemma (the rolling L cache shards the sequence, run
  past its wrap; R state over the width), rwkv6 (``S`` over heads),
  whisper (heads over model) and whisper with three heads (self and cross
  caches shard the sequence). The first steps' valid lengths end inside
  rank 0's slice.
* The merge on the CPU: the plain K2 log-sum-exp against one of
  ``_sdpa``'s scores, and two or four plain partials merged against the
  plain version over the whole cache, empty slices included.

The reference runs in subprocesses (this file as a script, an arch's
cases each) and the port's ranks in theirs
(``tests/torch_mesh_family_ranks.py``), all started at once, each with a
deadline.
"""
import math
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_family_ranks as R  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.sharding import MeshContext as JaxMeshContext  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain, merge_partials)
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 300.0            # seconds for any spawned process
TOL = 2e-4                  # the port's f32 parity bar
BATCH = (2, 24)
# whisper smoke with three heads: 3 does not divide the model axis, so the
# decoder takes the context-parallel fallback and the caches shard the
# sequence
H3 = {"n_heads": 3, "n_kv_heads": 3}
# (name, arch, overrides)
LOSS_CASES = [("recurrentgemma_9b", "recurrentgemma_9b", {}),
              ("rwkv6_3b", "rwkv6_3b", {}),
              ("whisper_base", "whisper_base", {}),
              ("whisper_base_h3", "whisper_base", H3)]
# (name, arch, overrides, prompt tokens, greedy tokens, max_seq)
DECODE_CASES = [("qwen2_7b", "qwen2_7b", {}, 5, 6, 16),
                ("recurrentgemma_9b", "recurrentgemma_9b", {}, 6, 18, 32),
                ("rwkv6_3b", "rwkv6_3b", {}, 5, 6, 16),
                ("whisper_base", "whisper_base", {}, 5, 6, 16),
                ("whisper_base_h3", "whisper_base", H3, 5, 6, 16)]
ARCHS = sorted({c[1] for c in LOSS_CASES + DECODE_CASES})


def _jax_cfg(arch, overrides):
    return R.smoke_config(jax_configs, arch, overrides, jnp.float32)


def _frames(cfg, rng):
    return rng.standard_normal((BATCH[0], cfg.frontend_len,
                                cfg.d_model)).astype(np.float32)


def _job():
    cases = []
    for kind, specs in (("loss", LOSS_CASES), ("decode", DECODE_CASES)):
        for name, arch, ov, *rest in specs:
            cfg = _jax_cfg(arch, ov)
            params = jax.device_get(jax_init_params(
                jax.random.key(0), jax_model_spec(cfg), dtype=jnp.float32))
            rng = np.random.default_rng(4)
            case = {"kind": kind, "name": f"{name}:{kind}", "arch": arch,
                    "overrides": ov, "params": params}
            if kind == "loss":
                case["batch"] = {k: rng.integers(0, cfg.vocab, BATCH)
                                 .astype(np.int32)
                                 for k in ("tokens", "targets")}
                if cfg.frontend == "audio_frames":
                    case["batch"]["frames"] = _frames(cfg, rng)
            else:
                prompt, new, max_seq = rest
                case.update(prompt=rng.integers(
                    0, cfg.vocab, (BATCH[0], prompt)).astype(np.int32),
                    new=new, max_seq=max_seq,
                    frames=(_frames(cfg, rng)
                            if cfg.frontend == "audio_frames" else None))
            cases.append(case)
    return {"cases": cases}


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        **kw)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return env


def _finish(proc, what):
    try:
        out, err = proc.communicate(timeout=DEADLINE)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{what} passed its deadline of {DEADLINE} s:\n{err}")
    assert proc.returncode == 0, f"{what} failed:\n{err[-4000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (one process an arch, four forced devices each) and
    the port's four gloo ranks, started at once; then wait for all."""
    jobdir = tmp_path_factory.mktemp("families")
    (jobdir / "job.pkl").write_bytes(pickle.dumps(_job()))
    procs = {
        f"reference {arch}": subprocess.Popen(
            [sys.executable, __file__, str(jobdir), arch], text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for arch in ARCHS}
    rc = {}
    spawner = threading.Thread(target=lambda: rc.update(ranks=ranks.spawn(
        ["-m", "repro_torch.launch.ranks", "torch_mesh_family_ranks:main",
         str(jobdir)], 4, timeout=DEADLINE, env=_env())))
    spawner.start()
    for name, p in procs.items():
        _finish(p, name)
    spawner.join(DEADLINE)
    assert not spawner.is_alive(), "the ranks' spawner passed its deadline"
    assert rc["ranks"] == 0, f"a rank of the port failed: {rc}"
    ref = {}
    for arch in ARCHS:
        ref.update(pickle.loads((jobdir / f"ref_{arch}.pkl").read_bytes()))
    return {"ref": ref, "port": pickle.loads(
        (jobdir / "port_families.pkl").read_bytes())}


def _spread(a, b):
    """The largest difference of a and b over b's largest magnitude (at
    least 1)."""
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / max(
        1.0, float(np.abs(b).max()))


def _close(got, want, what, bar=TOL):
    assert _spread(got, want) <= bar, (what, _spread(got, want), bar)


# ------------------------------------------------------- loss and grads


@pytest.mark.parametrize("name", [c[0] for c in LOSS_CASES])
def test_mesh_loss_and_grads_match_reference(runs, name):
    got = runs["port"][f"{name}:loss"]
    want = runs["ref"][f"{name}:loss"]
    _close(got["loss"], want["loss"], "loss")
    assert set(got["grads"]) == set(want["grads"])
    for path, g in want["grads"].items():
        _close(got["grads"][path], g, path)


# --------------------------------------------------------------- decode


@pytest.mark.parametrize("name", [c[0] for c in DECODE_CASES])
def test_mesh_decode_matches_reference(runs, name):
    got = runs["port"][f"{name}:decode"]
    want = runs["ref"][f"{name}:decode"]
    assert len(got["logits"]) == len(want["logits"])
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        _close(a, b, f"logits at step {step}")
    assert got["tokens"] == want["tokens"]


# the decode caches' layouts on the (2, 2) mesh: (leaf, placements); S(n)
# on the model axis at a KV leaf's sequence dim is a sequence-sharded
# cache, which the merge serves
LAYOUTS = {
    "qwen2_7b": {"stack/0_G/k": ["S(1)", "S(2)"]},
    "recurrentgemma_9b": {"stack/2_L/k": ["S(1)", "S(2)"],
                          "stack/0_R/h": ["S(1)", "S(2)"],
                          "tail_0_R/conv": ["S(0)", "S(2)"]},
    "rwkv6_3b": {"stack/0_W/S": ["S(1)", "S(2)"],
                 "stack/0_W/tm_shift": ["S(1)", "R"]},
    "whisper_base": {"k": ["S(1)", "S(3)"], "ck": ["S(1)", "S(3)"]},
    "whisper_base_h3": {"k": ["S(1)", "S(2)"], "ck": ["S(1)", "S(2)"]},
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_decode_cache_layouts_exercise_the_merge(runs, name):
    """The cases reach what they are meant to: sequence-sharded G, L, self
    and cross caches, R state over the width, W state over heads."""
    got = runs["port"][f"{name}:decode"]["placements"]
    for leaf, want in LAYOUTS[name].items():
        assert got[leaf] == want, (leaf, got[leaf])


def test_rolling_case_runs_past_the_wrap():
    name, arch, ov, prompt, new, max_seq = DECODE_CASES[1]
    window = _jax_cfg(arch, ov).window
    assert min(window, max_seq) < prompt + new


# ------------------------------------------------------- the merge (CPU)


def _inputs(B=3, S=40, H=4, KV=2, D=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((B, S, KV, D), generator=g)
    v = torch.randn((B, S, KV, D), generator=g)
    # one row that sees the whole cache, one whose valid length ends in
    # the first slice, and one that sees nothing
    valid = torch.tensor([S, 7, 0], dtype=torch.int32)
    return q, k, v, valid


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_plain_lse_is_the_logsumexp_of_sdpa_scores(softcap):
    q, k, v, valid = _inputs()
    cfg = R.smoke_config(configs, "qwen2_7b",
                         {"attn_logit_softcap": softcap}, torch.float32)
    out, lse = decode_attention_plain(q, k, v, valid, softcap=softcap,
                                      return_lse=True)
    B, H, D = q.shape
    KV, S = k.shape[2], k.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q.reshape(B, KV, H // KV, D),
                     k) / math.sqrt(D)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        s = c * torch.tanh(s / c)
    seen = torch.arange(S)[None, :] < valid[:, None].long()
    want = torch.where(seen[:, None, None], s, -math.inf).logsumexp(-1)
    torch.testing.assert_close(lse, want.reshape(B, H), rtol=0, atol=2e-6)
    assert torch.isneginf(lse[2]).all() and (out[2] == 0).all()
    # the rows' outputs are _sdpa's where they see a key
    mask = seen[:, None, None, :]
    sd = TL._sdpa(cfg, q[:, None], k, v, mask)[:, 0]
    torch.testing.assert_close(out[:2], sd[:2], rtol=0, atol=2e-6)
    # the wrapper takes the plain version on CPU tensors
    w_out, w_lse = decode_attention(q, k, v, valid, softcap=softcap,
                                    return_lse=True)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("window", [None, 12])
def test_merged_partials_equal_the_whole_cache(n, window):
    q, k, v, valid = _inputs()
    whole, whole_lse = decode_attention_plain(q, k, v, valid, window,
                                              softcap=30.0, return_lse=True)
    S = k.shape[1]
    outs, lses = [], []
    for r in range(n):
        s0, s1 = r * S // n, (r + 1) * S // n
        # the slice's own valid length, and its window bound in slice
        # coordinates: keys [valid - window, valid)
        hi = (valid.long() - s0).clamp(0, s1 - s0)
        part = decode_attention_plain(
            q, k[:, s0:s1].contiguous(), v[:, s0:s1].contiguous(),
            hi.int(), softcap=30.0, return_lse=True)
        if window is not None:
            lo = (valid.long() - window - s0).clamp(0, s1 - s0)
            kpos = torch.arange(s1 - s0)[None, :]
            seen = (kpos >= lo[:, None]) & (kpos < hi[:, None])
            part = _masked_plain(q, k[:, s0:s1], v[:, s0:s1], seen)
        outs.append(part[0])
        lses.append(part[1])
    # a row no slice but the first sees: every other partial weighs 0
    assert torch.isneginf(torch.stack(lses)[1:, 1]).all()
    out, lse = merge_partials(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(out, whole, rtol=0, atol=2e-6)
    torch.testing.assert_close(lse, whole_lse, rtol=0, atol=2e-6)
    assert not torch.isnan(out).any() and (out[2] == 0).all()
    assert torch.isneginf(lse[2]).all()


def _masked_plain(q, k, v, seen):
    """(out, lse) of the plain version's arithmetic over keys ``seen``
    (B, S) bool, softcap 30."""
    B, H, D = q.shape
    KV = k.shape[2]
    s = torch.einsum("bhgd,bshd->bhgs",
                     q.reshape(B, KV, H // KV, D) / math.sqrt(D), k)
    s = 30.0 * torch.tanh(s / 30.0)
    s = torch.where(seen[:, None, None], s, -math.inf)
    lse = s.logsumexp(-1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("bhgs,bshd->bhgd", p, v).reshape(B, H, D)
    return out, lse.reshape(B, H)


def test_merge_takes_reducers_over_ranks():
    """The reducer form (one partial a rank, the max and the sum over the
    ranks given as functions) is the stacked form: two ranks simulated,
    rank 1's summand captured first and added to rank 0's."""
    q, k, v, valid = _inputs()
    (o0, l0), (o1, l1) = [
        decode_attention_plain(q, k[:, s:s + 20].contiguous(),
                               v[:, s:s + 20].contiguous(),
                               (valid.long() - s).clamp(0, 20).int(),
                               return_lse=True) for s in (0, 20)]
    want = merge_partials(torch.stack([o0, o1]), torch.stack([l0, l1]))
    sent = []
    merge_partials(o1, l1, lambda t: torch.maximum(t, l0),
                   lambda t: sent.append(t) or t)
    got = merge_partials(o0, l0, lambda t: torch.maximum(t, l1),
                         lambda t: t + sent[0])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


# --------------------------------------------------- the reference's side


def _ref(jobdir, arch):
    """Every case of ``arch`` on four forced devices, a (2, 2) Auto mesh."""
    from repro.models import decode_step, init_decode_cache, loss_fn
    from repro.models.encdec import encdec_prefill_cache, encode
    from torch_mesh_ranks import _flat

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    mc = JaxMeshContext(mesh=mesh, data_axes=("data",))
    job = pickle.loads(Path(jobdir, "job.pkl").read_bytes())
    out = {}
    for case in [c for c in job["cases"] if c["arch"] == arch]:
        cfg = _jax_cfg(arch, case["overrides"])
        params = jax.tree.map(jnp.asarray, case["params"])
        if case["kind"] == "loss":
            spec = jax_model_spec(cfg)
            batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: loss_fn(cfg, mc.constrain_tree(p, spec), batch,
                                  mesh_ctx=mc)))(params)
            out[case["name"]] = {
                "loss": float(loss),
                "grads": {k: np.asarray(v) for k, v in _flat(
                    jax.device_get(grads)).items()}}
            continue
        prompt = case["prompt"]
        B, P = prompt.shape
        if case["frames"] is not None:
            enc = encode(cfg, params, jnp.asarray(case["frames"]))
            cache = encdec_prefill_cache(cfg, params, enc, B,
                                         case["max_seq"])
        else:
            cache = init_decode_cache(cfg, B, case["max_seq"])

        def place(path, leaf):
            names = tuple(getattr(k, "key", k) for k in path)
            return jax.device_put(leaf, NamedSharding(
                mesh, mc.cache_pspec(names, leaf.shape)))
        cache = jax.tree_util.tree_map_with_path(place, cache)
        step = jax.jit(lambda p, c, t, pos: decode_step(
            cfg, p, c, t, pos, mesh_ctx=mc))
        logits, tokens = [], []
        tok = jnp.asarray(prompt[:, :1])
        for pos in range(P + case["new"]):
            if pos < P:
                tok = jnp.asarray(prompt[:, pos:pos + 1])
            lg, cache = step(params, cache, tok, jnp.int32(pos))
            last = np.asarray(lg[:, -1])
            logits.append(last)
            tok = jnp.asarray(np.argmax(last, -1).astype(np.int32)[:, None])
            if pos >= P - 1:
                tokens.append(np.asarray(tok[:, 0]).tolist())
        out[case["name"]] = {"logits": logits, "tokens": tokens}
    Path(jobdir, f"ref_{arch}.pkl").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    _ref(*sys.argv[1:])
