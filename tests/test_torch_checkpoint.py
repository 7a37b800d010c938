"""The port's checkpointing (``repro_torch.train.checkpoint``) and its
launcher's checkpoint flags, on the CPU.

* the reference's roundtrip, atomicity, gc and async cases
  (``tests/test_train.py:103, :116, :126, :134``), bf16 kept;
* the in-place trap: the port's step updates parameters and moments in
  place, so ``AsyncCheckpointer.save`` must copy them before it returns;
  a step taken while the write is still pending does not reach the file;
* the on-disk format across packages: a checkpoint the reference writes
  loads in the port, and one the port writes loads with the reference's
  ``load``, leaf names, dtypes and bytes equal; each package re-saving
  what it loaded writes the other's files byte for byte;
* resume bit for bit: 6 steps against 3 + save + load + 3 on the qwen2-7b
  and rwkv6-3b smoke configs in f32 (parameters, moments, step, losses);
* ``launch.train``: a run preempted by SIGTERM at step 3 and resumed with
  ``--resume`` writes a step-6 checkpoint equal, file by file and byte for
  byte, to the uninterrupted run's;
* a store block wider than a rolling-window layer raises ``TypeError`` at
  publish in both packages, from the shapes, before any device op."""
import filecmp
import json
import os
import signal
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro import train as JT  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import LoaderConfig, TrainLoader  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.serve import KVBlockPool, ServeEngine  # noqa: E402
from repro_torch.train import (AsyncCheckpointer, OptConfig,  # noqa: E402
                               TrainConfig, adamw_init, adamw_update,
                               build_train_step, gc_old, latest, load,
                               make_train_state, save)
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402


def _tiny_state():
    return {"params": {"w": torch.arange(6, dtype=torch.bfloat16
                                         ).reshape(2, 3),
                       "b": torch.ones((4,), dtype=torch.float32)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _files(path):
    return sorted(os.listdir(path))


def _same_files(a, b):
    """Two checkpoint directories hold the same files, byte for byte."""
    assert _files(a) == _files(b)
    match, mismatch, errors = filecmp.cmpfiles(a, b, _files(a),
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# ------------------------------------- the reference's checkpoint cases


def test_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    path = save(str(tmp_path), 7, state)
    step, restored = load(path, "cpu")
    assert step == 7
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert torch.equal(restored["params"]["b"], state["params"]["b"])
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 7


def test_checkpoint_atomicity(tmp_path):
    """A directory without a manifest (crash mid-write) is never loadable
    as 'latest'."""
    save(str(tmp_path), 1, _tiny_state())
    os.makedirs(tmp_path / "step_00000002.tmp-999")  # orphaned tmp
    os.makedirs(tmp_path / "step_00000003")          # no manifest: corrupt
    found = latest(str(tmp_path))
    assert found is not None and found.endswith("step_00000001")


def test_checkpoint_gc(tmp_path):
    for s in range(5):
        save(str(tmp_path), s, _tiny_state())
    gc_old(str(tmp_path), keep=2)
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, _tiny_state())
    ck.wait()
    assert latest(str(tmp_path)).endswith("step_00000003")
    assert _files(tmp_path) == ["step_00000002", "step_00000003"]


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    with mock.patch.object(ckpt_mod, "save",
                           side_effect=OSError("disk full")):
        ck.save(1, _tiny_state())
        with pytest.raises(OSError, match="disk full"):
            ck.wait()
    ck.wait()                       # the error is raised once


# ------------------------------------------------------ the in-place trap


def test_step_after_save_does_not_reach_the_file(tmp_path):
    """The writer thread is held until an AdamW step has updated the
    parameters, moments and step in place; the file holds the state as
    it was at ``save``."""
    params = {"w": torch.linspace(-1, 1, 12).reshape(3, 4),
              "b": torch.arange(4, dtype=torch.bfloat16)}
    grads = {"w": torch.full((3, 4), 0.5),
             "b": torch.ones(4, dtype=torch.bfloat16)}
    oc = OptConfig(warmup_steps=0, schedule="constant", lr=0.1)
    opt = adamw_init(params, oc)
    state = {"params": params, "opt": opt}
    before = {p: t.clone() for p, t in tree_paths(state)}

    release = threading.Event()
    real_save = ckpt_mod.save

    def held_save(*a, **kw):
        assert release.wait(30)
        return real_save(*a, **kw)

    ck = AsyncCheckpointer(str(tmp_path))
    with mock.patch.object(ckpt_mod, "save", held_save):
        ck.save(1, state)
        adamw_update(oc, params, grads, opt)     # in place, while pending
        release.set()
        ck.wait()
    after = dict(tree_paths(state))
    assert not torch.equal(after[("params", "w")], before[("params", "w")])
    assert int(after[("opt", "step")]) == 1
    _, restored = load(latest(str(tmp_path)), "cpu")
    for path, t in tree_paths(restored):
        assert torch.equal(t, before[path]), path


# ------------------------------------------- the format across packages


def _jax_state():
    """A reference train state (bf16 parameters of the rwkv6 smoke model,
    f32 moments made non-zero, int32 step) and the loader's cursor."""
    cfg = jax_configs.get("rwkv6_3b", smoke=True)
    state = JT.make_train_state(cfg, JT.TrainConfig(), jax.random.key(1))
    state["opt"]["m"] = jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                                     state["params"])
    state["opt"]["v"] = jax.tree.map(
        lambda p: jnp.square(p.astype(jnp.float32)), state["params"])
    state["opt"]["step"] = jnp.array(5, jnp.int32)
    return {"state": state, "loader": {"next_step": 5}}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    payload = _jax_state()
    jpath = JT.save(str(tmp_path / "jax"), 5, payload)
    step, got = load(jpath, "cpu")
    assert step == 5
    want = dict(ckpt_mod._flatten(jax.device_get(payload)))
    have = dict(ckpt_mod._flatten(got))
    assert sorted(have) == sorted(want)
    for name, t in have.items():
        ref = np.asarray(want[name])
        assert list(t.shape) == list(ref.shape), name
        if ref.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16, name
            assert t.view(torch.int16).numpy().tobytes() == ref.tobytes()
        else:
            assert t.numpy().dtype == ref.dtype, name
            assert t.numpy().tobytes() == ref.tobytes(), name
    # the port writes back what the reference wrote, byte for byte
    ppath = save(str(tmp_path / "port"), step, got)
    _same_files(jpath, ppath)
    assert _manifest(ppath) == _manifest(jpath)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    cfg = configs.get("rwkv6_3b", smoke=True)
    state = make_train_state(cfg, TrainConfig(),
                             torch.Generator().manual_seed(1), "cpu")
    for path, t in tree_paths(state["opt"]):
        if t.is_floating_point():
            t.normal_(generator=torch.Generator().manual_seed(len(path)))
    state["opt"]["step"].fill_(5)
    ppath = save(str(tmp_path / "port"), 5, {"state": state,
                                            "loader": {"next_step": 5}})
    step, got = JT.load(ppath)
    assert step == 5
    assert int(got["loader"]["next_step"]) == 5
    have = dict(ckpt_mod._flatten(jax.device_get(got)))
    for name, t in ckpt_mod._flatten(state):
        ref = np.asarray(have["state/" + name])
        if t.dtype == torch.bfloat16:
            assert ref.dtype == jnp.bfloat16, name
            assert ref.tobytes() == t.view(torch.int16).numpy().tobytes()
        else:
            assert ref.tobytes() == t.numpy().tobytes(), name
    # the reference re-saves it byte for byte; its loader cursor goes back
    # as a Python int, as its launcher writes it (a loaded int64 leaf comes
    # back int32 from JAX without x64)
    jpath = JT.save(str(tmp_path / "jax"), step, {
        "state": got["state"],
        "loader": {"next_step": int(got["loader"]["next_step"])}})
    _same_files(ppath, jpath)
    assert _manifest(jpath) == _manifest(ppath)


# ------------------------------------------------------- resume bit for bit


def _steps(cfg, tc, lc, state, start, n):
    loader = TrainLoader(lc)
    step_fn = build_train_step(cfg, tc)
    losses = []
    for s in range(start, start + n):
        batch = {k: torch.from_numpy(v)
                 for k, v in loader.build_batch(s).items()}
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())
    return state, losses


@pytest.mark.parametrize("arch", ["qwen2_7b", "rwkv6_3b"])
def test_resume_bitwise_identical(tmp_path, arch):
    """Train 6 steps; checkpoint at 3; resume and re-run 3..6: parameters,
    moments, step and the losses of steps 3-5 equal the uninterrupted
    run's bit for bit. Each run builds its state afresh (the step updates
    it in place)."""
    cfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    tc = TrainConfig(opt=OptConfig(warmup_steps=1, total_steps=6))
    lc = LoaderConfig(global_batch=2, seq_len=16, vocab=cfg.vocab, seed=3)

    def fresh():
        return make_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                "cpu")

    full, full_losses = _steps(cfg, tc, lc, fresh(), 0, 6)

    half, _ = _steps(cfg, tc, lc, fresh(), 0, 3)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, {"state": half, "loader": {"next_step": 3}})
    ck.wait()
    del half
    step, payload = load(latest(str(tmp_path)), "cpu")
    assert step == 3
    start = int(payload["loader"]["next_step"])
    resumed, resumed_losses = _steps(cfg, tc, lc, payload["state"], start, 3)

    assert resumed_losses == full_losses[3:]
    a, b = dict(tree_paths(full)), dict(tree_paths(resumed))
    assert sorted(a) == sorted(b)
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        assert torch.equal(a[path], b[path]), path
    assert int(b[("opt", "step")]) == 6


def test_launcher_resume_writes_the_uninterrupted_checkpoint(tmp_path,
                                                             capsys):
    """``train_main`` with ``--ckpt-dir``: the uninterrupted 6-step run,
    and a run preempted by SIGTERM during its step 3 (a final checkpoint
    at 3, then exit) resumed with ``--resume``, write the same
    ``step_00000006``, file by file and byte for byte."""
    argv = ["--arch", "rwkv6_3b", "--smoke", "--device", "cpu", "--steps",
            "6", "--ckpt-every", "3", "--global-batch", "2", "--seq-len",
            "16", "--log-every", "1"]
    full, split = str(tmp_path / "full"), str(tmp_path / "split")
    assert port_launch.train_main(argv + ["--ckpt-dir", full]) == 0
    assert _files(full) == ["step_00000003", "step_00000006"]

    real = port_launch.build_train_step

    def preempting(cfg, tc):
        step_fn, calls = real(cfg, tc), []

        def step(state, batch):
            calls.append(1)
            if len(calls) == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, batch)
        return step

    capsys.readouterr()
    with mock.patch.object(port_launch, "build_train_step", preempting):
        assert port_launch.train_main(argv + ["--ckpt-dir", split]) == 0
    assert "preempted at step 3; checkpoint written" in capsys.readouterr().out
    assert _files(split) == ["step_00000003"]
    assert port_launch.train_main(argv + ["--ckpt-dir", split,
                                          "--resume"]) == 0
    out = capsys.readouterr().out
    assert "at step 3" in out.splitlines()[0]
    assert "step     2" not in out and "step     3" in out
    _same_files(os.path.join(full, "step_00000006"),
                os.path.join(split, "step_00000006"))
    _same_files(os.path.join(full, "step_00000003"),
                os.path.join(split, "step_00000003"))


# ------------------------------- a store block wider than a window layer


def test_block_wider_than_window_raises_typeerror_in_both_packages():
    """gemma2 smoke (L layers keep an 8-token window) under the engines'
    default 16-token-block store: publishing the first prompt's blocks
    raises ``TypeError`` in the reference and in the port."""
    jcfg = jax_configs.get("gemma2_27b", smoke=True).replace(
        dtype=jnp.float32)
    cfg = configs.get("gemma2_27b", smoke=True).replace(dtype=torch.float32)
    jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                              dtype=jnp.float32)
    params = params_from_numpy(jax.device_get(jparams))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, 40)]
               for _ in range(2)]
    for eng in (JaxEngine(jcfg, jparams, max_slots=2, max_seq=64),
                ServeEngine(cfg, params, max_slots=2, max_seq=64,
                            device="cpu")):
        assert eng.store.block_tokens == 16
        for p in prompts:
            eng.submit(p, max_new=4)
        with pytest.raises(TypeError):
            eng.run()


def test_scatter_checks_the_width_before_any_device_op():
    template = {"k": torch.zeros((2, 8, 1, 4)), "v": torch.zeros((2, 8, 1, 4))}
    pool = KVBlockPool(template, block_tokens=16, num_blocks=4, device="cpu")
    before = {p: t.clone() for p, t in tree_paths(pool.buffers)}
    with mock.patch("torch.tensor", side_effect=AssertionError("device op")), \
            mock.patch("torch.arange", side_effect=AssertionError("device op")):
        with pytest.raises(TypeError, match="window of 8 tokens.*block of 16"):
            pool.scatter_from(template, 0, [0], [pool.alloc()])
    for p, t in tree_paths(pool.buffers):
        assert torch.equal(t, before[p])
