"""The port's optimizer, train step, loader and launcher against the
reference's (``repro.train``, ``repro.data``, ``repro.launch.train``) on
the CPU.

* the reference's own optimizer tests, ported (tests/test_train.py:18,
  :37, :48): one AdamW step against numpy, the schedule, and gradient
  accumulation equal to one big batch;
* gradients of ``loss_fn`` against ``jax.value_and_grad`` on the four
  smoke configs in f32: each leaf within 1e-4 of that leaf's largest
  magnitude (f32 on both sides, summed in different orders);
* three ``build_train_step`` steps in both packages from the same weights
  and the loader's batches: losses within 1e-4 relative, parameters
  within 1e-4; and AdamW alone on equal gradients;
* ``TrainLoader`` batches bit-identical to the reference's;
* the launcher's line format, and its step-0 loss within 1e-2 of the
  reference launcher's on the same weights (bf16: the two frameworks
  round at different places)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro import train as JT  # noqa: E402
from repro.data import LoaderConfig as JLoaderConfig  # noqa: E402
from repro.data import TrainLoader as JTrainLoader  # noqa: E402
from repro.launch import train as jax_launch  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.sharding import local_context  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import LoaderConfig, TrainLoader  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.models import (loss_fn, params_from_numpy,  # noqa: E402
                                tree_paths)
from repro_torch.models.common import unflatten  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               adamw_init, adamw_update, build_train_step,
                               clip_by_global_norm, make_train_state,
                               schedule_lr)

ARCHS = ["qwen2_7b", "gemma2_27b", "recurrentgemma_9b", "rwkv6_3b"]


def _np_params(arch, dtype=jnp.float32, seed=0):
    jcfg = jax_configs.get(arch, smoke=True).replace(dtype=dtype)
    return jcfg, jax.device_get(jax_init_params(
        jax.random.key(seed), jax_model_spec(jcfg), dtype=dtype))


def _leaves(tree):
    return dict(tree_paths(tree))


# --------------------------------------------------------- the optimizer


def test_adamw_matches_reference_step():
    """One AdamW step vs a hand-written numpy reference (no decay/clip
    interference: wd=0, huge clip)."""
    oc = OptConfig(lr=0.1, beta1=0.9, beta2=0.99, eps=1e-8,
                   weight_decay=0.0, clip_norm=1e9, warmup_steps=0,
                   schedule="constant")
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    st = adamw_init(p)
    new_p, st2, _ = adamw_update(oc, p, g, st)

    m = 0.1 * np.array([0.1, 0.2, -0.3])
    v = 0.01 * np.array([0.1, 0.2, -0.3]) ** 2
    mh, vh = m / (1 - 0.9), v / (1 - 0.99)
    ref = np.array([1.0, -2.0, 3.0]) - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-5)
    assert int(st2["step"]) == 1


def test_schedule_warmup_and_cosine():
    oc = OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                   schedule="cosine", min_lr_frac=0.1)
    assert float(schedule_lr(oc, torch.tensor(0))) == 0.0
    assert float(schedule_lr(oc, torch.tensor(10))) == pytest.approx(1.0)
    assert float(schedule_lr(oc, torch.tensor(110))) == pytest.approx(0.1)
    mid = float(schedule_lr(oc, torch.tensor(60)))
    assert 0.1 < mid < 1.0


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_equals_reference(schedule):
    oc = dict(lr=3e-4, warmup_steps=7, total_steps=50, schedule=schedule)
    for step in (0, 3, 7, 20, 49, 60):
        want = float(JT.schedule_lr(JT.OptConfig(**oc), jnp.array(step)))
        got = float(schedule_lr(OptConfig(**oc), torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_grad_accumulation_equivalent():
    """microbatches=2 must equal microbatches=1 on the same global batch."""
    cfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    outs = {}
    for k in (1, 2):
        tc = TrainConfig(opt=OptConfig(warmup_steps=0, schedule="constant"),
                         microbatches=k)
        state = make_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                 "cpu")
        new_state, m = build_train_step(cfg, tc)(state, batch)
        outs[k] = (float(m["loss"]),
                   next(iter(_leaves(new_state["params"]).values())))
    assert outs[1][0] == pytest.approx(outs[2][0], rel=1e-5)
    np.testing.assert_allclose(outs[1][1].numpy(), outs[2][1].numpy(),
                               atol=1e-5)


def _seeded_grads(seed=0):
    """Gradients of several scales and shapes, one all zero."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((64, 48)).astype(np.float32)
                  * 0.03,
                  "b": rng.standard_normal((48,)).astype(np.float32)},
            "c": rng.standard_normal((5, 7, 9)).astype(np.float32) * 1e-4,
            "z": np.zeros((4, 4), np.float32)}


def _int8_agree(got_q, got_s, want_q, want_s, x):
    """The port's per-tensor int8 (a true division, as numpy's) against
    the reference's: scales within ``rtol=2e-7`` (XLA lowers the divide
    to a reciprocal multiply), bytes equal except where the reference's
    quotient lands on the other side of a rounding tie, one step away."""
    got_q, want_q = np.asarray(got_q), np.asarray(want_q)
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=2e-7)
    scale = np.maximum(np.max(np.abs(x)), np.float32(1e-12)) \
        / np.float32(127.0)
    np.testing.assert_array_equal(
        got_q, np.clip(np.round(x / scale), -127, 127).astype(np.int8))
    off = got_q != want_q
    assert np.all(np.abs(got_q.astype(int) - want_q.astype(int)) <= 1)
    frac = np.abs(x / scale) % 1.0
    assert np.all(np.abs(frac[off] - 0.5) < 1e-5), frac[off]
    return off, scale


def test_compression_raises():
    """(The name is the test's since the port refused compression.) The
    port's ``compress_grads``, ``ef_init`` and ``compression_ratio``
    against the reference's on seeded gradients over three rounds of
    error feedback, each round of both packages fed the port's residual:
    the int8 bytes and scales agree (``_int8_agree``), so the wire and
    the new residual agree to the scale's rounding, and one quantizer
    step where a tie parted the bytes; the ratios are equal. Then three
    ``build_train_step`` steps with ``compress_pod_grads`` in both
    packages under ``test_three_train_steps_match_reference``'s bars."""
    from repro.train import compression as JC
    from repro_torch.train import compression as TC

    g_np = _seeded_grads()
    jg = jax.tree.map(jnp.asarray, g_np)
    tg = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
              {kk: torch.from_numpy(vv) for kk, vv in v.items()})
          for k, v in g_np.items()}
    tef = TC.ef_init(tg)
    want_ef = _leaves(jax.device_get(JC.ef_init(jg)))
    for path, t in _leaves(tef).items():
        assert t.dtype == torch.float32 and not t.any()
        assert tuple(t.shape) == want_ef[path].shape
    for _ in range(3):
        parted = {}
        for path, t in _leaves(tef).items():
            x = (_leaves(tg)[path] + t).numpy()
            tq, ts = TC._quantize_int8(torch.from_numpy(x))
            jq, js = JC._quantize_int8(jnp.asarray(x))
            parted[path] = _int8_agree(tq.numpy(), ts, jq, js, x)
        jw, jef = JC.compress_grads(jg, unflatten(
            {p: jnp.asarray(t.numpy()) for p, t in _leaves(tef).items()}))
        tw, tef = TC.compress_grads(tg, tef)
        for tree_t, tree_j in ((tw, jw), (tef, jef)):
            want = _leaves(jax.device_get(tree_j))
            for path, t in _leaves(tree_t).items():
                off, scale = parted[path]
                got, ref = t.numpy(), np.asarray(want[path])
                np.testing.assert_allclose(got[~off], ref[~off],
                                           rtol=1e-6, atol=1e-12)
                assert np.all(np.abs(got[off] - ref[off])
                              <= scale * 1.0001)
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        for numel in (None, 64, 1 << 20):
            assert TC.compression_ratio(dtype, numel) == \
                JC.compression_ratio(jdt, numel)

    jcfg, np_params = _np_params("qwen2_7b")
    tcfg = configs.get("qwen2_7b", smoke=True).replace(dtype=torch.float32)
    oc = dict(lr=3e-4, warmup_steps=1, total_steps=3, eps=1e-3)
    lc = dict(global_batch=2, seq_len=24, vocab=jcfg.vocab, seed=1)
    jloader, tloader = JTrainLoader(JLoaderConfig(**lc)), TrainLoader(
        LoaderConfig(**lc))
    jtc = JT.TrainConfig(opt=JT.OptConfig(**oc), compress_pod_grads=True)
    jstep = jax.jit(JT.build_train_step(jcfg, jtc, local_context()))
    jstate = {"params": jax.tree.map(jnp.asarray, np_params)}
    jstate["opt"] = JT.adamw_init(jstate["params"])
    jstate["ef"] = JT.compression.ef_init(jstate["params"])
    tc = TrainConfig(opt=OptConfig(**oc), compress_pod_grads=True)
    tstep = build_train_step(tcfg, tc)
    tparams = params_from_numpy(np_params)
    tstate = {"params": tparams, "opt": adamw_init(tparams),
              "ef": TC.ef_init(tparams)}
    for step in range(3):
        jstate, jm = jstep(jstate, jloader.build_batch(step))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in tloader.build_batch(
                                        step).items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-3)
    want = _leaves(jax.device_get(jstate["params"]))
    for path, t in _leaves(tstate["params"]).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]),
                                   atol=1e-4, rtol=0, err_msg=str(path))
    assert sorted(tstate) == sorted(jstate) == ["ef", "opt", "params"]


def test_make_train_state_adds_error_feedback():
    """``compress_pod_grads`` adds zero fp32 residuals under ``"ef"``, one
    per parameter, as the reference's ``make_train_state`` does."""
    cfg = configs.get("qwen2_7b", smoke=True)
    state = make_train_state(cfg, TrainConfig(compress_pod_grads=True),
                             torch.Generator().manual_seed(0), "cpu")
    jstate = JT.make_train_state(
        jax_configs.get("qwen2_7b", smoke=True),
        JT.TrainConfig(compress_pod_grads=True), jax.random.key(0))
    want = _leaves(jax.device_get(jstate["ef"]))
    got = _leaves(state["ef"])
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        assert t.dtype == torch.float32 and not t.any()
        assert tuple(t.shape) == want[path].shape
    assert "ef" not in make_train_state(cfg, TrainConfig(),
                                        torch.Generator().manual_seed(0),
                                        "cpu")


def test_compression_error_feedback_unbiased():
    """``tests/test_train.py:66``: with error feedback the cumulative
    transmitted gradient converges to the cumulative true gradient, in
    both packages, by the same amount."""
    from repro.train import compression as JC
    from repro_torch.train import compression as TC

    g_np = np.random.default_rng(0).normal(size=512).astype(np.float32)
    rels = []
    for C, g, zeros, norm in (
            (JC, {"w": jnp.asarray(g_np)}, jnp.zeros(512), jnp.linalg.norm),
            (TC, {"w": torch.from_numpy(g_np)}, torch.zeros(512),
             torch.linalg.norm)):
        ef = C.ef_init(g)
        sent = zeros
        for _ in range(50):
            wire, ef = C.compress_grads(g, ef)
            sent = sent + wire["w"]
        total_true = g["w"] * 50
        rels.append(float(norm(sent - total_true) / norm(total_true)))
    assert rels[1] < 0.01, rels
    assert rels[1] == pytest.approx(rels[0], rel=1e-3)


def test_compression_single_step_is_quantized():
    """``tests/test_train.py:83``: one round trip lands on the int8 grid
    (at most 255 distinct values) and wire + residual is the gradient."""
    from repro.train import compression as JC
    from repro_torch.train import compression as TC

    g = {"w": torch.linspace(-1, 1, 256)}
    wire, ef = TC.compress_grads(g, TC.ef_init(g))
    assert len(np.unique(wire["w"].numpy())) <= 255
    np.testing.assert_allclose((wire["w"] + ef["w"]).numpy(),
                               g["w"].numpy(), atol=1e-6)
    jwire, _ = JC.compress_grads({"w": jnp.linspace(-1, 1, 256)},
                                 JC.ef_init({"w": jnp.zeros(256)}))
    np.testing.assert_allclose(wire["w"].numpy(), np.asarray(jwire["w"]),
                               atol=1e-6)


# ----------------------------------------------- against the reference


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_reference(arch):
    jcfg, np_params = _np_params(arch)
    tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
             for k in ("tokens", "targets")}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    ))(jax.tree.map(jnp.asarray, np_params))
    leaves = {p: t.requires_grad_(True)
              for p, t in _leaves(params_from_numpy(np_params)).items()}
    tloss = loss_fn(tcfg, unflatten(leaves),
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, list(leaves.values()))
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    want = _leaves(jax.device_get(jgrads))
    assert set(want) == set(leaves)
    for path, g in zip(leaves, tgrads):
        r = np.asarray(want[path])
        scale = float(np.abs(r).max())
        assert np.abs(g.numpy() - r).max() <= 1e-4 * scale, path


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """Losses within 1e-4 relative at every step, parameters within 1e-4
    after three steps. The optimizer's eps is 1e-3 here, not 1e-8: with
    1e-8 the first step moves every element by lr * g/(|g| + eps), +-lr
    whatever |g| is, so an element whose gradient lies below the f32 noise
    of these randomly initialised smoke models (f32 and f64 gradients of
    one package differ by up to 1e-3 of a leaf's largest: the reference's
    fan-in init makes their weights large) steps either way in either
    package. With eps 1e-3 the update is continuous in g near 0; the
    default eps's arithmetic is held to the reference's on equal gradients
    by ``test_adamw_update_equals_reference``."""
    jcfg, np_params = _np_params(arch)
    tcfg = configs.get(arch, smoke=True).replace(dtype=torch.float32)
    oc = dict(lr=3e-4, warmup_steps=1, total_steps=3, eps=1e-3)
    lc = dict(global_batch=2, seq_len=24, vocab=jcfg.vocab, seed=1)
    jloader, tloader = JTrainLoader(JLoaderConfig(**lc)), TrainLoader(
        LoaderConfig(**lc))

    jstep = jax.jit(JT.build_train_step(
        jcfg, JT.TrainConfig(opt=JT.OptConfig(**oc)), local_context()))
    jstate = {"params": jax.tree.map(jnp.asarray, np_params)}
    jstate["opt"] = JT.adamw_init(jstate["params"])
    tstep = build_train_step(tcfg, TrainConfig(opt=OptConfig(**oc)))
    tparams = params_from_numpy(np_params)
    tstate = {"params": tparams, "opt": adamw_init(tparams)}
    for step in range(3):
        jstate, jm = jstep(jstate, jloader.build_batch(step))
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in tloader.build_batch(
                                        step).items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-3)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    want = _leaves(jax.device_get(jstate["params"]))
    for path, t in _leaves(tstate["params"]).items():
        np.testing.assert_allclose(t.numpy(), np.asarray(want[path]),
                                   atol=1e-4, rtol=0, err_msg=str(path))
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


@pytest.mark.parametrize("moments_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(moments_dtype):
    """Three AdamW steps of both packages on the same seeded gradients,
    default hyperparameters (clipping active), bf16 and f32 leaves; and
    ``clip_by_global_norm`` alone."""
    oc = dict(warmup_steps=2, total_steps=5, moments_dtype=moments_dtype)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    jp = {"a": jnp.asarray(params["a"]).astype(jnp.bfloat16),
          "b": {"c": jnp.asarray(params["b"]["c"])}}
    tp = {"a": torch.from_numpy(params["a"]).to(torch.bfloat16),
          "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    jst, tst = JT.adamw_init(jp, JT.OptConfig(**oc)), adamw_init(
        tp, OptConfig(**oc))
    for step in range(3):
        g = {"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": {"c": rng.standard_normal(11).astype(np.float32) * 1e-7}}
        jp, jst, jstats = JT.adamw_update(
            JT.OptConfig(**oc), jp, jax.tree.map(jnp.asarray, g), jst)
        tp, tst, tstats = adamw_update(
            OptConfig(**oc), tp, {"a": torch.from_numpy(g["a"]),
                                  "b": {"c": torch.from_numpy(g["b"]["c"])}},
            tst)
        for k in ("grad_norm", "lr"):
            assert float(tstats[k]) == pytest.approx(float(jstats[k]),
                                                     rel=1e-6)
    g = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    jclipped, jn = JT.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 2.0)
    tclipped, tn = clip_by_global_norm(
        {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(
            g["b"]["c"])}}, 2.0)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    want = _leaves(jax.device_get(jclipped))
    for path, t in _leaves(tclipped).items():
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6)
    for tree_t, tree_j in ((tp, jp), (tst["m"], jst["m"]),
                           (tst["v"], jst["v"])):
        want = _leaves(jax.device_get(tree_j))
        for path, t in _leaves(tree_t).items():
            assert str(t.dtype).split(".")[-1] == str(want[path].dtype)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(want[path], np.float32),
                                       rtol=1e-5, atol=1e-12)


def test_loader_batches_bit_identical():
    for lc in (dict(global_batch=4, seq_len=16, vocab=512, seed=3),
               dict(global_batch=6, seq_len=9, vocab=1000, seed=0,
                    host_id=1, n_hosts=3)):
        jl, tl = JTrainLoader(JLoaderConfig(**lc)), TrainLoader(
            LoaderConfig(**lc))
        for step in (0, 1, 7):
            want, got = jl.build_batch(step), tl.build_batch(step)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ launcher

LINE = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  gnorm (\d+\.\d{3})  "
                  r"lr (\d\.\d\de[-+]\d\d)  \(\d+\.\ds\)$")


def _check_launcher_lines(arch, monkeypatch, capsys):
    """``--smoke --device cpu --steps 3`` on ``arch``: the reference
    launcher's line format, and on the reference's own weights (handed to
    the port's launcher in place of its seeded draw) the same step-0 loss
    within 1e-2."""
    argv = ["--arch", arch, "--smoke", "--steps", "3",
            "--global-batch", "2", "--seq-len", "16"]
    assert jax_launch.train_main(argv) == 0
    ref = capsys.readouterr().out.splitlines()

    _, np_params = _np_params(arch, dtype=jnp.bfloat16)

    def reference_weights(cfg, tc, generator, device):
        params = params_from_numpy(np_params, device=device)
        return {"params": params, "opt": adamw_init(params, tc.opt)}
    monkeypatch.setattr(port_launch, "make_train_state", reference_weights)
    assert port_launch.train_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()

    assert len(got) == len(ref) == 2                  # steps 0 and 2
    parsed = [[LINE.match(ln) for ln in lines] for lines in (ref, got)]
    assert all(parsed[0]) and all(parsed[1]), (ref, got)
    for r, g in zip(*parsed):
        assert g.group(1) == r.group(1)               # step
        assert g.group(4) == r.group(4)               # lr
    assert float(parsed[1][0].group(2)) == pytest.approx(
        float(parsed[0][0].group(2)), abs=1e-2)


def test_launcher_lines_match_reference(monkeypatch, capsys):
    _check_launcher_lines("recurrentgemma_9b", monkeypatch, capsys)


def test_launcher_lines_match_reference_rwkv6(monkeypatch, capsys):
    _check_launcher_lines("rwkv6_3b", monkeypatch, capsys)
