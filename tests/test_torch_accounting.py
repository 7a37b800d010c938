"""The port's parameter and shape accounting against the reference's, for
all ten configs, full and smoke: ``param_count``; ``abstract_params`` and
``abstract_train_state`` (meta tensors) leaf by leaf against the
reference's ``ShapeDtypeStruct`` trees; ``SHAPES``, ``cells()`` and
``skipped_cells()``; and ``make_dummy_batch``'s shapes and dtypes (its
values come from a torch generator and cannot be the reference's)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import abstract_params as jax_abstract_params  # noqa
from repro.models import make_dummy_batch as jax_dummy_batch  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.models.common import param_count as jax_param_count  # noqa
from repro.sharding import local_context as jax_local_context  # noqa
from repro.train import OptConfig as JaxOptConfig  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import abstract_train_state as jax_abstract_state  # noqa
from repro_torch import configs  # noqa: E402
from repro_torch.models import (abstract_params, make_dummy_batch,  # noqa
                                model_spec, param_count)
from repro_torch.sharding import local_context  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig,  # noqa: E402
                               abstract_train_state)

CONFIGS = [(a, s) for a in configs.ARCH_IDS for s in (False, True)]


def _ids(c):
    return f"{c[0]}-{'smoke' if c[1] else 'full'}"


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _shape_dtype(leaf):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.device.type == "meta"
        return tuple(leaf.shape), str(leaf.dtype).split(".")[-1]
    return tuple(leaf.shape), np.dtype(leaf.dtype).name


def _same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path in want:
        assert _shape_dtype(got[path]) == _shape_dtype(want[path]), path


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_param_count_matches_reference(cfg):
    arch, smoke = cfg
    assert param_count(model_spec(configs.get(arch, smoke))) == \
        jax_param_count(jax_model_spec(jax_configs.get(arch, smoke)))


def test_param_count_of_recurrentgemma_is_the_quoted_one():
    assert param_count(model_spec(configs.get("recurrentgemma_9b"))) == \
        8_578_306_048


@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_abstract_params_match_reference(cfg):
    arch, smoke = cfg
    tcfg, jcfg = configs.get(arch, smoke), jax_configs.get(arch, smoke)
    _same_tree(abstract_params(model_spec(tcfg), dtype=tcfg.dtype),
               jax_abstract_params(jax_model_spec(jcfg), dtype=jcfg.dtype))


@pytest.mark.parametrize("opts", [{}, {"moments_dtype": "bfloat16"},
                                  {"compress": True}],
                         ids=["fp32", "bf16-moments", "compressed"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=_ids)
def test_abstract_train_state_matches_reference(cfg, opts):
    arch, smoke = cfg
    opts = dict(opts)
    compress = opts.pop("compress", False)
    tc = TrainConfig(opt=OptConfig(**opts), compress_pod_grads=compress)
    jtc = JaxTrainConfig(opt=JaxOptConfig(**opts),
                         compress_pod_grads=compress)
    _same_tree(abstract_train_state(configs.get(arch, smoke), tc,
                                    local_context()),
               jax_abstract_state(jax_configs.get(arch, smoke), jtc,
                                  jax_local_context()))


def test_train_config_takes_the_reference_unrolls():
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    jnames = {f.name for f in dataclasses.fields(JaxTrainConfig)}
    assert names == jnames
    tc = TrainConfig(unroll=2, mb_unroll=True)
    assert (tc.unroll, tc.mb_unroll) == (2, True)


def test_shapes_and_cells_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v)
            for k, v in jax_configs.SHAPES.items()}
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    assert configs.cells() == jax_configs.cells()
    assert configs.skipped_cells() == jax_configs.skipped_cells()
    assert configs._LONG_OK == jax_configs._LONG_OK
    assert configs.CELL_ORDER == jax_configs.ARCH_IDS


@pytest.mark.parametrize("arch", ["qwen2_7b", "paligemma_3b",
                                  "whisper_base", "rwkv6_3b"])
def test_dummy_batch_shapes_and_dtypes_match_reference(arch):
    tcfg, jcfg = configs.get(arch, True), jax_configs.get(arch, True)
    got = make_dummy_batch(tcfg, 3, 16, torch.Generator().manual_seed(1))
    want = jax_dummy_batch(jcfg, 3, 16)
    assert set(got) == set(want)
    for k, v in want.items():
        assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1]) == \
            (tuple(v.shape), np.dtype(v.dtype).name), k
    assert int(got["tokens"].min()) >= 0
    assert int(got["tokens"].max()) < tcfg.vocab
    again = make_dummy_batch(tcfg, 3, 16, torch.Generator().manual_seed(1))
    for k in got:
        assert torch.equal(got[k], again[k])
