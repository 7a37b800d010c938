"""The port stands alone and runs where it is told: no file of
``src/repro_torch/`` (nor ``chip_smoke.py``) imports JAX or ``repro``,
importing the package pulls neither in, entry points default to the GPU
and raise without one, and the configs equal the reference's."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model_spec  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files, "no port sources found"
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    bad = {f"{p.relative_to(ROOT)}: {m}" for p in _port_files()
           for m in _imported_roots(p) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_importing_port_loads_no_jax_or_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.launch.train, repro_torch.train\n"
        "import repro_torch.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.ranks, repro_torch.train.compression\n"
        "import repro_torch.data, repro_torch.kernels.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_the_gpu():
    """No device means the card: without one the engine and the launcher
    raise instead of carrying on on the CPU."""
    from repro_torch.launch.serve import serve_main
    from repro_torch.launch.train import train_main
    from repro_torch.serve import (ServeEngine, ShardedFrontend,
                                   resolve_device)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    cfg = configs.get("qwen2_7b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, {}, max_slots=1, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ShardedFrontend(cfg, {}, 2, max_slots=1, max_seq=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--arch", "qwen2_7b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--arch", "recurrentgemma_9b", "--smoke"])
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_reference(smoke):
    """Every architecture the port lists, field for field."""
    assert configs.ARCH_IDS == ["codeqwen1_5_7b", "gemma2_27b",
                                "llama4_maverick_400b_a17b",
                                "moonshot_v1_16b_a3b", "paligemma_3b",
                                "qwen1_5_110b", "qwen2_7b",
                                "recurrentgemma_9b", "rwkv6_3b",
                                "whisper_base"]
    assert sorted(configs.ARCH_IDS) == sorted(jax_configs.ARCH_IDS)
    for arch in configs.ARCH_IDS:
        ref = jax_configs.get(arch, smoke=smoke)
        port = configs.get(arch, smoke=smoke)
        for f in dataclasses.fields(ref):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), \
                    (arch, f.name)
        assert ref.dtype == jnp.bfloat16 and port.dtype == torch.bfloat16
    assert configs.canonical("qwen2.7b") == "qwen2_7b"
    assert configs.canonical("gemma2-27b") == "gemma2_27b"
    assert configs.canonical("recurrentgemma-9b") == "recurrentgemma_9b"
    assert configs.canonical("rwkv6-3b") == "rwkv6_3b"
    assert configs.canonical("moonshot-v1-16b-a3b") == "moonshot_v1_16b_a3b"
    assert configs.canonical("llama4-maverick-400b-a17b") == \
        "llama4_maverick_400b_a17b"
    assert configs.canonical("paligemma-3b") == "paligemma_3b"
    assert configs.canonical("whisper-base") == "whisper_base"
    assert configs.canonical("codeqwen1.5-7b") == "codeqwen1_5_7b"
    assert configs.canonical("qwen1.5-110b") == "qwen1_5_110b"
    for arch in configs.ARCH_IDS:
        ref = jax_configs.get(arch, smoke=smoke)
        port = configs.get(arch, smoke=smoke)
        assert port.lru_width == ref.lru_width
        assert port.pattern_layers() == ref.pattern_layers()


@pytest.mark.parametrize("smoke", [False, True])
def test_param_spec_tree_equals_reference(smoke):
    """Same names, shapes, axes and init rules as the reference's tree,
    the stacked ``stack/0_G`` (and gemma2's ``stack/0_L``, ``stack/1_G``,
    recurrentgemma's ``stack/0_R``, ``stack/1_R``, ``stack/2_L`` and its
    ``tail_*_R``, rwkv6's ``stack/0_W``, moonshot's ``stack/0_M`` and
    llama4's ``stack/0_G``, ``stack/1_M``) layer axes included, the MoE
    leaves (router, stacked expert and shared-expert weights) too."""
    for arch in configs.ARCH_IDS:
        ref = dict(tree_paths(jax_model_spec(jax_configs.get(arch,
                                                             smoke=smoke))))
        port = dict(tree_paths(model_spec(configs.get(arch, smoke=smoke))))
        assert port.keys() == ref.keys(), arch
        for path, s in ref.items():
            q = port[path]
            assert (q.shape, q.axes, q.init, q.scale) == \
                (s.shape, s.axes, s.init, s.scale), (arch, path)
    if not smoke:
        shape = {arch: dict(tree_paths(model_spec(configs.get(arch))))
                 for arch in configs.ARCH_IDS}
        assert shape["qwen2_7b"][("stack", "0_G", "mlp", "wi")].shape == \
            (28, 3584, 2, 18944)
        assert shape["gemma2_27b"][("stack", "0_L", "mlp", "wi")].shape == \
            (23, 4608, 2, 36864)
        rg = shape["recurrentgemma_9b"]
        assert rg[("stack", "1_R", "rec", "gate_a")].shape == \
            (12, 16, 256, 256)
        assert rg[("tail_1_R", "rec", "w_x")].shape == (4096, 4096)
        rw = shape["rwkv6_3b"]
        assert rw[("stack", "0_W", "tm", "wr")].shape == (32, 2560, 16, 160)
        assert rw[("stack", "0_W", "cm", "wk")].shape == (32, 2560, 8960)
        ms = shape["moonshot_v1_16b_a3b"]
        assert ms[("stack", "0_M", "moe", "router")].shape == (48, 2048, 64)
        assert ms[("stack", "0_M", "moe", "wi")].shape == \
            (48, 64, 2048, 2, 1408)
        assert ms[("stack", "0_M", "moe", "shared_wi")].shape == \
            (48, 2048, 2, 2816)
        l4 = shape["llama4_maverick_400b_a17b"]
        assert l4[("stack", "0_G", "mlp", "wi")].shape == \
            (24, 5120, 2, 16384)
        assert l4[("stack", "1_M", "moe", "wo")].shape == \
            (24, 128, 8192, 5120)
        assert l4[("stack", "1_M", "moe", "shared_wo")].shape == \
            (24, 8192, 5120)
        assert shape["codeqwen1_5_7b"][("stack", "0_G", "mlp", "wi")].shape \
            == (32, 4096, 2, 13440)
        assert shape["codeqwen1_5_7b"][("stack", "0_G", "attn", "wk")] \
            .shape == (32, 4096, 32, 128)
        assert shape["qwen1_5_110b"][("stack", "0_G", "mlp", "wi")].shape \
            == (80, 8192, 2, 49152)
