"""Nothing the benchmark imports is JAX or the JAX package: top-level
module names compared whole, because the port's name, ``repro_torch``,
begins with the JAX package's, ``repro``."""
import ast
import json
import subprocess
import sys

from conftest import ROOT
from bench import harness


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.serve", "jaxtyping",
                 "reproducible"):
        monkeypatch.setitem(sys.modules, name, sys.modules["json"])
    for name in ("jax", "jax.numpy", "repro", "repro.serve", "flax"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serve", sys.modules["json"])
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["json"])
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_no_source_under_bench_imports_them():
    for path in (ROOT / "bench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_run_loads_the_port_and_nothing_of_jax():
    """A whole run at the test size in a fresh process: repro_torch is
    loaded, and no jax, jaxlib, flax or repro."""
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(ROOT / 'bench' / 'tests')!r}]\n"
        "from conftest import tiny_cell\n"
        "from bench import harness\n"
        "res = harness.run_cell(tiny_cell('qwen1.5-110b-s10.unique-backlog'),"
        " 5, 4.0, False, 'cpu', time.time())\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([res['correct'], harness.forbidden_modules(),"
        " 'repro_torch' in top]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, forbidden, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and forbidden == [] and port


def test_without_a_card_a_run_fails_and_prints_no_result():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen2-7b.rag-zipf",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
