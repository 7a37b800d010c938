"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU:
one full-width cell through the CLI (its keys, the numbers it reports and
the ``null``s it must not fake), an unported kind reported ``ok: false``
with exit code 1, and the private fake-group module the dry run stands
on."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
DEADLINE = 300.0


def _cli(*args, tmp):
    out = tmp / f"{args[1]}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return out, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--json", str(out)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both CLI runs at once: qwen2-7b's train_4k at full width on the
    256-rank mesh with one microbatch, and recurrentgemma-9b's, whose R
    layers the mesh path does not run yet."""
    tmp = tmp_path_factory.mktemp("dryrun")
    runs = {"qwen2": _cli("--arch", "qwen2_7b", "--shape", "train_4k",
                          "--microbatches", "1", tmp=tmp),
            "rg": _cli("--arch", "recurrentgemma-9b", "--shape",
                       "train_4k", "--microbatches", "1", tmp=tmp)}
    done = {}
    for name, (path, p) in runs.items():
        try:
            out, err = p.communicate(timeout=DEADLINE)
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail(f"the dry run of {name} passed {DEADLINE} s")
        done[name] = (p.returncode, out, err, json.loads(path.read_text()))
    return done


def test_cli_reports_one_full_width_cell(cells):
    rc, out, err, (r,) = cells["qwen2"]
    assert rc == 0, err[-3000:]
    assert "1/1 cells compiled" in out and "[ok]" in out
    assert set(r) == {"arch", "shape", "mesh", "devices", "ok", "memory",
                      "hbm_frac", "cost", "collectives", "compile_s"}
    assert (r["arch"], r["shape"], r["mesh"], r["devices"], r["ok"]) == \
        ("qwen2_7b", "train_4k", "16x16", 256, True)
    mem = r["memory"]
    assert mem["temp_bytes"] is None and mem["alias_bytes"] is None
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    # the state comes back whole: outputs are the arguments less the batch
    # (B/16 rows, S/16 positions of tokens and targets) plus 3 metrics
    batch = 2 * (256 // 16) * (4096 // 16) * 4
    assert mem["output_bytes"] == mem["argument_bytes"] - batch + 3 * 4
    assert r["hbm_frac"] == mem["peak_bytes"] / 85_017_493_504
    assert r["cost"]["bytes_accessed"] is None
    assert r["cost"]["transcendentals"] is None
    assert r["cost"]["flops"] > 0
    assert r["cost"]["flops_counted"] == "matmul and attention only"
    coll = r["collectives"]
    assert set(coll) == {"total_bytes", "per_kind_bytes", "per_kind_count"}
    assert coll["per_kind_count"]["all-gather"] > 0
    assert coll["per_kind_count"]["reduce-scatter"] > 0
    assert coll["total_bytes"] == pytest.approx(
        sum(coll["per_kind_bytes"].values()))


def test_unported_kind_reports_not_ok_and_exits_1(cells):
    rc, out, err, (r,) = cells["rg"]
    assert rc == 1
    assert r["ok"] is False
    assert (r["arch"], r["shape"], r["mesh"]) == \
        ("recurrentgemma_9b", "train_4k", "16x16")
    assert r["error"].startswith("NotImplementedError")
    assert "ROADMAP.md §1, item 1" in r["error"]
    assert "[FAIL]" in out and "0/1 cells compiled" in out


def test_fake_process_group_module_is_importable():
    """The dry run joins a fake group from ``torch.testing._internal``, a
    private module: this pins that it still imports and makes a store."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert FakeStore() is not None


def test_strided_shard_index_math_runs_under_the_fake_mode():
    """DTensor places a dim flattened from two sharded dims (a microbatch
    of one row a rank on the multi-pod mesh) as a strided shard, whose
    local indices it computes with ``arange`` and ``tolist``: under the
    dry run's fake mode that raises unless ``_real_index_math`` runs it
    outside, where it gives what it gives without fakes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.placement_types import _StridedShard

    from repro_torch.launch.dryrun import _real_index_math

    shard = _StridedShard(1, split_factor=2)
    want = shard.local_shard_size_and_offset(8, 2, 1)
    with FakeTensorMode():
        with pytest.raises(Exception, match="local_scalar_dense"):
            shard.local_shard_size_and_offset(8, 2, 1)
        with _real_index_math():
            assert shard.local_shard_size_and_offset(8, 2, 1) == want
