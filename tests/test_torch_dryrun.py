"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU:
one full-width cell through the CLI (its keys, the numbers it reports and
the ``null``s it must not fake), a recurrent decode cell (R state and a
sequence-sharded rolling cache), a cell that fails reported ``ok: false``
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


def _cli(*args, tmp, name=None):
    out = tmp / f"{name or args[1]}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return out, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--json", str(out)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The CLI runs at once: qwen2-7b's train_4k at full width on the
    256-rank mesh with one microbatch, recurrentgemma-9b's decode_32k, and
    qwen2-7b's train_4k at 3 microbatches, which do not divide a data
    rank's 16 rows."""
    tmp = tmp_path_factory.mktemp("dryrun")
    runs = {"qwen2": _cli("--arch", "qwen2_7b", "--shape", "train_4k",
                          "--microbatches", "1", tmp=tmp),
            "rg": _cli("--arch", "recurrentgemma-9b", "--shape",
                       "decode_32k", tmp=tmp),
            "bad": _cli("--arch", "qwen2-7b", "--shape", "train_4k",
                        "--microbatches", "3", tmp=tmp, name="bad")}
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
    """A cell that fails (here: a microbatch count that does not divide a
    data rank's rows) is reported ``ok: false`` with its error, and the
    command exits 1."""
    rc, out, err, (r,) = cells["bad"]
    assert rc == 1
    assert r["ok"] is False
    assert (r["arch"], r["shape"], r["mesh"]) == \
        ("qwen2_7b", "train_4k", "16x16")
    assert r["error"].startswith("RuntimeError")
    assert "[FAIL]" in out and "0/1 cells compiled" in out


def test_recurrent_decode_cell_reports_ok(cells):
    """recurrentgemma-9b's decode_32k (R state over the lru width, the
    rolling L cache's 2048 slots sharded over the model axis, one KV
    head) runs on the 256-rank mesh."""
    rc, out, err, (r,) = cells["rg"]
    assert rc == 0, err[-3000:]
    assert (r["arch"], r["shape"], r["mesh"], r["ok"]) == \
        ("recurrentgemma_9b", "decode_32k", "16x16", True)
    mem = r["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert r["hbm_frac"] == mem["peak_bytes"] / 85_017_493_504
    assert r["collectives"]["per_kind_count"]["all-reduce"] > 0
    assert "1/1 cells compiled" in out


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


def test_scan_wrappers_give_the_kernels_outputs_on_fake_tensors():
    """Under the dry run's fake mode K5's and K4's wrappers (forward and
    backward) give their kernels' outputs, shapes and dtypes, without the
    plain versions' loops over time."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import rglru_scan, rwkv6_wkv

    with FakeTensorMode():
        a = torch.empty((2, 4096, 64), requires_grad=True)
        b = torch.empty((2, 4096, 64), requires_grad=True)
        y, h = rglru_scan(a, b)
        (y.sum() + h.sum()).backward()
        assert y.shape == a.shape and h.shape == (2, 64)
        assert a.grad.shape == a.shape and b.grad.shape == b.shape
        r = torch.empty((2, 4096, 4, 16), dtype=torch.bfloat16,
                        requires_grad=True)
        lw = torch.empty((2, 4096, 4, 16))
        out, s_last = rwkv6_wkv(r, r, r, lw, torch.empty((4, 16)))
        out.sum().backward()
        assert out.shape == r.shape and out.dtype == torch.float32
        assert s_last.shape == (2, 4, 16, 16)
        assert r.grad.shape == r.shape
