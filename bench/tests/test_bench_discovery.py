"""A new configuration, traffic mix and per-layer metric are new files and
manifest entries alone: the harness finds each by its name, and no file
it already has is edited."""
import json
import shutil
import time

from conftest import ROOT, tiny_cell
from bench import harness


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())

    # a configuration: a file of sizes, its reference named in it
    cfg = tiny_cell("qwen2-7b.rag-zipf").config
    cfg["num_hidden_layers"] = cfg["program"]["n_layers"] = 3
    (bench / "configs" / "tiny-3l.json").write_text(json.dumps(cfg))
    # a traffic mix: a data file for the one generator
    mix = dict(tiny_cell("qwen2-7b.rag-zipf").traffic)
    mix["output_tokens"] = [2, 6]
    (bench / "traffic" / "short-answers.json").write_text(json.dumps(mix))
    # a per-layer metric: a reader of its own
    (bench / "metrics" / "mean_prompt_tokens.py").write_text(
        "def read(run):\n"
        "    xs = [r.prompt_len for r in run.requests]\n"
        "    return sum(xs) / len(xs) if xs else None\n")
    manifest["configs"].append({"name": "tiny-3l", "source": "test",
                                "file": "bench/configs/tiny-3l.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny-3l.short-answers",
                                  "config": "tiny-3l",
                                  "traffic": "short-answers", "chips": 1,
                                  "why": "test"})
    # an end-to-end metric that lists its cells lists the new one too
    for m in manifest["end_to_end"]:
        if m["name"] == "output_tokens_per_s":
            m["workloads"].append("tiny-3l.short-answers")
    manifest["per_layer"].append({
        "name": "mean_prompt_tokens", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "load generator (bench)",
        "moves": "output_tokens_per_s",
        "workloads": ["tiny-3l.short-answers"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.resolve_cell(manifest, "tiny-3l.short-answers", bench)
    assert cell.config["num_hidden_layers"] == 3
    assert cell.traffic["output_tokens"] == [2, 6]
    assert [m["name"] for m in cell.per_layer] == ["mean_prompt_tokens"]
    assert {m["name"] for m in cell.end_to_end} == {"output_tokens_per_s",
                                                    "setup_s"}
    res = harness.run_cell(cell, 41, 2.0, True, "cpu", time.time(),
                           bench_dir=bench)
    assert res["correct"]
    assert res["metrics"]["mean_prompt_tokens"]["value"] > 64
    changed = [p for p, data in before.items() if p.read_bytes() != data]
    assert changed == []


def test_a_mix_may_bring_its_own_generator(tmp_path):
    """A mix that the one generator cannot express is
    ``traffic/<name>.py``: its ``Traffic`` class and ``SPEC`` are used in
    place of ``gen.Traffic`` and the JSON file, with no other file
    edited."""
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "even-gaps.py").write_text(
        "import numpy as np\n"
        "from bench import gen\n"
        "SPEC = {'arrival': {'kind': 'poisson', 'rate_per_s': 2.0},\n"
        "        'documents': None, 'question_tokens': [8, 8],\n"
        "        'output_tokens': [4, 4], 'block': 8}\n"
        "class Traffic(gen.Traffic):\n"
        "    def sizes(self, b):\n"
        "        q, o, r, g = super().sizes(b)\n"
        "        return q, o, r, np.full(len(g), 0.5)\n")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "qwen2-7b.even-gaps",
                                  "config": "qwen2-7b",
                                  "traffic": "even-gaps", "chips": 1,
                                  "why": "test"})
    cell = harness.resolve_cell(manifest, "qwen2-7b.even-gaps", bench)
    assert cell.traffic["block"] == 8
    reqs = [r for _, r in zip(range(5),
                              cell.make_traffic(3).requests("window"))]
    assert [r.arrival_s for r in reqs] == [0.5, 1.0, 1.5, 2.0, 2.5]
    assert all(len(r.prompt) == 8 and r.max_new == 4 for r in reqs)
    changed = [p for p, data in before.items() if p.read_bytes() != data]
    assert changed == []


def test_a_configuration_may_state_its_own_cut(tmp_path):
    """A configuration's ``"tiny"`` key, where it has one, is its CPU cut
    in place of the default: its Hugging Face keys and, under
    ``program``, the program's fields it overrides."""
    from conftest import DEFAULT_CUT
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    cfg = json.loads((bench / "configs" / "qwen2-7b.json").read_text())
    cfg["tiny"] = {"hidden_size": 48, "intermediate_size": 96,
                   "num_attention_heads": 6, "num_key_value_heads": 3,
                   "num_hidden_layers": 3, "vocab_size": 384,
                   "program": {"n_layers": 3, "d_model": 48, "n_heads": 6,
                               "n_kv_heads": 3, "d_head": 8, "d_ff": 96,
                               "vocab": 384}}
    (bench / "configs" / "own-cut.json").write_text(json.dumps(cfg))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "own-cut", "source": "test",
                                "file": "bench/configs/own-cut.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "own-cut.rag-zipf",
                                  "config": "own-cut", "traffic": "rag-zipf",
                                  "chips": 1, "why": "test"})
    cell = tiny_cell("own-cut.rag-zipf", manifest, bench)
    c = cell.config
    assert (c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]) == \
        (48, 3, 384)
    assert c["program"]["d_head"] == 8 and c["program"]["n_layers"] == 3
    assert c["program"]["qkv_bias"] is True      # not in the cut: kept
    assert harness.block_nbytes(c, 16) == 3 * 16 * 2 * 3 * 8 * 2
    res = harness.run_cell(cell, 43, 4.0, False, "cpu", time.time(),
                           bench_dir=bench)
    assert res["correct"]
    # a configuration without the key takes the default cut
    plain = tiny_cell("qwen2-7b.rag-zipf").config
    assert plain["hidden_size"] == DEFAULT_CUT["hidden_size"]
    assert plain["program"]["d_head"] == DEFAULT_CUT["program"]["d_head"]
