"""A new cell goes in as new files only: a configuration, a traffic mix
and a metric reader added to a copy of the benchmark are found by name,
with no file of the benchmark edited (only BENCHMARK.json lists them)."""
import hashlib
import json
import shutil

from perfbench import harness

from .small import SERVE, run


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_from_new_files(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)
    bench = tmp_path / "perfbench"
    conf = json.loads((bench / "configs" / "qwen2.5-32b.json").read_text())
    (bench / "configs" / "qwen2.5-32b-b.json").write_text(
        json.dumps({**conf, "name": "qwen2.5-32b-b"}))
    traffic = json.loads((bench / "traffic" / "decode-128.json").read_text())
    (bench / "traffic" / "decode-8.json").write_text(
        json.dumps({**traffic, "n_slots": 8, "clients": 8}))
    (bench / "limits" / "qwen2.5-32b-b.decode-8.json").write_text(
        (bench / "limits" / "qwen2.5-32b.decode-128.json").read_text())
    (bench / "metrics" / "tokens_per_step.py").write_text(
        '"""tokens_per_step (tokens): output tokens per window step."""\n\n\n'
        "def read(run):\n    return run.tokens / run.steps\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "qwen2.5-32b-b", "source": conf["source"],
                           "file": "perfbench/configs/qwen2.5-32b-b.json",
                           "reduced": conf["reduced"], "why": "test"})
    man["workloads"].append({"name": "qwen2.5-32b-b.decode-8",
                             "config": "qwen2.5-32b-b",
                             "traffic": "decode-8", "chips": 1,
                             "why": "test"})
    man["end_to_end"].append({"name": "tokens_per_step", "unit": "tokens",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["qwen2.5-32b-b.decode-8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    out = run("qwen2.5-32b-b.decode-8", root=tmp_path, like=SERVE)
    assert out["correct"]
    assert out["metrics"]["tokens_per_step"]["value"] > 0
    assert "setup_s" in out["metrics"] and "tok_s" not in out["metrics"]
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
