"""BENCHMARK.json against the benchmark's contract: names, units, keys,
lengths, the bounds, the time a full check takes, and that every name
finds its file."""
import json
import math
import re

import pytest

from perfbench import harness

from .small import with_prepared

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection)|_dim$"
                   r"|_rank$|head|expansion|experts_per_tok")

MAN = harness.manifest()
#: the prepared cells' entries are held to the same rules
PREPARED = sorted(p.stem for p in (harness.BENCH / "prepared").glob("*.json"))
FULL = MAN
for _name in PREPARED:
    FULL = with_prepared(FULL, _name)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in FULL["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
    for w in FULL["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in FULL["end_to_end"] + FULL["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        got = [x["name"] for x in FULL[group]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in FULL["end_to_end"] + FULL["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("man", [MAN, FULL], ids=["manifest", "prepared"])
def test_metric_entries(man):
    MAN = man
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in MAN["workloads"]}
    for w in cells:
        reported = [m for m in MAN["end_to_end"]
                    if w in m.get("workloads", [w])]
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", [w]) for m in MAN["per_layer"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_every_name_finds_its_files():
    bench = harness.BENCH
    MAN = FULL
    for c in MAN["configs"]:
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert (bench / "reference" / f"{conf['reference']}.py").is_file()
    for w in MAN["workloads"]:
        traffic = harness.load_json(bench / "traffic" / f"{w['traffic']}.json")
        assert (bench / "entries" / f"{traffic['entry']}.py").is_file()
        limits = harness.load_json(bench / "limits" / f"{w['name']}.json")
        assert all("limit" in v for v in limits.values())
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("conf", [c["name"] for c in FULL["configs"]])
def test_configuration_sizes_are_the_ports(conf):
    entry = {c["name"]: c for c in FULL["configs"]}[conf]
    arch = harness.port_arch(harness.load_json(harness.ROOT / entry["file"]))
    assert arch.name == conf


def test_limits_lie_between_their_readings():
    for w in FULL["workloads"]:
        limits = harness.load_json(harness.BENCH / "limits"
                                   / f"{w['name']}.json")
        for name, v in limits.items():
            if v.get("upper") is not None:
                assert v["lower"] < v["limit"] < v["upper"], name
                assert v["upper"] >= 3 * v["lower"], name


def test_bound_formula_counts_paths():
    for path in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path)
        assert not path.startswith("/") and ".." not in path
    assert not math.isnan(MAN["run_seconds"])
