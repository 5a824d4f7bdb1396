"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import re
import runpy

from bench import harness
from bench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|"
                   r"expansion|experts_per_tok)")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"] == ["python3", "bench/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert TEXT.match(e["why"])
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and names <= set(harness.E2E)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_configs_name_their_files_and_changed_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["source"] == cfg["source"] and c["file"].startswith("bench/")
        assert sorted(c["reduced"]) == sorted(cfg["published"]), c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
            assert cfg[key] != cfg["published"][key]
        harness.port_config(cfg)  # the port runs what the file states


def test_cells_have_their_files_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    configs = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["config"] in configs and cell["chips"] in (1, 4)
        spec = harness.load_spec(cell["name"])
        assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2
        assert spec["per_layer"], cell["name"]
        t = spec["traffic"]
        assert t["checked_steps"] <= t["steps_per_sync"] and t["trace_groups"] >= 1
        assert set(spec["limits"]) <= set(harness.NUMBERS) and spec["limits"]
        assert all(0 < v < 1 for v in spec["limits"].values())
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


def test_each_per_layer_metric_is_a_reader_file():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        path = ROOT / "bench" / "metrics" / f"{m['name']}.py"
        assert callable(runpy.run_path(str(path))["read"]), m["name"]
