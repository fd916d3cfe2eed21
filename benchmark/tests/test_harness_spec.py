"""BENCHMARK.json keeps the contract's shape, every cell loads by name, and
a new configuration, traffic mix and metric are picked up from files of
their own."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import run, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["workloads"] + BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert names == {"train_triples_per_s", "encode_entities_per_s",
                     "rank_triples_per_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.workload(BENCH, cell)
    assert c["chips"] == 1
    cfg = spec.load_config(BENCH, c["config"])
    assert cfg["name"] == c["config"]
    spec.family(cfg["family"])
    traffic = spec.load_traffic(c["traffic"])
    spec.driver(traffic["kind"])
    assert spec.load_limits(cell)
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and traffic["rate_metric"] in e2e and len(e2e) >= 2
    per_layer = spec.metrics_of(BENCH, cell, "per_layer")
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)


def test_config_files_lie_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((spec.ROOT / c["file"]).read_text())["reduced"] == c["reduced"]


def test_new_files_are_picked_up(tiny_root, tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files of
    their own run with no edit to any file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs/blp-bert-base.json").read_text())
    cfg["name"] = "blp-bert-new"
    (bench / "configs/blp-bert-new.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic/w5m-rank.json").read_text())
    traffic["graph"]["test_triples"] = 40
    (bench / "traffic/rank-new.json").write_text(json.dumps(traffic))
    (bench / "metrics/calls_new.py").write_text(
        "def read(ctx):\n    return float(ctx.window.steps)\n")
    shutil.copy(bench / "limits/bert-w5m-rank.json", bench / "limits/new-rank.json")
    index = json.loads((root / "BENCHMARK.json").read_text())
    index["configs"].append({"name": "blp-bert-new", "source": "s",
                             "file": "benchmark/configs/blp-bert-new.json",
                             "reduced": [], "why": "w"})
    index["workloads"].append({"name": "new-rank", "config": "blp-bert-new",
                               "traffic": "rank-new", "chips": 1, "why": "w"})
    for m in index["end_to_end"]:
        if m["name"] == "rank_triples_per_s":
            m["workloads"].append("new-rank")
    index["per_layer"].append({"name": "calls_new", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "l",
                               "moves": "rank_triples_per_s", "workloads": ["new-rank"]})
    (root / "BENCHMARK.json").write_text(json.dumps(index))
    out = run.execute("new-rank", 5, 0.2, True, "cpu", root=root)
    assert out["correct"]
    assert out["metrics"]["calls_new"]["value"] >= 1
    assert out["attempted"] % 40 == 0
