"""BENCHMARK.json against the contract's shape, and the harness finding
each configuration, traffic mix and metric reader by name."""

import json
import re

import pytest

from benchmark import load, run
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    c, config, traffic = run.load_spec(BENCH, cell)
    # a built-in mode, or a mode file under benchmark/modes
    if traffic["mode"] not in load.MODES:
        load.mode_file(traffic["mode"], ROOT / "benchmark" / "modes")
    assert config["name"] == c["config"] and config["reduced"] == []
    e2e = [m["name"] for m in run.metrics_for(BENCH, cell, False)]
    per = run.metrics_for(BENCH, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per
    for m in per:                      # each moves a metric the cell has
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", [m["name"] for m in
                                  BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(run.reader(name))


def test_unknown_cell_fails():
    with pytest.raises(run.Failed):
        run.load_spec(BENCH, "no.such.cell")


def test_a_new_cell_is_data(tmp_path):
    """A cell added by files alone: a traffic mix in a directory of its
    own, found by name, with no edit to the harness."""
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "mix.json").write_text(json.dumps(
        {"mode": "compress", "pool": 2, "quota_bpp": 0.5, "warm": 1,
         "trace_requests": 1, "check_frames": 1}))
    bench["workloads"].append({"name": "mer1024.mix", "config":
                               "mer_navcam_1024", "traffic": "mix",
                               "chips": 1, "why": "t"})
    _, config, traffic = run.load_spec(bench, "mer1024.mix",
                                       traffic_dir=tmp_path)
    assert traffic["quota_bpp"] == 0.5 and config["width"] == 1024
