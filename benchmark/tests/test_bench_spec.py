"""BENCHMARK.json against the benchmark's contract, and the harness
finding every configuration, cell and metric by name."""

import json
import os
import re
import shutil

import pytest

from harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_sources(bench):
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_per_layer_move_reported_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = spec.metrics_of(bench, w["name"], trace=False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_of(bench, w["name"], trace=True)
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            data = json.load(fh)
        assert data["reduced"] == c["reduced"]
        # the configuration as run is the paper's published JSON
        with open(os.path.join(ROOT, "configs", c["name"] + ".json")) as fh:
            assert data["settings"] == json.load(fh)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert cell.config_name == w["config"]
        assert cell.traffic["scenarios"] >= 1
        assert set(cell.workload["limits"]) >= {
            "start_speed_err", "sense_err", "sense_slots_differ",
            "cmd_mismatch_pct", "ego_step_err"}
        if cell.config["settings"]["TASK"] != "ST":
            assert set(cell.workload["limits"]) >= {
                "plan_mismatch_pct", "cert_mismatch_pct",
                "take_mismatch_pct"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_added_files_add_a_cell_with_no_edit(tmp_path, bench):
    """A later change adds a cell and a metric as files and entries: the
    harness finds them without a change to its code."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "traffic" / "row1024.json").write_text(json.dumps(
        {"scenarios": 1024, "wait_before_start": 50.0,
         "max_episode_length": 100.0}))
    (bench_dir / "workloads" / "st_default.row1024.json").write_text(
        (bench_dir / "workloads" / "st_default.row4096.json").read_text())
    (bench_dir / "metrics" / "ticks_done.py").write_text(
        "def read(run):\n    return len(run.window.entries)\n")
    added = dict(bench)
    added["workloads"] = bench["workloads"] + [
        {"name": "st_default.row1024", "config": "st_default",
         "traffic": "row1024", "chips": 1, "why": "a smaller row"}]
    added["per_layer"] = bench["per_layer"] + [
        {"name": "ticks_done", "unit": "ticks", "better": "higher",
         "source": "host_clock", "layer": "episode loop",
         "moves": "scen_ticks_per_s"}]
    cell = spec.load_cell("st_default.row1024", added, str(bench_dir))
    assert cell.traffic["scenarios"] == 1024
    assert cell.config["settings"]["TASK"] == "ST"
    names = [m["name"] for m in spec.metrics_of(added, cell.name, True)]
    assert "ticks_done" in names
    read = spec.metric_reader("ticks_done", str(bench_dir))

    class Window:
        entries = [0.0, 0.4, 0.8]

    class Run:
        window = Window()
    assert read(Run()) == 3


def test_unknown_cell_is_named():
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("no_such.cell")
