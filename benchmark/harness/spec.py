"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix.  Each lives in a file of its own under ``benchmark/``:

* ``configs/<config>.json``: the configuration as run (``settings``, the
  published JSON), its ``source``, ``reduced`` and ``assumed``;
* ``traffic/<traffic>.json``: the traffic mix's parameters (scenarios in
  lockstep, warm-up and episode length);
* ``workloads/<cell>.json``: what belongs to the cell alone: the limits of
  its correctness check and where the check samples;
* ``metrics/<metric>.py``: one metric's reader, ``read(run)``.

A later cell or metric is added as files and entries, with no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, NamedTuple, Optional

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "load_benchmark",
           "metric_reader", "metrics_of"]

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    chips: int
    config_name: str
    config: dict         # configs/<config>.json
    traffic_name: str
    traffic: dict        # traffic/<traffic>.json
    workload: dict       # workloads/<cell>.json


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Optional[str] = None) -> dict:
    return _read_json(os.path.join(root or ROOT, "BENCHMARK.json"))


def load_cell(name: str, bench: Optional[dict] = None,
              bench_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its three files."""
    bench = bench if bench is not None else load_benchmark()
    bench_dir = bench_dir or BENCH_DIR
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    w = entries[0]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"],
        config=_read_json(os.path.join(bench_dir, "configs",
                                       w["config"] + ".json")),
        traffic_name=w["traffic"],
        traffic=_read_json(os.path.join(bench_dir, "traffic",
                                        w["traffic"] + ".json")),
        workload=_read_json(os.path.join(bench_dir, "workloads",
                                         name + ".json")))


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    with ``--trace 0``, the per-layer ones with ``--trace 1``; an entry with
    ``workloads`` only in the cells it lists."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str, bench_dir: Optional[str] = None) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: a number, or None where the
    run holds nothing for it to read."""
    path = os.path.join(bench_dir or BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
