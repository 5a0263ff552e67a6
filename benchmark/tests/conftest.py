"""Tests of the benchmark: ``python -m pytest benchmark/tests -q``.

Tests that need the card carry the ``cuda`` marker and decide in a fixture
whether they skip.  ``tiny_root`` is a copy of the benchmark whose cells
run 4 scenarios, for runs on the CPU.
"""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc); skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout-like directory: BENCHMARK.json with every cell on a
    4-scenario traffic mix that samples its first control tick, the
    benchmark's files, and the program's weights; the harness pointed at
    it."""
    from harness import spec
    root = tmp_path / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "rl_mpc_lanemerging_torch"),
               root / "rl_mpc_lanemerging_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for w in bench["workloads"]:
        w["traffic"] = "tiny"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with open(bench_dir / "traffic" / "row4096.json") as fh:
        traffic = json.load(fh)
    traffic["scenarios"] = 4
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    # a CPU tick at 4 scenarios takes seconds: sample the first one
    for path in (bench_dir / "workloads").glob("*.json"):
        cell = json.loads(path.read_text())
        cell["capture_ticks"] = [1, 1]
        path.write_text(json.dumps(cell))
    monkeypatch.setattr(spec, "ROOT", str(root))
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    return root
