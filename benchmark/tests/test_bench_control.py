"""The control comes out not correct; the run's entry needs a card.

The control is the plain reference in the program's place with its
products in TF32 (the QP's, and the actor's in the arbiter): the step below
the float32 with TF32 off that the program states.  On the card it is read
at the cells' own size by ``benchmark/control.py`` (PERF.md); here at 4
scenarios on the CPU, TF32 emulated by rounding each product's inputs.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from harness import main, spec


def _failed(numbers, limits):
    return [k for k, lim in limits.items()
            if numbers.get(k) is None or not numbers[k] <= lim]


@pytest.mark.parametrize("cell", ["st_default.row4096",
                                  "combined_default_1.row4096"])
def test_control_fails_and_sound_run_passes(tiny_root, cell):
    args = argparse.Namespace(workload=cell, seed=2_999_999_999,
                              seconds=10.0, trace=0)
    out = main.run_cell(args, time.perf_counter(),
                        device=torch.device("cpu"), control=True)
    limits = spec.load_cell(cell).workload["limits"]
    assert out.result["correct"]
    want = ["cmd_mismatch_pct"] + (["plan_mismatch_pct"]
                                   if cell.startswith("combined") else [])
    assert _failed(out.numbers["control"], limits) == want


def test_entry_refuses_without_the_cells_devices(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main.main(["--workload", "st_default.row4096", "--seed", "1",
                      "--seconds", "1", "--trace", "0"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs 1 CUDA device" in captured.err


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    """The entry as a check runs it, a short window: one result line,
    correct, no JAX loaded."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "st_default.row4096", "--seed", "2147483647", "--seconds", "12",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert os.path.isdir(os.path.join(spec.ROOT, "build", "torch_kernels"))
