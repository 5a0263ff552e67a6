"""One run of one cell: set-up, the measured window, the metrics, the
check, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up loads the configuration, builds the program's controller for the
cell's task, loads K1 (built into ``build/torch_kernels/`` inside the
checkout on the first run there) and makes one control tick at the cell's
shapes.  The window then drives the program's evaluation entry from a
fresh round of the run's seed and closes at the first control tick past
``--seconds``.  With ``--trace 1`` the window also holds the spans and a
``torch.profiler`` trace of a few ticks, and the run reports the per-layer
metrics in place of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import sys
import time
from typing import List, NamedTuple, Optional

import torch

from . import check, guard, program, roofline, spec
from . import trace as trace_mod
from .window import Window

__all__ = ["Outcome", "Run", "main", "run_cell"]


class Outcome(NamedTuple):
    result: dict       # the result line's object
    rows: list         # the check's (name, value, limit)
    numbers: dict      # every number the check read
    window: Window


class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    def __init__(self, cell: spec.Cell, window: Window, setup_s: float,
                 peak_bytes: int, trace_summary=None, k1=None):
        self.cell = cell
        self.batch = int(cell.traffic["scenarios"])
        self.window = window
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.trace = trace_summary        # trace.TraceSummary or None
        self.k1 = k1 or []                # [(least s, kernel s)] a launch


def _parse(argv: Optional[List[str]]):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _k1_launches(window: Window, summary, cfg_settings: dict, device):
    """(least s, kernel s) of the last profiled tick's K1 launches: their
    work counted on their own inputs, their time from the trace."""
    from reference.settings import params
    if not window.k1_inputs or summary is None or not summary["k1_s"]:
        return []
    p = params(cfg_settings)
    times = summary["k1_s"][-len(window.k1_inputs):]
    out = []
    for (obst, dist, v0, a0), kernel_s in zip(window.k1_inputs, times):
        pairs, cells, win = roofline.k1_work(
            obst.to(device), dist.to(device), v0.to(device), a0.to(device),
            p)
        least = roofline.k1_least_s(win, pairs, cells, obst.shape[0],
                                    obst.shape[1])
        out.append((least, kernel_s))
    return out


def run_cell(args, t_start: float, device=None, drive=program.drive,
             control: bool = False):
    """The run without the look for a chip: an :class:`Outcome`.
    ``device`` and ``drive`` are the tests' handles; ``control`` also reads
    the control (the reference in TF32 in the program's place) on the same
    samples, under ``numbers["control"]``, and in the arbiter each planted
    gate fault (the reference with that gate dropped in the program's
    place), under ``numbers["no_<gate>"]`` (``benchmark/control.py``)."""
    bench = spec.load_benchmark()
    cell = spec.load_cell(args.workload, bench)
    wl = cell.workload
    device = device or torch.device("cuda", 0)
    cfg = program.settings(cell.config, cell.traffic, args.seed)
    parts = program.build(cfg, device)
    program.warm(cfg, parts, device)
    lo, hi = wl["capture_ticks"]
    window = Window(args.seconds, trace=bool(args.trace),
                    capture_tick=random.Random(args.seed).randint(lo, hi),
                    trace_from=wl["trace_from"],
                    profile_ticks=wl["profile_ticks"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    drive(window, cfg, parts, device, cell.traffic)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    summary = None
    if window.profiler is not None:
        summary = trace_mod.summarize(window.profiler)
        window.profiler = None
    del parts
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    k1 = _k1_launches(window, summary, cell.config["settings"], device)
    window.k1_inputs = []

    def compare(**kwargs):
        return check.compare(
            cell.config, wl, window.final_samples(), window.start_state,
            args.seed, int(cell.traffic["wait_before_start"]
                           / cfg.TICK_LENGTH), device, spec.ROOT, **kwargs)
    numbers = compare()
    if control:
        numbers["control"] = compare(tf32=True)
        if cfg.TASK != "ST":
            for gate in check.FAULTS:
                numbers["no_" + gate] = compare(fault=gate)
    correct, rows = check.verdict(numbers, wl["limits"])
    run = Run(cell, window, setup_s, peak, summary, k1)
    metrics = {}
    for m in spec.metrics_of(bench, cell.name, bool(args.trace)):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": run.batch * len(window.entries),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if args.trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = window.profile_window_s
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    return Outcome(result, rows, numbers, window)


def steady_host() -> None:
    """A tick is host-bound (section 5 of PERF.md): one thread for torch's
    CPU operations, and the main thread on one core of those the process
    may use (after CUDA's start, so that CUDA's own threads keep
    every core).  Runs then spread less from process to process."""
    torch.set_num_threads(1)
    torch.cuda.init()
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[-1]})


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = _parse(argv)
    cell = spec.load_cell(args.workload)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={count}",
              file=sys.stderr)
        return 2
    steady_host()
    out = run_cell(args, t_start)
    result, rows, numbers = out.result, out.rows, out.numbers
    found = guard.forbidden_modules()
    if found:
        print("benchmark: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    w = out.window
    ticks = [round(b - a, 4) for a, b in zip(w.entries, w.entries[1:])]
    print(f"window: {w.window_s:.3f} s, {len(w.entries)} ticks, the first "
          f"at {w.entries[0] - w.t0 if w.entries else None} s; intervals "
          f"{ticks[:5]} ... {ticks[-3:]}", file=sys.stderr)
    print("check (not limited): "
          + json.dumps({k: v for k, v in numbers.items()
                        if k not in result["checks"]}),
          file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} = {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
