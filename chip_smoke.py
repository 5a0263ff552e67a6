#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (the pure-MPC ST evaluation at the full
st_default width: 128 scenarios, 18 x 3001 grids, 300 ADMM iterations) on
the card and holds every CUDA kernel of that path against its plain PyTorch
version.  Phases, in order; any failure exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from ``rl_mpc_lanemerging_torch/csrc``, one
   ``nvcc`` per source, started together: K1 and its full-scan yardstick;
3. kernel vs plain version on 1024 realistic grids (8 snapshots, 10 ticks
   apart, of 128 worlds driven through the merge region by the port's own
   world and controller), in one launch at B=1024: >= 99.9% of s sequences
   identical within 1e-4 m, every first-step difference <= 0.101 m;
4. kernel vs the dense twin (``ops/st_dp.py``) on the same grids, at the
   JAX package's bars: >= 97% first-step agreement, largest first-step
   difference <= 0.101 m, >= 85% full-path match; every disagreement is
   printed, sorted as equal-cost tie, f32 flip or band edge;
5. controller on the card vs the same controller on the CPU (plain kernel
   version) on 8 of those states: finite speeds within 1e-3 m/s;
6. main path: one round of ``tasks.evaluate_controller`` with the
   production controller at B=128; the kernel's launch count must equal
   the control ticks run;
7. per-stage split of one control tick, and kernel timing on the first
   snapshot's 128 grids: the kernel alone (``ms``: CUDA events around runs
   of 20 launches on prepared inputs, median of 25 runs) and the wrapper end
   to end (``wrapper_ms``), each beside the full-scan kernel the port began
   with (``earlier_ms``, ``earlier_wrapper_ms``), in the order earlier, new,
   new, earlier; the pairs the kernel's own counter saw against the in-band
   pairs of the plain version; the plain version's time and the bound.

Prints the ``kernels`` JSON line before the last line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/st_default.json"
BATCH = 128
# The main path's episode budget (seconds of simulated time), the CLI's
# default.  This script's first run on an H100 80GB HBM3 (700 W) measured
# 0.29 s per control tick with warmup included: a round of 100 s episodes
# (every st_default episode merges first) took 178 ticks, 52 s.
MAX_EPISODE_LENGTH = 100.0
TIMING_RUNS = 25
LAUNCHES_PER_RUN = 20
SNAPSHOTS = 8            # of the 128 worlds, SNAPSHOT_EVERY ticks apart
SNAPSHOT_EVERY = 10
FIRST_SNAPSHOT = 60      # ticks after the ego joins
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations per (source, offset) pair: subtract, multiply, add,
# compare; per reachable cell and layer: band_and_moments (38) + the
# penalty (6) + the penalty add and the sentinel compare
OPS_PER_PAIR = 4
OPS_PER_CELL = 46


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float) -> None:
    print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median CUDA-event time of fn() in ms, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def cuda_ms_launches(launch, per_run: int = LAUNCHES_PER_RUN,
                     runs: int = TIMING_RUNS) -> float:
    """Median CUDA-event time of one launch() in ms: events around
    ``per_run`` launches in a row, so that the card and not the host's
    enqueue is timed; inputs are prepared before, and stay in the L2."""
    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(per_run):
            launch()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / per_run)
    return statistics.median(times)


def cuda_ms_cold(launch, flush, runs: int = 10) -> float:
    """Median CUDA-event time of one launch() in ms with the inputs out of
    the L2: ``flush`` (larger than the cache) is rewritten before each."""
    times = []
    for _ in range(runs):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def wall_ms(fn, runs: int = 10) -> float:
    """Median host time of fn() in ms, synchronised (a stage that is many
    small launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tick_profile(tick, ticks: int = 3) -> dict:
    """torch.profiler over a few control ticks: wall time, device time
    summed over kernels, the device's idle share, and kernel launches per
    tick."""
    from torch.profiler import ProfilerActivity, profile
    tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in kernels)
    return {
        "tick_wall_ms": wall_us / ticks / 1e3,
        "tick_device_ms": device_us / ticks / 1e3 if kernels else
        "not measured",
        "device_idle_share": 1.0 - device_us / wall_us if kernels else
        "not measured",
        "device_ops_per_tick": len(kernels) / ticks,
    }


def walk_path(seq, obstacles, s_values, distances, v0, a0, delta_t, w,
              dtype=torch.float64):
    """One scenario's path through the dense twin's own expressions in
    ``dtype``: (cells walked, total cost, every step inside the jerk-limited
    index range and off obstacles, least distance in cells of a step from
    the edge of its range).  ``seq`` is zero-filled past its last layer."""
    from rl_mpc_lanemerging_torch.ops import st_dp
    f64 = dtype
    s_val = s_values.to(f64)
    seq = seq.to(f64)
    n = int(torch.nonzero(seq != 0.0).max()) + 1 if bool(
        (seq != 0.0).any()) else 1
    idx = [int(torch.argmin((s_val - seq[t]).abs())) for t in range(n)]
    dt = torch.tensor(float(delta_t), dtype=f64)
    start_s, delta_s = s_val[0], s_val[1] - s_val[0]
    prev = s_val[0] - float(v0) * dt
    second = prev - dt * (float(v0) - float(a0) * dt)
    cost = torch.zeros((), dtype=f64)
    feasible, margin = idx[0] == 0, float("inf")
    for t in range(1, n):
        s_i, s_j = s_val[idx[t - 1]], s_val[idx[t]]
        mn, mx = st_dp._feasible_range_with_jerk(s_i, prev, second, dt, w)
        lo, hi = st_dp._range_indices(start_s, delta_s, mn, mx)
        feasible = feasible and int(lo) <= idx[t] <= int(hi) \
            and not bool(obstacles[t, idx[t]])
        margin = min(margin,
                     abs(float((mn - start_s) / delta_s) - idx[t]),
                     abs(float((mx - start_s) / delta_s) - idx[t]))
        cost = cost + st_dp._edge_cost_jerk(
            s_j, s_i, prev, second, dt, distances[t, idx[t]].to(f64), w)
        prev, second = s_i, prev
    return n, float(cost), feasible, margin


def in_kernel_bands(seq, s_values, v0, a0, delta_t, delta_s, w,
                    max_offset) -> bool:
    """Whether every step of one scenario's path lies inside the integer
    band the kernel's own float32 arithmetic gives its source."""
    from rl_mpc_lanemerging_torch.ops import st_kernel
    consts = st_kernel._kernel_constants(delta_t, delta_s, w)
    k = {name: torch.tensor(float(val), dtype=torch.float32)
         for name, val in zip(st_kernel._CONST_NAMES, consts)}
    _, d_pad = st_kernel.kernel_shapes(s_values.shape[0], max_offset)
    n = int(torch.nonzero(seq != 0.0).max()) + 1 if bool(
        (seq != 0.0).any()) else 1
    idx = [int(torch.argmin((s_values - seq[t]).abs())) for t in range(n)]
    v0 = torch.tensor(v0, dtype=torch.float32)
    a0 = torch.tensor(a0, dtype=torch.float32)
    u = v0 * k["dt"]
    beta = 2.0 * v0 * k["dt"] - k["dt"] * (v0 - a0 * k["dt"])
    for t in range(1, n):
        _, _, xlo, xhi = st_kernel._band_and_moments(
            k, torch.zeros(()), u, beta)
        lo, hi = st_kernel._integer_band(xlo, xhi, d_pad)
        d = idx[t] - idx[t - 1]
        if not int(lo) <= d <= int(hi):
            return False
        u_new = torch.tensor(float(d)) * k["ds"]
        u, beta = u_new, 2.0 * u_new - u
    return True


def classify_disagreement(seq_k, seq_d, obstacles, s_values, distances, v0,
                          a0, delta_t, delta_s, w, max_offset) -> dict:
    """Sort one scenario's differing kernel and dense-twin paths (CPU
    tensors).  ``band edge``: the paths end at different layers, one is
    infeasible when walked in float64, the dense twin's path leaves the
    kernel's own float32 bands, or a step sits within 1e-3 cells of the edge
    of its range.  Else ``equal-cost tie`` when the float64 costs agree to
    1e-9, else ``f32 flip``: both paths are feasible for both solvers and a
    float32 near-tie at some cell was settled differently (each cell keeps
    one arrival, so the final costs may then differ by more than rounding);
    the dense twin rerun in float64 says whose rounding it was."""
    from rl_mpc_lanemerging_torch.ops import st_dp
    n_k, cost_k, ok_k, edge_k = walk_path(seq_k, obstacles, s_values,
                                          distances, v0, a0, delta_t, w)
    n_d, cost_d, ok_d, edge_d = walk_path(seq_d, obstacles, s_values,
                                          distances, v0, a0, delta_t, w)
    in_bands = in_kernel_bands(seq_d, s_values, v0, a0, delta_t, delta_s, w,
                               max_offset)
    gap = abs(cost_k - cost_d) / max(1.0, abs(cost_k), abs(cost_d))
    f64 = torch.float64
    num_t = obstacles.shape[0]
    seq_64 = st_dp.solve_st_fast(
        obstacles[None], s_values[None].to(f64),
        torch.arange(num_t, dtype=f64) * float(delta_t),
        torch.tensor([v0], dtype=f64), torch.tensor([a0], dtype=f64),
        distances[None].to(f64), w, max_offset)[0]
    sides = [name for name, seq in (("kernel", seq_k), ("dense twin", seq_d))
             if torch.allclose(seq_64, seq.to(f64), atol=1e-3, rtol=0)]
    if n_k != n_d or not (ok_k and ok_d and in_bands) \
            or min(edge_k, edge_d) < 1e-3:
        kind = "band edge"
    elif gap <= 1e-9:
        kind = "equal-cost tie"
    else:
        kind = "f32 flip"
    return {"kind": kind, "relative_cost_gap": gap, "layers": (n_k, n_d),
            "feasible_f64": (ok_k, ok_d), "dense_path_in_kernel_bands":
            in_bands, "edge_margin_cells": min(edge_k, edge_d),
            "float64_dense_agrees_with": sides or ["neither"],
            "first_step_diff_m": abs(float(
                (seq_k[1] - seq_k[0]) - (seq_d[1] - seq_d[0])))}


def load_scan_kernel():
    """The full-scan kernel the port began with (csrc/st_wavefront_scan.cu),
    bound here because nothing in the port launches it."""
    import ctypes
    from rl_mpc_lanemerging_torch.ops import _build

    def declare(lib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.st_wavefront_scan_launch.argtypes = [vp] * 6 + [ci] * 5 + [vp, vp]
        lib.st_wavefront_scan_launch.restype = ci
    return _build.load("st_wavefront_scan", declare)


def scan_launcher(lib, pen, v0, a0, consts, num_s: int, d_pad: int):
    """(launch, (bp, vmin, amin)) for the full-scan kernel on a folded
    penalty tensor (B, T, s_pad): its tables go to st_kernel._backtrace."""
    batch, num_t, s_pad = pen.shape
    bp = torch.empty((batch, num_t, s_pad), dtype=torch.int32,
                     device=pen.device)
    vmin = torch.empty((batch, num_t), dtype=torch.float32,
                       device=pen.device)
    amin = torch.empty((batch, num_t), dtype=torch.int32, device=pen.device)

    def launch():
        rc = lib.st_wavefront_scan_launch(
            pen.data_ptr(), v0.data_ptr(), a0.data_ptr(), bp.data_ptr(),
            vmin.data_ptr(), amin.data_ptr(), batch, num_t, num_s, s_pad,
            d_pad, consts.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"st_wavefront_scan: CUDA error {rc}")
    return launch, (bp, vmin, amin)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.ops import _build, st_dp, st_kernel
    from rl_mpc_lanemerging_torch.ops import qp
    from rl_mpc_lanemerging_torch.planner import mpc
    from rl_mpc_lanemerging_torch.planner.grid import build_st_grid
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, add_ego,
                                              init_world, sense, warmup,
                                              world_step)

    t0 = phase("1 device")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda")
    done(t0)

    t0 = phase("2 build")
    from concurrent.futures import ThreadPoolExecutor
    names = ("st_wavefront", "st_wavefront_scan")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    st_kernel.load_kernel()
    scan_lib = load_scan_kernel()
    for name in names:
        print(f"   {name} built in {_build.build_seconds.get(name, 0.0):.2f}"
              f" s (0 = found in build/torch_kernels)", flush=True)
    done(t0)

    cfg = Settings.load_from_file(CONFIG)
    w = mpc.weights_from_settings(cfg)
    moff = st_dp.default_max_offset(cfg.MAX_SPEED, cfg.T_DISCRETIZATION,
                                    cfg.S_DISCRETIZATION)
    kw = dict(delta_t=cfg.T_DISCRETIZATION, delta_s=cfg.S_DISCRETIZATION,
              w=w, max_offset=moff)
    controller = mpc.make_batched_controller(cfg)

    t0 = phase("3 kernel vs plain version, realistic grids")
    rng = CounterRandom(0)
    worlds = init_world(cfg, BATCH, torch.float32, dev)
    worlds = warmup(worlds, cfg, int(50.0 / cfg.TICK_LENGTH), rng)
    worlds = add_ego(worlds, torch.full((BATCH,), 15.0, device=dev))
    snapshots = []        # (args of st_wavefront) per snapshot
    states = worlds0 = t_values = None
    last_tick = FIRST_SNAPSHOT + SNAPSHOT_EVERY * (SNAPSHOTS - 1)
    for tick in range(1, last_tick + 1):
        worlds = world_step(worlds, controller(sense(worlds, cfg)), cfg,
                            rng)
        if tick >= FIRST_SNAPSHOT \
                and (tick - FIRST_SNAPSHOT) % SNAPSHOT_EVERY == 0:
            sensed = sense(worlds, cfg)
            g = build_st_grid(sensed, cfg, torch.float32)
            snapshots.append((g.obstacles, g.s_values, g.ego_speed,
                              sensed.ego_accel.to(torch.float32),
                              g.distances))
            if states is None:      # the first snapshot also feeds 5 and 7
                states, worlds0, t_values = sensed, worlds, g.t_values
    args = snapshots[0]
    all_args = tuple(torch.cat([snap[i] for snap in snapshots])
                     for i in range(5))
    n_grids = all_args[0].shape[0]
    visited_all = torch.zeros(1, dtype=torch.int64, device=dev)
    seq_k = st_kernel.st_wavefront(*all_args, **kw, visited=visited_all)
    seq_r = torch.cat([st_kernel.st_wavefront_reference(*snap, **kw)
                       for snap in snapshots])
    torch.cuda.synchronize()
    k_np, r_np = seq_k.cpu().numpy(), seq_r.cpu().numpy()
    assert k_np.shape == (n_grids, cfg.num_t) and np.isfinite(k_np).all()
    identical = float(np.mean(np.all(np.abs(k_np - r_np) <= 1e-4, axis=1)))
    first_kr = np.abs((k_np[:, 1] - k_np[:, 0]) - (r_np[:, 1] - r_np[:, 0]))
    max_abs_err = float(np.abs(k_np - r_np).max())
    print(f"   {n_grids} grids in one launch: identical paths "
          f"{identical:.4f} (bar >= 0.999), max first-step diff "
          f"{first_kr.max():.6f} m (bar <= 0.101), max abs err "
          f"{max_abs_err:.3g}; complete paths "
          f"{int((k_np[:, -1] != 0).sum())}", flush=True)
    assert identical >= 0.999 and first_kr.max() <= 0.101
    done(t0)

    t0 = phase("4 kernel vs dense twin, same grids")
    obst_a, sval_a, v0_a, a0_a, dist_a = all_args
    seq_d = torch.cat([
        st_dp.solve_st_fast(obst_a[i:i + 32], sval_a[i:i + 32], t_values,
                            v0_a[i:i + 32], a0_a[i:i + 32],
                            dist_a[i:i + 32], w, moff)
        for i in range(0, n_grids, 32)])
    d_np = seq_d.cpu().numpy()
    step_diff = np.abs((k_np[:, 1] - k_np[:, 0]) - (d_np[:, 1] - d_np[:, 0]))
    first_agree = float(np.mean(step_diff < 1e-4))
    same_path = np.all(np.isclose(k_np, d_np, atol=1e-3), axis=1)
    full_match = float(np.mean(same_path))
    print(f"   first-step agreement {first_agree:.4f} (bar >= 0.97), max "
          f"first-step diff {step_diff.max():.6f} m (bar <= 0.101), full-"
          f"path match {full_match:.4f} (bar >= 0.85)", flush=True)
    kinds = {"equal-cost tie": 0, "f32 flip": 0, "band edge": 0}
    reports = []
    for i in np.flatnonzero(~same_path):
        rep = classify_disagreement(
            seq_k[i].cpu(), seq_d[i].cpu(), obst_a[i].cpu(), sval_a[i].cpu(),
            dist_a[i].cpu(), float(v0_a[i]), float(a0_a[i]),
            cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION, w, moff)
        kinds[rep["kind"]] += 1
        reports.append((rep["kind"], int(i), rep))
    for kind, i, rep in sorted(reports, key=lambda r: (r[0], r[1])):
        print(f"   grid {i} (snapshot {i // BATCH}, world {i % BATCH}): "
              + json.dumps(rep), flush=True)
    print(f"   kernel-vs-dense disagreements: {len(reports)} of {n_grids}: "
          + json.dumps(kinds), flush=True)
    assert first_agree >= 0.97 and step_diff.max() <= 0.101 \
        and full_match >= 0.85
    done(t0)

    t0 = phase("5 controller on the card vs on the CPU")
    small = type(states)(*(x[:8] for x in states))
    speed_gpu = controller(small).cpu()
    small_cpu = type(states)(*(x.cpu() for x in small))
    speed_cpu = mpc.batched_st_control(small_cpu, cfg, use_kernel=True)[0]
    gap = float((speed_gpu - speed_cpu).abs().max())
    print(f"   speeds {speed_gpu.numpy().round(4).tolist()}; max |card - "
          f"cpu| {gap:.3g} m/s (bar <= 1e-3)", flush=True)
    assert torch.isfinite(speed_gpu).all() and gap <= 1e-3
    done(t0)

    t0 = phase("6 main path: evaluate_controller, st_default, B=128")
    ticks_run = 0

    def counted(state):
        nonlocal ticks_run
        ticks_run += 1
        return controller(state)

    main_cfg = cfg.replace(BATCH_SCENARIOS=BATCH)
    st_kernel.launches = 0
    t_main = time.perf_counter()
    agg = tasks.evaluate_controller(
        main_cfg, counted, num_episodes=BATCH, device=dev,
        max_episode_length=MAX_EPISODE_LENGTH, verbose=False)
    main_s = time.perf_counter() - t_main
    launches = st_kernel.launches
    cols = agg.columns
    crash = float(np.mean(cols["crashed"]))
    merge = float(np.mean(cols["merged"]))
    mean_ticks = float(np.mean(cols["time_taken"])) / cfg.TICK_LENGTH
    jerk = float(np.mean(cols["mean_abs_jerk"]))
    s_per_tick = main_s / max(ticks_run, 1)
    print(f"   max_episode_length {MAX_EPISODE_LENGTH} s; crash {crash:.4f} "
          f"merge {merge:.4f} mean ticks {mean_ticks:.1f} mean |jerk| "
          f"{jerk:.4f}; {ticks_run} control ticks in {main_s:.2f} s = "
          f"{s_per_tick:.4f} s per tick (warmup included); st_wavefront "
          f"launches {launches}", flush=True)
    assert len(cols["crashed"]) == BATCH and np.isfinite(jerk)
    assert launches == ticks_run > 0, (launches, ticks_run)
    done(t0)

    t0 = phase("7 tick split and kernel timing")
    a0 = args[3]
    op = qp.build_operator(cfg.fine_horizon, cfg.TICK_LENGTH)
    seq, valid, _ = mpc.batched_plan(states, cfg, use_kernel=True)
    split = {
        "sense_ms": wall_ms(lambda: sense(worlds0, cfg)),
        "grid_build_ms": wall_ms(lambda: build_st_grid(states, cfg)),
        "dp_wrapper_ms": wall_ms(
            lambda: st_kernel.st_wavefront(*args, **kw)),
        "qp_ms": wall_ms(lambda: qp.finer_fit_qp(
            seq, valid, states.ego_speed, a0, op, cfg.T_DISCRETIZATION,
            cfg.MAX_SPEED, cfg.MAX_POSITIVE_ACCELERATION,
            cfg.MAX_NEGATIVE_ACCELERATION, cfg.MAXIMUM_POSITIVE_JERK,
            cfg.MINIMUM_NEGATIVE_JERK, iterations=cfg.QP_ITERATIONS)),
        "world_step_ms": wall_ms(lambda: world_step(
            worlds0, states.ego_speed, cfg, rng)),
        "controller_ms": wall_ms(lambda: controller(states)),
    }
    print("   tick split (host ms, synchronised): "
          + json.dumps({k: round(v, 3) for k, v in split.items()}),
          flush=True)
    print("   tick profile: " + json.dumps(
        tick_profile(lambda: world_step(
            worlds0, controller(sense(worlds0, cfg)), cfg, rng))),
        flush=True)

    # the kernel alone on prepared inputs, and the full-scan kernel the
    # port began with on its prepared inputs (the folded penalty tensor)
    obst, s_val, v0, _, dist = args
    consts = st_kernel._kernel_constants(cfg.T_DISCRETIZATION,
                                         cfg.S_DISCRETIZATION, w)
    s_pad, d_pad = st_kernel.kernel_shapes(cfg.num_s, moff)
    pen = st_kernel.fold_penalty(obst, dist, w, s_pad)
    launch, out = st_kernel.prepare_launch(*args, **kw)
    scan_launch, scan_tables = scan_launcher(scan_lib, pen, v0, a0, consts,
                                             cfg.num_s, d_pad)

    def scan_wrapper():     # the wrapper as it was around the scan kernel
        launch_again, tables = scan_launcher(
            scan_lib, st_kernel.fold_penalty(obst, dist, w, s_pad), v0, a0,
            consts, cfg.num_s, d_pad)
        launch_again()
        return st_kernel._backtrace(*tables, s_val)

    launch()
    scan_launch()
    torch.cuda.synchronize()
    seq_scan = st_kernel._backtrace(*scan_tables, s_val)
    assert torch.equal(out, seq_scan), "kernel and full-scan kernel differ"
    assert torch.equal(out, seq_k[:BATCH])

    for threads in (256, 512, 1024):
        sized, _ = st_kernel.prepare_launch(*args, **kw, threads=threads)
        print(f"   st_wavefront at {threads} threads per block: "
              f"{cuda_ms_launches(sized):.5f} ms", flush=True)
    earlier = [cuda_ms_launches(scan_launch)]
    new = [cuda_ms_launches(launch), cuda_ms_launches(launch)]
    earlier.append(cuda_ms_launches(scan_launch))
    earlier_w = [cuda_ms(scan_wrapper)]
    new_w = [cuda_ms(lambda: st_kernel.st_wavefront(*args, **kw)),
             cuda_ms(lambda: st_kernel.st_wavefront(*args, **kw))]
    earlier_w.append(cuda_ms(scan_wrapper))
    k_ms, earlier_ms = statistics.mean(new), statistics.mean(earlier)
    wrapper_ms = statistics.mean(new_w)
    earlier_wrapper_ms = statistics.mean(earlier_w)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    cold_ms = cuda_ms_cold(launch, flush)
    earlier_cold_ms = cuda_ms_cold(scan_launch, flush)
    del flush
    plain_ms = cuda_ms(lambda: st_kernel.st_wavefront_reference(*args, **kw))
    print(f"   kernel alone (earlier, new, new, earlier): {earlier[0]:.5f} "
          f"{new[0]:.5f} {new[1]:.5f} {earlier[1]:.5f} ms; wrapper: "
          f"{earlier_w[0]:.5f} {new_w[0]:.5f} {new_w[1]:.5f} "
          f"{earlier_w[1]:.5f} ms; one launch with the L2 flushed: new "
          f"{cold_ms:.5f}, earlier {earlier_cold_ms:.5f} ms", flush=True)

    # the work these inputs need, from the plain versions: in-band pairs
    # and reachable cells (the scan), the cells of each layer's window (the
    # banded form); the kernel's own counter beside them
    visited = torch.zeros(1, dtype=torch.int64, device=dev)
    st_kernel.st_wavefront(*args, **kw, visited=visited)
    visited_pairs = int(visited.item())
    work, work_banded = [], []
    st_kernel._wavefront_tables_reference(pen, v0, a0, consts, cfg.num_s,
                                          d_pad, work=work)
    st_kernel._wavefront_tables_banded(pen, v0, a0, consts, cfg.num_s, d_pad,
                                       work=work_banded)
    pairs = sum(p for p, _ in work)
    cells = sum(c for _, c in work)
    window_cells = sum(n for _, _, n in work_banded)
    assert [x[:2] for x in work_banded] == work
    assert pairs <= visited_pairs <= 8 * pairs, (visited_pairs, pairs)
    # bytes these inputs make the function move: obstacles (1 B) and
    # distances (4 B) of the cells inside each layer's reachable window,
    # s_values at the T cells of each path, the start state, and the (B, T)
    # sequences written.  Beside it the count of every input cell once.
    n_bytes = window_cells * 5 + BATCH * cfg.num_t * 4 + BATCH * 8 \
        + BATCH * cfg.num_t * 4
    all_bytes = BATCH * cfg.num_t * cfg.num_s * 5 + BATCH * cfg.num_s * 4 \
        + BATCH * 8 + BATCH * cfg.num_t * 4
    n_ops = pairs * OPS_PER_PAIR + cells * OPS_PER_CELL
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"   st_wavefront {k_ms:.5f} ms (wrapper {wrapper_ms:.5f}), "
          f"full-scan kernel {earlier_ms:.5f} ms (wrapper "
          f"{earlier_wrapper_ms:.5f}), plain version {plain_ms:.4f} ms; "
          f"visited pairs {visited_pairs} vs {pairs} in-band pairs "
          f"({visited_pairs / pairs:.3f} x; B=1024: "
          f"{int(visited_all.item())}); {cells} reachable cells, "
          f"{window_cells} window cells; bytes {n_bytes} "
          f"({bytes_ms:.5f} ms; every input cell once: {all_bytes}, "
          f"{all_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms), ops {n_ops} "
          f"({ops_ms:.5f} ms); kernel / bound {k_ms / bound_ms:.1f}",
          flush=True)
    assert min(new + [cold_ms]) > bound_ms, "a kernel time below its bound"
    done(t0)

    kernels = [{
        "name": "st_wavefront",
        "route": "cuda",
        "source": "rl_mpc_lanemerging_torch/csrc/st_wavefront.cu",
        "replaces": "rl_mpc_lanemerging_tpu/ops/st_pallas.py:70",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
        "cold_l2_ms": cold_ms,
        "earlier_ms": earlier_ms,
        "earlier_wrapper_ms": earlier_wrapper_ms,
        "earlier_cold_l2_ms": earlier_cold_ms,
        "visited_pairs": visited_pairs,
        "in_band_pairs": pairs,
        "grids_compared": n_grids,
        "identical_paths": identical,
        "dense_first_step_agreement": first_agree,
        "dense_full_path_match": full_match,
        "dense_disagreements": kinds,
        "control_ticks": ticks_run,
        "seconds_per_tick": s_per_tick,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
