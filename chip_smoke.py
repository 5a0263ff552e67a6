#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (the pure-MPC ST evaluation at the full
st_default width: 128 scenarios, 18 x 3001 grids, 300 ADMM iterations) on
the card and holds every CUDA kernel of that path against its plain PyTorch
version.  Phases, in order; any failure exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from ``rl_mpc_lanemerging_torch/csrc``;
3. kernel vs plain version on realistic grids (128 worlds driven into the
   merge region by the port's own world and controller): >= 99.9% of s
   sequences identical within 1e-4 m, every first-step difference
   <= 0.101 m;
4. kernel vs the dense twin (``ops/st_dp.py``) on the same grids, at the
   JAX package's bars: >= 97% first-step agreement, largest first-step
   difference <= 0.101 m, >= 85% full-path match;
5. controller on the card vs the same controller on the CPU (plain kernel
   version) on 8 of those states: finite speeds within 1e-3 m/s;
6. main path: one round of ``tasks.evaluate_controller`` with the
   production controller at B=128; the kernel's launch count must equal
   the control ticks run;
7. per-stage split of one control tick, and kernel timing (CUDA events,
   median of 25 runs after warm-up) against its plain version and bound.

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
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations per (source, offset) pair: subtract, multiply, add,
# compare; per reachable cell and layer: band_and_moments (38) + the
# penalty add and the sentinel compare
OPS_PER_PAIR = 4
OPS_PER_CELL = 40


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
    st_kernel.load_kernel()
    print(f"   st_wavefront built in "
          f"{_build.build_seconds.get('st_wavefront', 0.0):.2f} s "
          f"(0 = found in build/torch_kernels)", flush=True)
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
    for _ in range(60):
        worlds = world_step(worlds, controller(sense(worlds, cfg)), cfg,
                            rng)
    states = sense(worlds, cfg)
    grids = build_st_grid(states, cfg, torch.float32)
    a0 = states.ego_accel.to(torch.float32)
    args = (grids.obstacles, grids.s_values, grids.ego_speed, a0,
            grids.distances)
    seq_k = st_kernel.st_wavefront(*args, **kw)
    seq_r = st_kernel.st_wavefront_reference(*args, **kw)
    torch.cuda.synchronize()
    k_np, r_np = seq_k.cpu().numpy(), seq_r.cpu().numpy()
    assert k_np.shape == (BATCH, cfg.num_t) and np.isfinite(k_np).all()
    identical = float(np.mean(np.all(np.abs(k_np - r_np) <= 1e-4, axis=1)))
    first_kr = np.abs((k_np[:, 1] - k_np[:, 0]) - (r_np[:, 1] - r_np[:, 0]))
    max_abs_err = float(np.abs(k_np - r_np).max())
    print(f"   identical paths {identical:.4f} (bar >= 0.999), max first-"
          f"step diff {first_kr.max():.6f} m (bar <= 0.101), max abs err "
          f"{max_abs_err:.3g}", flush=True)
    assert identical >= 0.999 and first_kr.max() <= 0.101
    done(t0)

    t0 = phase("4 kernel vs dense twin, same grids")
    seq_d = torch.cat([
        st_dp.solve_st_fast(grids.obstacles[i:i + 32],
                            grids.s_values[i:i + 32], grids.t_values,
                            grids.ego_speed[i:i + 32], a0[i:i + 32],
                            grids.distances[i:i + 32], w, moff)
        for i in range(0, BATCH, 32)])
    d_np = seq_d.cpu().numpy()
    step_diff = np.abs((k_np[:, 1] - k_np[:, 0]) - (d_np[:, 1] - d_np[:, 0]))
    first_agree = float(np.mean(step_diff < 1e-4))
    full_match = float(np.mean(np.all(np.isclose(k_np, d_np, atol=1e-3),
                                      axis=1)))
    print(f"   first-step agreement {first_agree:.4f} (bar >= 0.97), max "
          f"first-step diff {step_diff.max():.6f} m (bar <= 0.101), full-"
          f"path match {full_match:.4f} (bar >= 0.85)", flush=True)
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
    op = qp.build_operator(cfg.fine_horizon, cfg.TICK_LENGTH)
    seq, valid, _ = mpc.batched_plan(states, cfg, use_kernel=True)
    split = {
        "sense_ms": wall_ms(lambda: sense(worlds, cfg)),
        "grid_build_ms": wall_ms(lambda: build_st_grid(states, cfg)),
        "dp_kernel_ms": wall_ms(lambda: st_kernel.st_wavefront(*args, **kw)),
        "qp_ms": wall_ms(lambda: qp.finer_fit_qp(
            seq, valid, states.ego_speed, a0, op, cfg.T_DISCRETIZATION,
            cfg.MAX_SPEED, cfg.MAX_POSITIVE_ACCELERATION,
            cfg.MAX_NEGATIVE_ACCELERATION, cfg.MAXIMUM_POSITIVE_JERK,
            cfg.MINIMUM_NEGATIVE_JERK, iterations=cfg.QP_ITERATIONS)),
        "world_step_ms": wall_ms(lambda: world_step(
            worlds, states.ego_speed, cfg, rng)),
        "controller_ms": wall_ms(lambda: controller(states)),
    }
    print("   tick split (host ms, synchronised): "
          + json.dumps({k: round(v, 3) for k, v in split.items()}),
          flush=True)
    print("   tick profile: " + json.dumps(
        tick_profile(lambda: world_step(
            worlds, controller(sense(worlds, cfg)), cfg, rng))),
        flush=True)

    pen, v0, a0k, _, d_pad = st_kernel._prepare(
        grids.obstacles, grids.ego_speed, a0, grids.distances, w, moff)
    k_ms = cuda_ms(lambda: st_kernel.st_wavefront(*args, **kw))
    plain_ms = cuda_ms(lambda: st_kernel.st_wavefront_reference(*args, **kw))
    work = []
    st_kernel._wavefront_tables_reference(
        pen, v0, a0k, st_kernel._kernel_constants(
            cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION, w),
        cfg.num_s, d_pad, work=work)
    pairs = sum(p for p, _ in work)
    cells = sum(c for _, c in work)
    # bytes: obstacles (1 B) and distances (4 B) per cell, s_values, the
    # start state, and the (B, T) s sequences written
    n_cells = BATCH * cfg.num_t * cfg.num_s
    n_bytes = n_cells * 5 + BATCH * cfg.num_s * 4 + BATCH * 8 \
        + BATCH * cfg.num_t * 4
    n_ops = pairs * OPS_PER_PAIR + cells * OPS_PER_CELL
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    dense_pairs = st_kernel.candidate_count(cfg.num_t, cfg.num_s, moff)
    print(f"   st_wavefront {k_ms:.4f} ms, plain version {plain_ms:.4f} ms; "
          f"bytes {n_bytes} ({bytes_ms:.5f} ms), ops {n_ops} from {pairs} "
          f"in-band pairs and {cells} reachable cells ({ops_ms:.5f} ms); "
          f"the kernel as written visits {dense_pairs * BATCH} pairs",
          flush=True)
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
        "identical_paths": identical,
        "dense_first_step_agreement": first_agree,
        "dense_full_path_match": full_match,
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
