#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths on the card, each at full width (128
scenarios, 18 x 3001 grids, 300 ADMM iterations): the pure-MPC ST
evaluation (st_default) with its crash capture, the combined RL+MPC arbiter
with its trained 20-256-256-1 actor (combined_default_1), the training path
(the batched merge env, the replay and the DDPG and Rainbow trainers on
train_default_1 and train_dqn_default_1), crash replay, the planner's
corridor and conditional forms, the custom DQN, the tabular Q path, the
Gym adapter, the scenario mesh (sharded evaluation, data-parallel and
tensor-parallel training over ranks that share the card) and the arbiter's
gate b and hysteresis carry, and holds every CUDA kernel of those paths
against its plain PyTorch version (on st_default, the arbiter's rollout
test states and st_fast).  Depth is
cut where noted (512 grids in phases 3, 4 and 9; no whole learning round
in phase 16; phase 26's (b), (c), (d) and (f)).  Phases, in order; any failure
exits non-zero:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels from ``rl_mpc_lanemerging_torch/csrc``, one
   ``nvcc`` per source, started together: K1 and its full-scan yardstick;
3. kernel vs plain version on 512 realistic grids (4 snapshots, 10 ticks
   apart, of 128 worlds driven through the merge region by the port's own
   world and controller), in one launch at B=512: >= 99.9% of s sequences
   identical within 1e-4 m, every first-step difference <= 0.101 m;
4. kernel vs the dense twin (``ops/st_dp.py``) on the same grids, at the
   JAX package's bars: >= 97% first-step agreement, largest first-step
   difference <= 0.101 m, >= 85% full-path match; every disagreement is
   printed, sorted as equal-cost tie, f32 flip or band edge;
5. controller on the card vs the same controller on the CPU (plain kernel
   version) on 8 of those states: finite speeds within 1e-3 m/s;
6. main path: one round of ``tasks.evaluate_st`` (the history recorded,
   crashes dumped) with the production controller at B=128; the kernel's
   launch count must equal the control ticks run;
7. per-stage split of one control tick (the history write included), and
   kernel timing on the first snapshot's 128 grids: the kernel alone
   (``ms``: CUDA events around runs of 20 launches on prepared inputs,
   median of 25 runs) and the wrapper end to end (``wrapper_ms``), each
   beside the full-scan kernel the port began with (``earlier_ms``,
   ``earlier_wrapper_ms``), in the order earlier, new, new, earlier; the
   pairs the kernel's own counter saw against the in-band pairs of the
   plain version; the plain version's time and the bound;
8. the trained actor on the card vs on the CPU on 128 sensed states: the
   observation's presence flags identical, jerk within 1e-5;
9. kernel vs plain version on 512 rollout test states (the state the
   arbiter's virtual rollout reaches after ST_TEST_ROLLOUTS steps, 4
   snapshots of a 128-scenario combined run): >= 99.9% identical paths;
   the share of them the safety certificate condemns;
10. the arbiter with every gate of combined_default_1b on, on the card
    (kernel) vs on the CPU (dense twin), on 128 of the 512 states sensed in
    phase 9 (every state where the card's arbiter takes over, up to 64, and
    others to fill): takeover flags agree on >= 97%, every disagreement and
    the gate behind it printed;
11. main path: ``agents.ddpg.evaluate_combined``, combined_default_1, one
    round at B=128: crash 0 and merge 1 required, exactly 2 kernel launches
    per control tick, the dense DP never called;
12. one round of combined_default_1b (TEST_ST_STRICTLY_BETTER) at 32
    scenarios, so that gate d runs on the card;
13. per-stage split of one combined control tick (median of 5 runs per
    stage);
14. the batched merge env on the card vs on the CPU: one ``env_step`` from
    each of 1024 env states (8 snapshots of 128 scenarios under the noisy
    ddpg_default1_extended actor, in warmup, spawning, driving and
    finishing): flags identical, observations and rewards within 1e-4;
15. 20 DDPG updates on the card vs on the CPU from the same trained actor
    and critic, Adam state and replay batches: relative parameter gap
    <= 1e-4;
16. two DDPG train rounds at full width (B=128, batch 100, replay 2^19,
    REPLAY_START 2000): 120 ticks with no update fill the replay, then 20
    ticks that all learn, 64 updates each (a whole learning round of 200
    ticks takes ~2 min, as an update takes ~10 ms of host time); updates =
    64 x the learning ticks, replay size = valid frames, finite parameters;
    s per round, ms per env tick and per update, and a profile of one tick
    with its 64 updates: device operations, idle share, and the host time
    of each stage of an update;
17. 20 Rainbow grad steps on the card vs on the CPU with the same noise:
    loss, cross-entropy and parameters within 1e-4;
18. two Rainbow train rounds at full width (B=128, 200 ticks, 1365 learner
    steps, batch 64, replay 65,536): the same counters and times, and the
    share of priorities PER has updated;
19. the training tasks: ``agents.ddpg.train`` on train_default_1 (under a
    LOG_DIR of its own, so that its runs never shadow a converted network)
    at one 140-tick round per stage, its resume from the extended stage,
    and EVALUATE_DQN with rainbow_default1_extended over 128 episodes.  K1
    runs on none of the training paths (its count is 0 after phases 16, 18
    and 19);
20. crash capture: one round at B=128 on st_default traffic under a
    controller that floors it at 30 m/s (40 s episodes after 30 s of
    warmup), with the history and then without it, from the same seed: at
    least one crash, identical ``EpisodeStats``, one dump per crash of
    ``ticks`` states that ``load_crash`` reads back equal to the history,
    K1 launched 0 times;
21. ``replay_crash`` of the shortest dump on the card and on the CPU
    (float64, dense DP): identical doomed flags, K1's count unchanged; and
    the rollouts and re-solved plans of ``plot_rollouts`` (the work, not
    the drawing: the card's machine has no matplotlib) for
    ddpg_default1_extended;
22. the planner's remaining forms on phase 3's 128 sensed states:
    ``batched_conditional_st`` with the trained actor's proposed speeds
    (raised by U(0, 2) m/s on half the states, so that both verdicts
    occur), on the card (K1) vs on the CPU (dense twin): takeover flags
    agree on >= 97%, every disagreement printed, exactly 2 K1 launches;
    ``st_control_speed(use_corridor=True)``, ``plan_st`` and
    ``test_guaranteed_crash`` on 8 states, card vs CPU: speeds within 1e-3
    m/s, the same plans and verdicts; ``path_cost_report`` on a float64
    lattice, card vs CPU: costs within 1e-9 relative, counts identical; no
    K1 launch but the conditional form's;
23. the custom DQN: the converted dqn_custom_default1 on 128 states, card
    vs CPU: identical greedy actions; ``agents.dqn.train`` at B=128 (rounds
    of 200 ticks with ``grad_steps_per_round(8, 128, 200)`` grad steps,
    batch and replay of train_default_1) until one episode ends, with a
    target refresh and a 128-episode selection evaluation after each round
    that ends one (LOG_DIR ``chip_smoke_dqn``): replay size = valid frames,
    the grad-step count, s per round, ms per grad step; 20 grad steps card
    vs CPU: relative parameter gap <= 1e-4; a 128-episode greedy evaluation
    of the converted net against run_data.csv line 218: crash <= 0.05 and
    merge >= 0.90;
24. tabular Q: one random-action collect round at B=256 (602 ticks) and
    its fold on the card and on the CPU from the same records (and the
    first episode alone through ``q_update_episode``): Q within 1e-6,
    visits identical, the fold's seconds; 128 greedy episodes of
    ``runs/tabular_q_default/q.npy`` (no visit table) against lines 171 and
    175;
25. the three Gym envs, 50 steps each on the card and on the CPU from the
    same seed: identical flags, observations within 1e-4; the IDs'
    registration (False without gymnasium or gym); K1 launched 0 times in
    phases 23-25;
26. the scenario mesh on one card (``parallel/``), each part timed:
    (a) one round of ``tasks.evaluate_st`` on st_default at B=128 as 2
    ``gloo`` ranks x 64 scenarios sharing the card, spawned after phase 2
    built K1: every per-episode column equal to phase 6's one-process round
    (the wall-time columns aside), K1's launches summed over the ranks =
    the control ticks they ran, each rank's s per tick beside phase 6's;
    (b) the CLI (``python -m rl_mpc_lanemerging_torch.main``) with
    ``RANK=0 WORLD_SIZE=1`` on st_default at its own widths: the NCCL
    process group comes up, one CSV row whose crash and merge rates equal
    those of phase 6's first 8 episodes, the same scenarios (8 of 128
    scenarios, a depth cut);
    (c) data-parallel DDPG on train_default_1 at 32 scenarios per rank (a
    depth cut of its 128): fill rounds with no update until the ranks start
    learning together, then 3 learning ticks of 64 updates: both ranks'
    actor and critic bit-identical, their env observations different, the
    two ``all_reduce``s of an update timed, and 5 updates on 2 fixed
    batches (one per rank) against one process that averages the same two
    gradients by hand: relative gap <= 1e-6; (d) the custom DQN the same
    (one 110-tick round of 16 grad steps, then 5 steps on fixed batches);
    (e) the critic of ddpg_default1_extended split by ``mlp_tp_rules`` over
    a 2-rank model axis against the whole critic on phase 3's 128 sensed
    states at the trained actor's actions: relative gap <= 1e-5 of the
    largest |Q|, the placements the rules predict; (f) one round of
    combined_default_2 at B=32 (a depth cut of 128) through
    ddpg_default2_extended: at most 1 crash and at least 31 merges, 2 K1
    launches per tick, |jerk| and time to merge beside run_data.csv lines
    92 and 241.  A rank that fails fails the phase;
27. gate b (LIMIT_DQN_SPEED) and the hysteresis carry
    (REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED) on the card:
    combined_default_1b (combined_default_1 with gate d, inside which the
    carry acts) with both on.  128 worlds driven by that arbiter on the
    card for 24 ticks after the ego joins; DESIRED_SPEED then comes down
    from 30 m/s (the RL's speed limit, where gate b cannot fire) to the
    median of the RL's selected speeds on those states; then 3 ticks of
    ``arbitrate`` on the card (kernel) and on the CPU (dense twin), each
    side carrying its own previous choice: takeover flags agree on >= 97%,
    every disagreement printed with its gates, gate b fired and a takeover
    carried at least once; then one round at 32 scenarios: crash 0, exactly
    2 kernel launches per control tick;
28. kernel vs plain version on 512 grids of st_fast (OTHER_CAR_SPEED 15,
    the steepest obstacle bands), taken as in phase 3: >= 99.9% identical
    paths, every first-step difference <= 0.101 m.

Every phase prints its seconds, and the script its total.
Prints the ``kernels`` JSON line before the last line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import csv
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CONFIG = "configs/st_default.json"
TRAIN_CONFIG = "configs/train_default_1.json"
DQN_CONFIG = "configs/train_dqn_default_1.json"
TRAINED_DDPG = "runs/ddpg_default1_extended"
TRAINED_RAINBOW = "runs/rainbow_default1_extended"
ENV_SNAPSHOTS = 8        # env states of phase 14, ENV_SNAPSHOT_EVERY apart
ENV_SNAPSHOT_EVERY = 25
ENV_FIRST_SNAPSHOT = 120
UPDATE_PARITY_STEPS = 20
UPDATES_PER_TICK = 64
TRAIN_ROUNDS = 2
DDPG_FILL_TICKS = 120    # phase 16's first round: no updates; the replay
                         # reaches REPLAY_START at ~116 ticks
DDPG_SECOND_ROUND_TICKS = 20  # phase 16's second round: every tick learns
TASK_FRAMES = 1.0        # one round per stage
TASK_TICKS = 140         # ticks per round in phase 19: the 100-tick warmup,
                         # REPLAY_START at ~116, then updates
TASK_EPISODES = 128
TASK_LOG_DIR = "chip_smoke_ddpg"  # phase 19's runs; no converted network's
                                 # name, so that they shadow none
RAM_SPEED = 30.0         # phase 20's controller floors it, as the JAX
                         # forensics tests' ram controller does
CAPTURE_EPISODE = 40.0   # phase 20: 40 s episodes after 30 s of warmup
CAPTURE_WAIT = 30.0
CAPTURE_DIR = "runs_torch/chip_smoke/capture"
CORRIDOR_STATES = 8      # phase 22's st_control_speed(use_corridor=True)
TRAINED_DQN = "runs/dqn_custom_default1"
DQN_TICKS = 200          # phase 23's train rounds
DQN_LOG_DIR = "chip_smoke_dqn"  # no converted network's name
TABULAR_Q = "runs/tabular_q_default/q.npy"
TABULAR_BATCH = 256      # phase 24: one collect round, as the trainer's
GYM_STEPS = 50           # phase 25: steps of each Gym env on each device
GYM_WAIT = 5.0
COMBINED_CONFIG = "configs/combined_default_1.json"
COMBINED_B_CONFIG = "configs/combined_default_1b.json"
COMBINED_B_BATCH = 32
BATCH = 128
ROLLOUT_SNAPSHOTS = 4    # of the combined run, ROLLOUT_SNAPSHOT_EVERY apart
ROLLOUT_SNAPSHOT_EVERY = 12
# The main path's episode budget (seconds of simulated time), the CLI's
# default.  This script's first run on an H100 80GB HBM3 (700 W) measured
# 0.29 s per control tick with warmup included: a round of 100 s episodes
# (every st_default episode merges first) took 178 ticks, 52 s.
MAX_EPISODE_LENGTH = 100.0
TIMING_RUNS = 25
LAUNCHES_PER_RUN = 20
SNAPSHOTS = 4            # of the 128 worlds, SNAPSHOT_EVERY ticks apart
SNAPSHOT_EVERY = 10
FIRST_SNAPSHOT = 60      # ticks after the ego joins
# phase 26: the scenario mesh, 2 gloo ranks sharing the one card
MESH_RANKS = 2
MESH_TRAIN_BATCH = 32    # (c), (d): scenarios per rank, a depth cut of
                         # train_default_1's 128 (64 over both ranks)
MESH_FILL_TICKS = 400    # (c): at most, in rounds of 10 with no update
                         # until the ranks start learning together: 100
                         # ticks of warmup, then <= 32 valid frames per tick
                         # (on the CPU: after ~280 ticks, since the episodes
                         # all time out at once and warm up again)
MESH_LEARN_TICKS = 3     # (c): learning ticks, UPDATES_PER_TICK each
MESH_DQN_TICKS = 110     # (d): one round; the replay passes BATCH_SIZE
MESH_DQN_GRAD_STEPS = 16
MESH_DP_UPDATES = 5      # (c), (d): steps on fixed batches vs by hand
COMBINED_2_CONFIG = "configs/combined_default_2.json"   # (f)
COMBINED_2_BATCH = 32    # (f): a depth cut of 128; phase 11 runs the
                         # combined path at B=128
# phase 27: gate b and the hysteresis carry.  The carry acts only inside
# gate d, so the config is combined_default_1b (combined_default_1 with gate
# d).  At its DESIRED_SPEED of 30 m/s gate b cannot fire (the RL's speed is
# clamped to MAX_SPEED, also 30 m/s), so the compared ticks and the round
# take the median of the RL's selected speeds on the first compared tick
GATE_B_SETTINGS = dict(LIMIT_DQN_SPEED=True,
                       REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED=True)
CARRY_FIRST_TICK = 24    # ticks after the ego joins
CARRY_TICKS = 3
GATE_B_BATCH = 32
ST_FAST_CONFIG = "configs/st_fast.json"   # phase 28: OTHER_CAR_SPEED 15
# (b): st_default at its own widths; the one depth cut is the scenario
# count, 8 episodes in one round (scenarios 0-7 of phase 6's 128)
NCCL_SETTINGS = dict(BATCH_SCENARIOS=8, NUM_EPISODES=8,
                     LOG_DIR="chip_smoke_nccl")
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


def tick_profile(tick, ticks: int = 3, ranges=()) -> dict:
    """torch.profiler over a few control ticks: wall time, device time
    summed over kernels, the device's idle share, and kernel launches per
    tick; with ``ranges``, the host time per tick inside each of those
    ``record_function`` ranges and the six operators that take the most
    host time."""
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
    # a record_function range also leaves a span on the device's timeline
    # around its kernels: not a kernel, and not counted
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in ranges]
    device_us = sum(e.device_time_total for e in kernels)
    out = {
        "tick_wall_ms": wall_us / ticks / 1e3,
        "tick_device_ms": device_us / ticks / 1e3 if kernels else
        "not measured",
        "device_idle_share": 1.0 - device_us / wall_us if kernels else
        "not measured",
        "device_ops_per_tick": len(kernels) / ticks,
    }
    if ranges:
        # a range has a host entry and a device entry (no host time)
        events = prof.key_averages()
        host_us = {}
        for e in events:
            if e.key in ranges:
                host_us[e.key] = host_us.get(e.key, 0.0) + e.cpu_time_total
        out["range_host_ms_per_tick"] = {
            r: host_us[r] / ticks / 1e3 if r in host_us else "not measured"
            for r in ranges}
        top = sorted((e for e in events if e.key not in ranges),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
        out["top_host_ops_per_tick"] = [
            {"name": e.key, "calls": e.count / ticks,
             "self_host_ms": e.self_cpu_time_total / ticks / 1e3}
            for e in top]
    return out


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


class CallCount:
    """A function that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def to_cpu(state):
    return type(state)(*(x.cpu() for x in state))


def round_report(agg, cfg) -> dict:
    """The quality figures of one evaluated round."""
    cols = agg.columns
    return {
        "episodes": len(cols["crashed"]),
        "crash": float(np.mean(cols["crashed"])),
        "merge": float(np.mean(cols["merged"])),
        "mean_abs_jerk": float(np.mean(cols["mean_abs_jerk"])),
        "time_to_merge_s": float(np.mean(cols["time_to_merge"])),
        "mean_ticks": float(np.mean(cols["time_taken"])) / cfg.TICK_LENGTH,
        **({"percent_st_solver": float(np.mean(
            agg.custom["percent st solver"]))}
           if "percent st solver" in agg.custom else {}),
    }


def combined_round(config: str, batch: int, dev, st_kernel, st_dp,
                   **settings) -> dict:
    """One round of the combined task through ``evaluate_combined`` with the
    kernel's launch count set to 0 just before and read just after
    (``settings`` replace the config's).  Control ticks are counted at the
    actor: the arbiter queries it once from the sensed state and once for
    each further rollout step."""
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings
    cfg = Settings.load_from_file(config).replace(
        NUM_EPISODES=batch, BATCH_SCENARIOS=batch, **settings)
    actor = load_actor(cfg.MODEL_NAME, dev, cfg.MINIMUM_NEGATIVE_JERK,
                       cfg.MAXIMUM_POSITIVE_JERK, committed=True)
    queries = CallCount(lambda *a: None)
    actor.register_forward_hook(queries)
    dense = [CallCount(st_dp.solve_st_fast),
             CallCount(st_dp.solve_st_no_jerk_fast)]
    st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast = dense
    try:
        st_kernel.launches = 0
        t0 = time.perf_counter()
        agg = ddpg.evaluate_combined(cfg, actor=actor, device=dev,
                                     verbose=False)
        seconds = time.perf_counter() - t0
        launches = st_kernel.launches
    finally:
        st_dp.solve_st_fast, st_dp.solve_st_no_jerk_fast = (
            d.fn for d in dense)
    per_tick = max(cfg.ROLLOUT_LENGTH, 1)
    assert queries.calls % per_tick == 0, (queries.calls, per_tick)
    ticks = queries.calls // per_tick
    rep = round_report(agg, cfg)
    rep.update(control_ticks=ticks, seconds=seconds,
               seconds_per_tick=seconds / max(ticks, 1), launches=launches,
               dense_dp_calls=sum(d.calls for d in dense))
    print("   " + json.dumps(rep), flush=True)
    assert rep["episodes"] == batch and np.isfinite(rep["mean_abs_jerk"])
    assert ticks > 0 and launches == 2 * ticks, (launches, ticks)
    assert rep["dense_dp_calls"] == 0, "the dense DP ran on the card path"
    return rep


def combined_phases(dev, states, worlds0, kw) -> dict:
    """Phases 8-13: the combined RL+MPC arbiter.  ``states`` are 128 sensed
    states of the merge region and ``worlds0`` the worlds they were sensed
    from; ``kw`` the solver's keyword arguments."""
    from rl_mpc_lanemerging_torch.agents import combined, ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.ops import qp, st_dp, st_kernel
    from rl_mpc_lanemerging_torch.planner import mpc
    from rl_mpc_lanemerging_torch.planner.grid import build_st_grid
    from rl_mpc_lanemerging_torch.rl.obs import state_vector
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, add_ego,
                                              init_world, sense, warmup,
                                              world_step)

    cfg = Settings.load_from_file(COMBINED_CONFIG)
    actor = load_actor(cfg.MODEL_NAME, dev, cfg.MINIMUM_NEGATIVE_JERK,
                       cfg.MAXIMUM_POSITIVE_JERK, committed=True)
    actor_cpu = load_actor(cfg.MODEL_NAME, "cpu", cfg.MINIMUM_NEGATIVE_JERK,
                           cfg.MAXIMUM_POSITIVE_JERK, committed=True)
    policy = ddpg.actor_jerk(actor, cfg)
    policy_cpu = ddpg.actor_jerk(actor_cpu, cfg)
    control, init_carry, _ = combined.combined_controller(policy, cfg)
    assert init_carry is None
    states_cpu = to_cpu(states)
    out = {}

    t0 = phase("8 actor on the card vs on the CPU")
    obs, obs_cpu = state_vector(states, cfg).cpu(), state_vector(states_cpu,
                                                                 cfg)
    flags = slice(3, 16, 4)
    assert obs.shape == (BATCH, 20) and torch.equal(obs[:, flags],
                                                    obs_cpu[:, flags])
    jerk, jerk_cpu = policy(states).cpu(), policy_cpu(states_cpu)
    out["actor_obs_gap"] = float((obs - obs_cpu).abs().max())
    out["actor_jerk_gap"] = float((jerk - jerk_cpu).abs().max())
    print(f"   {BATCH} sensed states: presence flags identical "
          f"({int(obs[:, flags].sum())} cars seen), max |obs card - cpu| "
          f"{out['actor_obs_gap']:.3g}, jerk in [{float(jerk.min()):.3f}, "
          f"{float(jerk.max()):.3f}], max |jerk card - cpu| "
          f"{out['actor_jerk_gap']:.3g} (bar <= 1e-5)", flush=True)
    assert torch.isfinite(jerk).all() and out["actor_jerk_gap"] <= 1e-5
    done(t0)

    t0 = phase("9 kernel vs plain version, rollout test states")
    rng = CounterRandom(1)
    worlds = init_world(cfg, BATCH, torch.float32, dev)
    worlds = warmup(worlds, cfg, int(50.0 / cfg.TICK_LENGTH), rng)
    worlds = add_ego(worlds, torch.full((BATCH,), 15.0, device=dev))
    grids, condemned, frozen, snapshots = [], [], [], []
    for tick in range(1, ROLLOUT_SNAPSHOTS * ROLLOUT_SNAPSHOT_EVERY + 1):
        sensed = sense(worlds, cfg)
        if tick % ROLLOUT_SNAPSHOT_EVERY == 0:
            snapshots.append(sensed)
            _, rollout_len, _, _, test_state = combined._rl_rollout(
                policy, sensed, policy(sensed), cfg)
            g = build_st_grid(test_state, cfg, torch.float32)
            grids.append((g.obstacles, g.s_values, g.ego_speed,
                          test_state.ego_accel.to(torch.float32),
                          g.distances))
            condemned.append(mpc.batched_test_guaranteed_crash(
                test_state, cfg, use_kernel=True))
            frozen.append(rollout_len <= cfg.ST_TEST_ROLLOUTS)
        worlds = world_step(worlds, control(sensed)[0], cfg, rng)
    seq_k = torch.cat([st_kernel.st_wavefront(*g, **kw) for g in grids])
    seq_r = torch.cat([st_kernel.st_wavefront_reference(*g, **kw)
                       for g in grids])
    torch.cuda.synchronize()
    k_np, r_np = seq_k.cpu().numpy(), seq_r.cpu().numpy()
    same = np.all(np.abs(k_np - r_np) <= 1e-4, axis=1)
    start_blocked = torch.cat([g[0][:, 0, 0] for g in grids])
    out.update(
        rollout_grids=len(k_np), rollout_identical=float(same.mean()),
        rollout_max_abs_err=float(np.abs(k_np - r_np).max()),
        rollout_condemned_share=float(torch.cat(condemned).float().mean()),
        rollout_frozen_share=float(torch.cat(frozen).float().mean()))
    print(f"   {len(k_np)} grids from rollout test states "
          f"({ROLLOUT_SNAPSHOTS} snapshots, {ROLLOUT_SNAPSHOT_EVERY} ticks "
          f"apart, of {BATCH} worlds under the arbiter): identical paths "
          f"{int(same.sum())} of {len(k_np)} = {same.mean():.4f} (bar >= "
          f"0.999), max abs err {out['rollout_max_abs_err']:.3g}; complete "
          f"paths {int((k_np[:, -1] != 0).sum())}, certificate condemns "
          f"{out['rollout_condemned_share']:.4f}, taken from a frozen "
          f"rollout {out['rollout_frozen_share']:.4f}, start cell inside an "
          f"obstacle {int(start_blocked.sum())}", flush=True)
    assert np.isfinite(k_np).all() \
        and len(k_np) == ROLLOUT_SNAPSHOTS * BATCH
    if same.mean() < 0.999:
        os.makedirs("runs_torch/chip_smoke", exist_ok=True)
        bad = np.flatnonzero(~same)
        stacked = [torch.cat([g[i] for g in grids])[bad].cpu().numpy()
                   for i in range(5)]
        np.savez_compressed(
            "runs_torch/chip_smoke/rollout_grids_k1_differs.npz",
            obstacles=stacked[0],
            s_values=stacked[1], v0=stacked[2], a0=stacked[3],
            distances=stacked[4], kernel=k_np[bad], plain=r_np[bad])
        raise AssertionError(
            f"K1 differs from its plain version on {len(bad)} rollout "
            f"grids; saved to runs_torch/chip_smoke/"
            f"rollout_grids_k1_differs.npz")
    done(t0)

    t0 = phase("10 arbiter on the card (kernel) vs on the CPU (dense twin)")
    cfg_b = Settings.load_from_file(COMBINED_B_CONFIG)
    assert cfg_b.MODEL_NAME == cfg.MODEL_NAME and cfg_b.TEST_ST_STRICTLY_BETTER
    pool = type(states)(*(torch.cat(x) for x in zip(*snapshots)))
    took = torch.cat([combined.arbitrate(policy, snap, cfg_b).take
                      for snap in snapshots])
    picked = torch.cat([torch.nonzero(took)[:BATCH // 2, 0],
                        torch.nonzero(~took)[:, 0]])[:BATCH]
    chosen = type(states)(*(x[picked] for x in pool))
    chosen_cpu = to_cpu(chosen)
    card = combined.arbitrate(policy, chosen, cfg_b)
    parts = [combined.arbitrate(
        policy_cpu, type(states)(*(x[i:i + 32] for x in chosen_cpu)), cfg_b)
        for i in range(0, BATCH, 32)]
    cpu = type(card)(*(torch.cat(x) for x in zip(*parts)))
    card = type(card)(*(x.cpu() for x in card))
    gates = ("take", "crash_pred", "over_speed", "condemned", "st_better")
    agree = {g: float((getattr(card, g) == getattr(cpu, g)).float().mean())
             for g in gates}
    both = card.take == cpu.take
    speed_gap = float((card.speed - cpu.speed)[both].abs().max())
    for i in torch.nonzero(~both)[:, 0].tolist():
        print(f"   state {i}: " + json.dumps({
            g: [bool(getattr(card, g)[i]), bool(getattr(cpu, g)[i])]
            for g in gates}) + f" (card, cpu); st speed "
            f"{float(card.st_speed[i]):.4f} vs {float(cpu.st_speed[i]):.4f}, "
            f"rl speed {float(card.rl_speed[i]):.4f} vs "
            f"{float(cpu.rl_speed[i]):.4f}", flush=True)
    out.update(arbiter_flag_agreement=agree["take"],
               arbiter_speed_gap=speed_gap)
    print(f"   {len(picked)} of {len(took)} states ({int(took.sum())} "
          f"takeovers among them all): agreement " + json.dumps(agree)
          + f" (bar: take >= 0.97); takeovers on the card "
          f"{int(card.take.sum())}, by gate a/b/c/d "
          f"{int(card.crash_pred.sum())}/{int(card.over_speed.sum())}/"
          f"{int(card.condemned.sum())}/{int(card.st_better.sum())}; max "
          f"|speed card - cpu| where the flags agree {speed_gap:.3g} m/s, "
          f"st speeds {float((card.st_speed - cpu.st_speed).abs().max()):.3g}"
          f", rl speeds "
          f"{float((card.rl_speed - cpu.rl_speed).abs().max()):.3g}",
          flush=True)
    assert torch.isfinite(card.speed).all() and agree["take"] >= 0.97
    done(t0)

    t0 = phase(f"11 main path: evaluate_combined, combined_default_1, "
               f"B={BATCH}")
    out["main"] = combined_round(COMBINED_CONFIG, BATCH, dev, st_kernel,
                                 st_dp)
    assert out["main"]["crash"] == 0.0 and out["main"]["merge"] == 1.0
    done(t0)

    t0 = phase(f"12 evaluate_combined, combined_default_1b (gate d), "
               f"B={COMBINED_B_BATCH}")
    out["round_b"] = combined_round(COMBINED_B_CONFIG, COMBINED_B_BATCH, dev,
                                    st_kernel, st_dp)
    done(t0)

    t0 = phase("13 combined tick split")
    s_hist, _, _, _, test_state = combined._rl_rollout(
        policy, states, policy(states), cfg)
    _, seq, valid, fine, fine_len, _ = mpc.batched_st_control(
        states, cfg, use_kernel=True)
    fine_len = torch.clamp_max(fine_len, s_hist.shape[1])
    op = qp.build_operator(cfg.fine_horizon, cfg.TICK_LENGTH)
    split = {
        "actor_call_ms": wall_ms(lambda: policy(states)),
        "rollout_ms": wall_ms(lambda: combined._rl_rollout(
            policy, states, policy(states), cfg)),
        "plan_sensed_ms": wall_ms(lambda: mpc.batched_plan(
            states, cfg, use_kernel=True)),
        "qp_ms": wall_ms(lambda: qp.finer_fit_qp(
            seq, valid, states.ego_speed, states.ego_accel, op,
            cfg.T_DISCRETIZATION, cfg.MAX_SPEED,
            cfg.MAX_POSITIVE_ACCELERATION, cfg.MAX_NEGATIVE_ACCELERATION,
            cfg.MAXIMUM_POSITIVE_JERK, cfg.MINIMUM_NEGATIVE_JERK,
            iterations=cfg.QP_ITERATIONS)),
        "plan_test_state_and_certificate_ms": wall_ms(
            lambda: mpc.batched_test_guaranteed_crash(test_state, cfg,
                                                      use_kernel=True)),
        "gate_d_mean_jerks_ms": wall_ms(lambda: (
            combined.path_mean_abs_jerk(fine, fine_len, states.ego_speed,
                                        states.ego_accel, cfg.TICK_LENGTH),
            combined.path_mean_abs_jerk(s_hist, fine_len, states.ego_speed,
                                        states.ego_accel, cfg.TICK_LENGTH))),
        "controller_ms": wall_ms(lambda: control(states)),
        "controller_gate_d_on_ms": wall_ms(lambda: combined.arbitrate(
            policy, states, cfg_b)),
    }
    # each stage is synchronised on its own, so the stages sum above the
    # controller, which is not; rollout_ms holds 4 of the 5 actor calls
    print("   combined tick split (host ms, synchronised): "
          + json.dumps({k: round(v, 3) for k, v in split.items()}),
          flush=True)
    profile = tick_profile(lambda: world_step(
        worlds0, control(sense(worlds0, cfg))[0], cfg, rng))
    print("   combined tick profile: " + json.dumps(profile), flush=True)
    out["split"], out["profile"] = split, profile
    done(t0)
    return out


def _to(tree, dev):
    """A NamedTuple of tensors (nested one level) on ``dev``."""
    return type(tree)(*(_to(x, dev) if isinstance(x, tuple)
                        else x.to(dev) for x in tree))


def _counting(module, name: str):
    """Wrap ``module.name`` in a CallCount; returns it (restore with
    ``setattr(module, name, counter.fn)``)."""
    counter = CallCount(getattr(module, name))
    setattr(module, name, counter)
    return counter


def _param_gap(card, cpu) -> float:
    """Largest |card - cpu| of a tensor over its largest |cpu|."""
    return max(float((a.detach().cpu() - b.detach()).abs().max())
               / max(float(b.detach().abs().max()), 1e-30)
               for a, b in zip(card, cpu))


def _range_cost_us(n: int = 2000) -> float:
    """Host time of one empty ``record_function`` range with the profiler
    off, in us (the cost of the update's stage ranges)."""
    from torch.profiler import record_function
    t0 = time.perf_counter()
    for _ in range(n):
        with record_function("ddpg.cost"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def _train_round_report(name, state, rounds, dev):
    """Run the train rounds ``rounds`` (callables), timing each; returns
    the figures."""
    seconds = []
    for run_round in rounds:
        t0 = time.perf_counter()
        run_round()
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
    rep = {"s_per_round": seconds, "frames": int(state.frames),
           "episodes": int(state.episodes),
           "replay_size": int(state.replay.size)}
    print(f"   {name}: " + json.dumps(rep), flush=True)
    return rep


def training_phases(dev, batch: int = BATCH) -> dict:
    """Phases 14-19: the training path (no K1 on it)."""
    from rl_mpc_lanemerging_torch import convert, tasks
    from rl_mpc_lanemerging_torch._device import pin_fp32_matmul
    from rl_mpc_lanemerging_torch.agents import budget, ddpg, rainbow
    from rl_mpc_lanemerging_torch.checkpoint import load_params
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.envs import merge_env
    from rl_mpc_lanemerging_torch.models.rainbow import sample_noise
    from rl_mpc_lanemerging_torch.ops import st_kernel
    from rl_mpc_lanemerging_torch.rl import replay as rb
    from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world

    pin_fp32_matmul()
    cpu = torch.device("cpu")
    cfg = Settings.load_from_file(TRAIN_CONFIG)
    trained = load_params(TRAINED_DDPG, committed=True)
    out = {}

    t0 = phase("14 env on the card vs on the CPU")
    actor = ddpg._actor_from(cfg, convert.ddpg_actor_from_numpy(
        trained["actor"]), dev)
    g = torch.Generator(device=dev).manual_seed(14)
    world_rng = CounterRandom(14)
    env = merge_env.env_reset(init_world(cfg, batch, torch.float32, dev), cfg)
    # every scenario at its own phase: warmups of 1-100 ticks
    env = env._replace(warmup_left=(torch.arange(batch, device=dev) * 37
                                    % 100 + 1).to(torch.int32))
    replay = rb.init_replay(ddpg.DDPG_REPLAY_CAPACITY, cfg.obs_dim, False,
                            device=dev)
    snaps = []
    for tick in range(1, ENV_FIRST_SNAPSHOT + ENV_SNAPSHOT_EVERY
                      * (ENV_SNAPSHOTS - 1) + 1):
        with torch.no_grad():
            action = torch.clamp(
                actor(env.obs)[:, 0] + ddpg.NOISE_SIGMA * torch.randn(
                    batch, generator=g, device=dev),
                cfg.MINIMUM_NEGATIVE_JERK, cfg.MAXIMUM_POSITIVE_JERK)
        if tick >= ENV_FIRST_SNAPSHOT \
                and (tick - ENV_FIRST_SNAPSHOT) % ENV_SNAPSHOT_EVERY == 0:
            snaps.append((env, action))
        env, tr = merge_env.env_step(env, action, cfg, world_rng)
        replay = rb.add_batch(replay, tr["obs"], tr["next_obs"], action,
                              tr["reward"], tr["terminal"], tr["valid"], 1.0)
    flags = ("done", "terminal", "valid", "spawn_now")
    disagree, counts = [], {f: 0 for f in flags}
    obs_gap = reward_gap = 0.0
    for k, (env_k, action) in enumerate(snaps):
        _, tr_card = merge_env.env_step(env_k, action, cfg, world_rng)
        _, tr_cpu = merge_env.env_step(_to(env_k, cpu), action.cpu(), cfg,
                                       world_rng)
        for f in flags:
            counts[f] += int(tr_card[f].sum())
            for i in torch.nonzero(tr_card[f].cpu() != tr_cpu[f])[:, 0]:
                disagree.append((f, k, int(i)))
        obs_gap = max(obs_gap, float((tr_card["next_obs"].cpu()
                                      - tr_cpu["next_obs"]).abs().max()))
        reward_gap = max(reward_gap, float((tr_card["reward"].cpu()
                                            - tr_cpu["reward"]).abs().max()))
    for f, k, i in disagree:
        print(f"   flag {f} differs: snapshot {k}, scenario {i}", flush=True)
    in_warmup = sum(int((e.warmup_left > 0).sum()) for e, _ in snaps)
    out["env"] = {"states": len(snaps) * batch, "in_warmup": in_warmup,
                  **{f"{f}_count": counts[f] for f in flags},
                  "flag_disagreements": len(disagree),
                  "max_obs_gap": obs_gap, "max_reward_gap": reward_gap}
    print("   " + json.dumps(out["env"]) + " (bars: flags identical, gaps "
          "<= 1e-4)", flush=True)
    assert not disagree and obs_gap <= 1e-4 and reward_gap <= 1e-4
    assert in_warmup > 0 and counts["spawn_now"] > 0 and counts["done"] > 0
    done(t0)

    t0 = phase("15 DDPG update on the card vs on the CPU")
    sides = {}
    for d in (dev, cpu):
        a = ddpg._actor_from(cfg, convert.ddpg_actor_from_numpy(
            trained["actor"]), d).train().requires_grad_(True)
        c = ddpg.DDPGCritic(cfg.obs_dim)
        c.load_state_dict(convert.ddpg_critic_from_numpy(trained["critic"]))
        c = c.to(d)
        ta, tc = (copy.deepcopy(m).requires_grad_(False) for m in (a, c))
        sides[d.type] = (a, c, ta, tc, ddpg._adam(a, cfg.LEARNING_RATE),
                         ddpg._adam(c, cfg.LEARNING_RATE))
    batches = [rb.sample(replay, ddpg.DDPG_BATCH, generator=g)[1]
               for _ in range(UPDATE_PARITY_STEPS)]
    for b in batches:
        ddpg._update(*sides[dev.type], b)
        ddpg._update(*sides["cpu"], {k: v.cpu() for k, v in b.items()})
    gap = max(_param_gap(m_card.parameters(), m_cpu.parameters())
              for m_card, m_cpu in zip(sides[dev.type][:4], sides["cpu"][:4]))
    out["ddpg_update_rel_gap"] = gap
    print(f"   {UPDATE_PARITY_STEPS} updates from the trained "
          f"ddpg_default1_extended actor and critic, batches of "
          f"{ddpg.DDPG_BATCH} from {int(replay.size)} replayed transitions: "
          f"max relative parameter gap {gap:.3g} (bar <= 1e-4)", flush=True)
    assert gap <= 1e-4
    done(t0)

    t0 = phase(f"16 DDPG train rounds, B={batch}")
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    state = ddpg.make_train_state(cfg, worlds, world_rng, seed=16)
    # the replay size after each tick, and the updates, counted beside the
    # trainer's own bookkeeping
    sizes, real_add = [], rb.add_batch

    def recording_add(*args, **kw):
        replay = real_add(*args, **kw)
        sizes.append(replay.size.clone())
        return replay

    rb.add_batch = recording_add
    updates = _counting(ddpg, "_update")
    st_kernel.launches = 0
    try:
        # a round with no update fills the replay past REPLAY_START; the
        # sizes are counted over the second round alone, where every tick
        # learns
        rep = _train_round_report("DDPG", state, [
            lambda: (ddpg.train_round(state, cfg, env_ticks=DDPG_FILL_TICKS,
                                      updates_per_tick=0), sizes.clear()),
            lambda: ddpg.train_round(state, cfg,
                                     env_ticks=DDPG_SECOND_ROUND_TICKS,
                                     updates_per_tick=UPDATES_PER_TICK)],
            dev)
    finally:
        rb.add_batch, ddpg._update = real_add, updates.fn
    learning_ticks = sum(int(s) >= ddpg.REPLAY_START for s in sizes)
    rep.update(updates=updates.calls, learning_ticks=learning_ticks,
               k1_launches=st_kernel.launches)
    params = list(state.actor.parameters()) + list(state.critic.parameters())
    assert updates.calls == UPDATES_PER_TICK * learning_ticks > 0, rep
    assert learning_ticks == DDPG_SECOND_ROUND_TICKS, rep
    assert rep["replay_size"] == rep["frames"] > 0, rep
    assert all(bool(torch.isfinite(p).all()) for p in params)
    assert st_kernel.launches == 0
    # the stages of a tick, synchronised, on the trained state
    env_tick_ms = wall_ms(lambda: ddpg.train_round(state, cfg, 1,
                                                   updates_per_tick=0))
    update_ms = wall_ms(lambda: [ddpg._update(
        state.actor, state.critic, state.target_actor, state.target_critic,
        state.actor_opt, state.critic_opt,
        rb.sample(state.replay, ddpg.DDPG_BATCH, generator=state.generator)[1])
        for _ in range(UPDATES_PER_TICK)]) / UPDATES_PER_TICK
    prof = tick_profile(lambda: ddpg.train_round(
        state, cfg, 1, UPDATES_PER_TICK), ticks=1, ranges=ddpg.UPDATE_STAGES)
    stage_ms = {r: ms / UPDATES_PER_TICK for r, ms in
                prof["range_host_ms_per_tick"].items()
                if not isinstance(ms, str)}
    rep.update(env_tick_ms=env_tick_ms, update_ms=update_ms, profile=prof,
               update_stage_host_ms=stage_ms)
    out["ddpg_rounds"] = rep
    print(f"   s per round {[round(x, 2) for x in rep['s_per_round']]} "
          f"({DDPG_FILL_TICKS} ticks with no update, then "
          f"{DDPG_SECOND_ROUND_TICKS} learning ticks), "
          f"{learning_ticks} ticks past REPLAY_START with {updates.calls} "
          f"updates (= {UPDATES_PER_TICK} x ticks), replay size = valid "
          f"frames = {rep['frames']}, {rep['episodes']} episodes; env tick "
          f"{env_tick_ms:.3f} ms, update {update_ms:.3f} ms; a tick with "
          f"{UPDATES_PER_TICK} updates: " + json.dumps(prof), flush=True)
    range_us = _range_cost_us()
    rep["profiler_range_host_us"] = range_us
    print("   host ms per update in each stage, under the profiler: "
          + json.dumps(stage_ms) + f"; a range costs {range_us:.2f} us of "
          f"host time with the profiler off ({len(ddpg.UPDATE_STAGES)} per "
          "update)", flush=True)
    done(t0)

    t0 = phase("17 Rainbow grad step on the card vs on the CPU")
    q_dist = convert.rainbow_from_numpy(
        load_params(TRAINED_RAINBOW, committed=True)["q_dist"])
    nets = {}
    for d in (dev, cpu):
        net = rainbow._net(cfg)
        net.load_state_dict(q_dist)
        target = copy.deepcopy(net)
        with torch.no_grad():
            for p in target.parameters():
                p.mul_(0.9)
        net, target = net.to(d), target.to(d).requires_grad_(False)
        nets[d.type] = (net, target, ddpg._adam(net, cfg.LEARNING_RATE))
    losses = {dev.type: [], "cpu": []}
    for step in range(UPDATE_PARITY_STEPS):
        idx, b = rb.sample(replay, rainbow.RAINBOW_BATCH, generator=g)
        b = dict(b, action=torch.randint(0, 5, idx.shape, generator=g,
                                         device=dev),
                 discount=rainbow.RAINBOW_DISCOUNT ** torch.randint(
                     1, 4, idx.shape, generator=g, device=dev).float())
        w = torch.rand(idx.shape, generator=g, device=dev) * 0.8 + 0.2
        noise = sample_noise(nets[dev.type][0], g)
        for d, side in nets.items():
            loss, ce = rainbow._grad_step(
                *side[:2], side[2], {k: v.to(d) for k, v in b.items()},
                [(e_in.to(d), e_out.to(d)) for e_in, e_out in noise],
                w.to(d))
            losses[d].append((loss.cpu(), ce.cpu()))
    loss_gap = max(float((a[0] - b[0]).abs()) for a, b in
                   zip(losses[dev.type], losses["cpu"]))
    ce_gap = max(float((a[1] - b[1]).abs().max()) for a, b in
                 zip(losses[dev.type], losses["cpu"]))
    gap = _param_gap(nets[dev.type][0].parameters(),
                     nets["cpu"][0].parameters())
    out["rainbow_step"] = {"loss_gap": loss_gap, "ce_gap": ce_gap,
                           "param_rel_gap": gap}
    print(f"   {UPDATE_PARITY_STEPS} grad steps from rainbow_default1_extended"
          f", the same noise and weights on both sides: " + json.dumps(
              out["rainbow_step"]) + " (bars <= 1e-4)", flush=True)
    assert loss_gap <= 1e-4 and ce_gap <= 1e-4 and gap <= 1e-4
    done(t0)

    t0 = phase(f"18 Rainbow train rounds, B={batch}")
    dqn_cfg = Settings.load_from_file(DQN_CONFIG)
    worlds, world_rng = tasks.make_worlds(dqn_cfg, device=dev)
    state = rainbow.make_train_state(dqn_cfg, worlds, world_rng, seed=18)
    grad_steps = budget.grad_steps_per_round(
        dqn_cfg.TRAINING_STEPS_PER_EPISODE, batch, rainbow.TICKS_PER_ROUND)
    added, real_add = [], rb.add_batch

    def counting_add(*args, **kw):
        added.append(args[6].sum())           # the valid n-step rows
        return real_add(*args, **kw)

    rb.add_batch = counting_add
    steps = _counting(rainbow, "_grad_step")
    st_kernel.launches = 0
    try:
        rep = _train_round_report("Rainbow", state, [
            lambda: rainbow.train_round(state, dqn_cfg,
                                        env_ticks=rainbow.TICKS_PER_ROUND,
                                        grad_steps=grad_steps, epsilon=0.5)
            ] * TRAIN_ROUNDS, dev)
    finally:
        rb.add_batch, rainbow._grad_step = real_add, steps.fn
    size = int(state.replay.size)
    pri = state.replay.priority[:size]
    updated = float((pri != dqn_cfg.PER_MAX_PRIORITY
                     ** dqn_cfg.PER_ALPHA).float().mean())
    rep.update(grad_steps=steps.calls, grad_steps_per_round=grad_steps,
               nstep_rows_added=int(sum(added)), per_updated_share=updated,
               k1_launches=st_kernel.launches)
    assert steps.calls == grad_steps * TRAIN_ROUNDS, rep
    assert rep["replay_size"] == rep["nstep_rows_added"] > 0, rep
    assert 0.0 < updated <= 1.0 and st_kernel.launches == 0
    assert all(bool(torch.isfinite(p).all()) for p in state.net.parameters())
    step_ms = wall_ms(lambda: rainbow._grad_step(
        state.net, state.target_net, state.opt,
        rb.sample(state.replay, rainbow.RAINBOW_BATCH,
                  generator=state.generator)[1],
        sample_noise(state.net, state.generator)))
    env_tick_ms = wall_ms(lambda: rainbow.train_round(state, dqn_cfg, 1,
                                                      grad_steps=0))
    rep.update(env_tick_ms=env_tick_ms, grad_step_ms=step_ms)
    out["rainbow_rounds"] = rep
    print(f"   s per round {[round(x, 2) for x in rep['s_per_round']]}, "
          f"{steps.calls} learner steps (= {grad_steps} x {TRAIN_ROUNDS}), "
          f"replay size = n-step rows added = {size}, PER has updated "
          f"{updated:.4f} of the priorities; env tick {env_tick_ms:.3f} ms, "
          f"grad step {step_ms:.3f} ms", flush=True)
    done(t0)

    t0 = phase("19 training tasks end to end")
    out["tasks"] = training_tasks(dev, cfg, dqn_cfg)
    done(t0)
    return out


def ddpg_tasks(dev, cfg, small: dict) -> dict:
    """TRAIN_DDPG through ``ddpg.train`` at one round per stage (both
    stages' params.npz written), then RESUME_DDPG from the extended stage's
    checkpoint for one round."""
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.rundir import RUNS_ROOT
    out = {}
    t0 = time.perf_counter()
    state, agg = ddpg.train(cfg.replace(**small), num_frames=TASK_FRAMES,
                            eval_episodes=TASK_EPISODES, device=dev,
                            verbose=True)
    out["train_ddpg_s"] = time.perf_counter() - t0
    out["train_ddpg_updates_stage2"] = state.updates
    out["train_ddpg"] = round_report(agg, cfg)
    paths = [os.path.join(RUNS_ROOT, cfg.LOG_DIR + s, "params.npz")
             for s in ("", "_extended")]
    assert all(os.path.exists(p) for p in paths), paths
    t0 = time.perf_counter()
    resume = cfg.replace(TASK="RESUME_DDPG", LOG_DIR=cfg.LOG_DIR + "_resumed",
                         MODEL_NAME="runs/" + cfg.LOG_DIR + "_extended",
                         **small)
    state, agg = ddpg.train(resume, num_frames=TASK_FRAMES, resume=True,
                            eval_episodes=TASK_EPISODES, device=dev,
                            verbose=True)
    out["resume_ddpg_s"] = time.perf_counter() - t0
    out["resume_ddpg_updates"] = state.updates
    out["resume_ddpg"] = round_report(agg, cfg)
    assert out["train_ddpg_updates_stage2"] > 0 \
        and out["resume_ddpg_updates"] > 0, out
    return out


def training_tasks(dev, cfg, dqn_cfg) -> dict:
    """``ddpg.train`` on train_default_1 at one round per stage, its resume
    from the extended stage for one round, and EVALUATE_DQN with the
    converted rainbow_default1_extended: all on the card, with K1's count
    set to 0 before and read after (the training paths never plan)."""
    from rl_mpc_lanemerging_torch.agents import ddpg, rainbow
    from rl_mpc_lanemerging_torch.ops import st_kernel
    small = dict(NUM_EPISODES=TASK_EPISODES)
    print(f"   reduced for the smoke: frame budget {TASK_FRAMES:.0f} per "
          f"stage (one round), rounds of {TASK_TICKS} ticks (the "
          f"trainer's: {ddpg.TICKS_PER_ROUND}), selection evals of "
          f"{TASK_EPISODES} episodes "
          f"(the trainer's default: 2048), final evaluations of "
          f"{TASK_EPISODES} episodes (NUM_EPISODES "
          f"{cfg.NUM_EPISODES})", flush=True)
    out = {}
    st_kernel.launches = 0
    ticks_per_round, ddpg.TICKS_PER_ROUND = ddpg.TICKS_PER_ROUND, TASK_TICKS
    try:
        out.update(ddpg_tasks(dev, cfg.replace(LOG_DIR=TASK_LOG_DIR),
                              small))
    finally:
        ddpg.TICKS_PER_ROUND = ticks_per_round
    t0 = time.perf_counter()
    ev = dqn_cfg.replace(TASK="EVALUATE_DQN", MODEL_NAME=TRAINED_RAINBOW,
                         LOG_DIR=TASK_LOG_DIR + "_evaluate_dqn", **small)
    agg = rainbow.evaluate(ev, device=dev, verbose=False)
    out["evaluate_dqn_s"] = time.perf_counter() - t0
    rep = round_report(agg, ev)
    rep["sem"] = {k: float(np.std(agg.columns[c]) / np.sqrt(len(
        agg.columns[c]))) for k, c in (("crash", "crashed"),
                                       ("merge", "merged"),
                                       ("mean_abs_jerk", "mean_abs_jerk"),
                                       ("time_to_merge_s", "time_to_merge"))}
    out["evaluate_dqn"] = rep
    out["k1_launches"] = st_kernel.launches
    print("   EVALUATE_DQN rainbow_default1_extended, "
          f"{rep['episodes']} episodes: " + json.dumps(rep) + "; run_data.csv"
          " lines 77 / 217 (TRAIN_DQN rainbow_default1): crash 0.038 / "
          "0.069, merge 0.790 / 0.896, |jerk| 0.0928 / 0.1222, time to "
          "merge 38.57 / 34.49 s", flush=True)
    print("   tasks: " + json.dumps({k: v for k, v in out.items()
                                       if k != "evaluate_dqn"}), flush=True)
    assert st_kernel.launches == 0
    assert np.isfinite(rep["mean_abs_jerk"]) and rep["episodes"] \
        == TASK_EPISODES
    return out


def forensics_phases(dev, states) -> dict:
    """Phases 20-22: crash capture and replay, the rollout plans of
    ``plot_rollouts``, and the planner's remaining forms.  ``states`` are
    128 sensed states of phase 3."""
    import shutil
    from rl_mpc_lanemerging_torch import forensics
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.agents.combined import _speed_from_jerk
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.ops import st_kernel
    from rl_mpc_lanemerging_torch.planner import mpc
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, init_world,
                                              run_episode_batch)

    cfg = Settings.load_from_file(CONFIG)
    out = {}
    # one warning per dump and per doomed state: the phases print counts
    logging.getLogger(forensics.__name__).setLevel(logging.ERROR)

    t0 = phase(f"20 crash capture, st_default traffic, B={BATCH}")

    def ram(sensed):
        return torch.full_like(sensed.ego_speed, RAM_SPEED)

    st_kernel.launches = 0
    rounds = {}
    for record in (True, False):
        t = time.perf_counter()
        res = run_episode_batch(
            init_world(cfg, BATCH, torch.float32, dev), cfg, ram,
            CounterRandom(20), max_episode_length=CAPTURE_EPISODE,
            wait_before_start=CAPTURE_WAIT, record_history=record)
        torch.cuda.synchronize(dev)
        rounds[record] = (res, time.perf_counter() - t)
    (_, stats, history), on_s = rounds[True]
    (_, plain), off_s = rounds[False]
    differ = [f for f, a, b in zip(stats._fields, stats, plain)
              if not torch.equal(a, b)]
    shutil.rmtree(CAPTURE_DIR, ignore_errors=True)
    t = time.perf_counter()
    paths = forensics.dump_crashes(stats, history, run_dir=CAPTURE_DIR,
                                   tag="r0_")
    dump_s = time.perf_counter() - t
    rows = torch.nonzero(stats.crashed)[:, 0].tolist()
    ticks = stats.ticks.tolist()
    hist_np = [h.cpu().numpy() for h in history]
    lengths = []
    for path, b in zip(paths, rows):
        loaded = forensics.load_crash(path)
        lengths.append(len(loaded))
        assert len(loaded) == ticks[b], (path, len(loaded), ticks[b])
        for t, state in enumerate(loaded):
            for leaf, h in zip(state, hist_np):
                assert np.array_equal(leaf, h[b, t]), (path, t)
    history_mb = sum(h.numel() * h.element_size() for h in history) / 2**20
    out["capture"] = {
        "crashes": len(rows), "dumps": len(paths), "states": sum(lengths),
        "shortest": min(lengths, default=0), "s_history_on": on_s,
        "s_history_off": off_s, "dump_s": dump_s, "history_mb": history_mb,
        "control_ticks": int(max(ticks)), "stats_differ": differ,
        "k1_launches": st_kernel.launches}
    print("   " + json.dumps(out["capture"]) + " (bars: >= 1 crash, stats "
          "identical with and without the history, one dump per crash of "
          "ticks states read back equal, 0 K1 launches)", flush=True)
    assert rows and not differ and len(paths) == len(rows)
    assert st_kernel.launches == 0
    done(t0)

    t0 = phase("21 replay of the shortest dump (card and CPU), rollout "
               "plans of ddpg_default1_extended")
    shortest = paths[lengths.index(min(lengths))]
    times, flags = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t = time.perf_counter()
        flags[side], plots = forensics.replay_crash(shortest, cfg, device=d)
        times[side] = time.perf_counter() - t
    ccfg = Settings.load_from_file(COMBINED_CONFIG)
    actor = load_actor(ccfg.MODEL_NAME, dev, ccfg.MINIMUM_NEGATIVE_JERK,
                       ccfg.MAXIMUM_POSITIVE_JERK, committed=True)
    t = time.perf_counter()
    roll, roll_crashed, plans = forensics.rollout_plans(
        ddpg.actor_jerk(actor, ccfg), ccfg, device=dev)
    rollout_s = time.perf_counter() - t
    out["replay"] = {
        "states": len(flags["cpu"]), "doomed": sum(flags["cpu"]),
        "flags_identical": flags["card"] == flags["cpu"],
        "card_s": times["card"], "cpu_s": times["cpu"], "plots": len(plots),
        "rollout_steps": len(roll) - 1,
        "rollout_crash_predicted": int(roll_crashed.sum()),
        "rollout_plan_valid": [p.valid.tolist() for p in plans],
        "rollout_s": rollout_s, "k1_launches": st_kernel.launches}
    print("   " + json.dumps(out["replay"]) + " (bars: doomed flags "
          "identical, 0 K1 launches; no matplotlib here, so no plots)",
          flush=True)
    assert out["replay"]["flags_identical"] and st_kernel.launches == 0
    assert len(plans) == len(roll) == max(ccfg.ROLLOUT_LENGTH, 1) + 1
    assert all(bool(torch.isfinite(p.seq).all()) for p in plans)
    done(t0)

    t0 = phase(f"22 planner forms on {BATCH} sensed states")
    # the trained actor's proposals; on the second half of the states they
    # are raised by U(0, 2) m/s, as the actor's own never take over here
    policy = ddpg.actor_jerk(actor, ccfg)
    raised = torch.as_tensor(np.random.default_rng(22).uniform(0, 2, BATCH),
                             dtype=torch.float32, device=dev)
    raised[:BATCH // 2] = 0.0
    proposed = _speed_from_jerk(states.ego_speed, states.ego_accel,
                                policy(states), ccfg) + raised
    states_cpu, proposed_cpu = to_cpu(states), proposed.cpu()
    st_kernel.launches = 0
    t = time.perf_counter()
    speed_k, take_k = mpc.batched_conditional_st(states, proposed, ccfg)
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t
    launches = st_kernel.launches
    parts = [mpc.batched_conditional_st(
        type(states)(*(x[i:i + 32] for x in states_cpu)),
        proposed_cpu[i:i + 32], ccfg) for i in range(0, BATCH, 32)]
    speed_d = torch.cat([p[0] for p in parts])
    take_d = torch.cat([p[1] for p in parts])
    take_k, speed_k = take_k.cpu(), speed_k.cpu()
    agree = take_k == take_d
    for i in torch.nonzero(~agree)[:, 0].tolist():
        print(f"   state {i}: takeover card {bool(take_k[i])}, cpu "
              f"{bool(take_d[i])}; speed {float(speed_k[i]):.4f} vs "
              f"{float(speed_d[i]):.4f}, proposed "
              f"{float(proposed_cpu[i]):.4f}", flush=True)
    gap = float((speed_k - speed_d)[agree].abs().max())
    # the single-scenario forms (dense DP on both sides), state by state
    corridor, single_same = [], 0
    for i in range(CORRIDOR_STATES):
        pair, plans, verdicts = [], [], []
        for st in (states, states_cpu):
            one = type(st)(*(x[i] for x in st))
            pair.append(float(mpc.st_control_speed(one, ccfg,
                                                   use_corridor=True)[0]))
            plan = mpc.plan_st(one, ccfg)
            plans.append((int(plan.valid_len), plan.s_sequence.cpu()))
            verdicts.append(bool(mpc.test_guaranteed_crash(one, ccfg)))
        corridor.append(pair)
        single_same += plans[0][0] == plans[1][0] \
            and float((plans[0][1] - plans[1][1]).abs().max()) <= 1e-3 \
            and verdicts[0] == verdicts[1]
    corridor_gap = max(abs(a - b) for a, b in corridor)
    # path_cost_report on a float64 lattice (random on-grid paths, one off
    # the lattice, one that breaks every limit), card vs CPU
    gen = np.random.default_rng(22)
    s_values = np.arange(ccfg.num_s, dtype=np.float64) \
        * ccfg.S_DISCRETIZATION
    dist = gen.uniform(1.0, 50.0, (8, ccfg.num_t, ccfg.num_s))
    seqs = np.cumsum(gen.integers(0, 30, (8, ccfg.num_t)), axis=1) \
        * ccfg.S_DISCRETIZATION
    seqs[6] += 0.013
    seqs[7, 5:] += 40.0
    cost_args = (seqs, gen.uniform(0, 15, 8), gen.uniform(-2, 2, 8))
    reports = []
    for d in (dev, torch.device("cpu")):
        total, counts = mpc.path_cost_report(
            *(torch.as_tensor(x, device=d) for x in cost_args),
            ccfg.T_DISCRETIZATION, torch.as_tensor(dist, device=d),
            torch.as_tensor(s_values, device=d)[None].expand(8, -1),
            mpc.weights_from_settings(ccfg))
        reports.append((total.cpu(), {k: v.cpu() for k, v in
                                      counts.items()}))
    fin = torch.isfinite(reports[1][0])
    cost_gap = float(((reports[0][0] - reports[1][0]).abs()
                      / reports[1][0].abs())[fin].max())
    counts_same = all(torch.equal(reports[0][1][k], reports[1][1][k])
                      for k in reports[1][1])
    out["planner_forms"] = {
        "conditional_launches": launches,
        "conditional_flag_agreement": float(agree.float().mean()),
        "takeovers_card": int(take_k.sum()), "takeovers_cpu":
        int(take_d.sum()), "speed_gap_where_agree": gap,
        "conditional_card_s": card_s,
        "corridor_speeds_card_cpu": corridor,
        "corridor_speed_gap": corridor_gap,
        "plan_st_and_certificate_same": single_same,
        "path_cost_rel_gap": cost_gap, "path_cost_finite": int(fin.sum()),
        "violation_counts_same": counts_same,
        "k1_launches_after_single_forms": st_kernel.launches}
    print("   " + json.dumps(out["planner_forms"]) + " (bars: K1 +2 per "
          "conditional call and none after, flags >= 0.97, corridor speeds "
          f"within 1e-3 m/s, plan_st and the certificate the same on "
          f"{CORRIDOR_STATES} of {CORRIDOR_STATES} states, path costs "
          "within 1e-9 relative, counts identical)", flush=True)
    assert launches == 2 and float(agree.float().mean()) >= 0.97
    assert 0 < int(take_k.sum()) < BATCH
    assert torch.isfinite(speed_k).all() and corridor_gap <= 1e-3
    assert single_same == CORRIDOR_STATES and counts_same
    assert cost_gap <= 1e-9 and 0 < int(fin.sum()) < 8
    assert st_kernel.launches == 2
    done(t0)
    return out


def dqn_tabular_gym_phases(dev, states) -> dict:
    """Phases 23-25: the custom DQN, the tabular Q path and the Gym
    adapter, with K1's count set to 0 before and read after (none of them
    plans)."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch._device import pin_fp32_matmul
    from rl_mpc_lanemerging_torch.agents import budget, dqn
    from rl_mpc_lanemerging_torch.checkpoint import load_dqn
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.envs import gym_compat
    from rl_mpc_lanemerging_torch.ops import st_kernel
    from rl_mpc_lanemerging_torch.rl import replay as rb
    from rl_mpc_lanemerging_torch.rl import tabular
    from rl_mpc_lanemerging_torch.rl.obs import state_vector
    from rl_mpc_lanemerging_torch.rundir import RUNS_ROOT
    from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world

    pin_fp32_matmul()
    cpu = torch.device("cpu")
    out = {}
    st_kernel.launches = 0

    t0 = phase(f"23 custom DQN: {TRAINED_DQN}; the trainer at B={BATCH}")
    cfg = Settings.load_from_file(TRAIN_CONFIG)
    sides = (("card", dev), ("cpu", cpu))
    nets = {side: load_dqn(TRAINED_DQN, d, committed=True)
            for side, d in sides}
    with torch.no_grad():
        q_card = nets["card"](state_vector(states, cfg)).cpu()
        q_cpu = nets["cpu"](state_vector(to_cpu(states), cfg))
    actions_same = torch.equal(q_card.argmax(-1), q_cpu.argmax(-1))
    q_gap = float((q_card - q_cpu).abs().max())

    # the trainer's loop until one episode ends: its rounds (timed), a
    # target refresh and a 128-episode selection evaluation after each
    # round that ends an episode, the snapshot saved
    grad_steps = budget.grad_steps_per_round(cfg.TRAINING_STEPS_PER_EPISODE,
                                             cfg.BATCH_SCENARIOS, DQN_TICKS)
    added, rounds_s = [], []
    real_add, real_round = rb.add_batch, dqn.train_round

    def counting_add(*args, **kw):
        added.append(args[6].sum())           # the valid rows
        return real_add(*args, **kw)

    def timed_round(*args, **kw):
        t = time.perf_counter()
        result = real_round(*args, **kw)
        torch.cuda.synchronize(dev)
        rounds_s.append(time.perf_counter() - t)
        return result

    rb.add_batch, dqn.train_round = counting_add, timed_round
    steps = _counting(dqn, "_grad_step")
    refreshes = _counting(dqn, "refresh_target")
    tcfg = cfg.replace(LOG_DIR=DQN_LOG_DIR, TARGET_NET_FREEZE_PERIOD=1,
                       EVALUATION_PERIOD=1)
    try:
        t = time.perf_counter()
        state = dqn.train(tcfg, num_episodes=1, env_ticks=DQN_TICKS,
                          device=dev, eval_episodes=TASK_EPISODES)
        train_s = time.perf_counter() - t
    finally:
        rb.add_batch, dqn.train_round = real_add, real_round
        dqn._grad_step, dqn.refresh_target = steps.fn, refreshes.fn
    rep = {"s_per_round": rounds_s, "train_s": train_s,
           "episodes": int(state.episodes),
           "replay_size": int(state.replay.size),
           "target_refreshes": refreshes.calls}
    g = torch.Generator(device=dev).manual_seed(23)
    step_ms = wall_ms(lambda: dqn._grad_step(
        state.net, state.target_net, state.opt,
        rb.sample(state.replay, cfg.BATCH_SIZE, generator=g)[1], cfg))
    valid_frames = int(sum(added))
    rep.update(grad_steps=steps.calls, grad_steps_per_round=grad_steps,
               valid_frames=valid_frames, grad_step_ms=step_ms,
               loss_sum=float(state.loss_sum))
    assert rep["replay_size"] == valid_frames > 0, rep
    assert steps.calls == grad_steps * len(rounds_s), rep
    assert rep["episodes"] >= 1 and refreshes.calls >= 1, rep
    assert os.path.exists(os.path.join(RUNS_ROOT, DQN_LOG_DIR, "params.npz"))
    assert all(bool(torch.isfinite(p).all()) for p in state.net.parameters())

    learners = {}
    for side, d in sides:
        net = load_dqn(TRAINED_DQN, d, committed=True).train()
        net.requires_grad_(True)
        target = load_dqn(TRAINED_DQN, d, committed=True)
        with torch.no_grad():
            for p in target.parameters():
                p.mul_(0.9)
        learners[side] = (d, net, target, dqn._adam(net, cfg.LEARNING_RATE))
    losses = {"card": [], "cpu": []}
    for _ in range(UPDATE_PARITY_STEPS):
        b = rb.sample(state.replay, cfg.BATCH_SIZE, generator=g)[1]
        for side, (d, *learner) in learners.items():
            loss, _ = dqn._grad_step(*learner, {k: v.to(d) for k, v in
                                                b.items()}, cfg)
            losses[side].append(float(loss))
    param_gap = _param_gap(learners["card"][1].parameters(),
                           learners["cpu"][1].parameters())
    loss_gap = max(abs(a - b) for a, b in zip(losses["card"],
                                               losses["cpu"]))

    ecfg = cfg.replace(BATCH_SCENARIOS=TASK_EPISODES,
                       NUM_EPISODES=TASK_EPISODES)
    t = time.perf_counter()
    agg = tasks.evaluate_controller(
        ecfg, dqn.greedy_controller(nets["card"], ecfg), device=dev,
        verbose=False)
    ev = round_report(agg, ecfg)
    ev["sem"] = {k: float(np.std(agg.columns[c]) / np.sqrt(len(
        agg.columns[c]))) for k, c in (("crash", "crashed"),
                                       ("merge", "merged"))}
    ev["seconds"] = time.perf_counter() - t
    out["dqn"] = {"greedy_actions_identical": actions_same, "q_gap": q_gap,
                  "round": rep, "grad_step_rel_param_gap": param_gap,
                  "grad_step_loss_gap": loss_gap, "evaluation": ev}
    print(f"   greedy actions card vs CPU on {BATCH} states identical: "
          f"{actions_same} (max |Q| gap {q_gap:.3g}); train round: "
          + json.dumps(rep) + f"; {UPDATE_PARITY_STEPS} grad steps card vs "
          f"CPU: relative parameter gap {param_gap:.3g} (bar <= 1e-4), "
          f"loss gap {loss_gap:.3g}; greedy evaluation: " + json.dumps(ev)
          + "; run_data.csv line 218: crash 0.0, merge 1.0, |jerk| 0.3602, "
          "time to merge 26.35 s (bars: crash <= 0.05, merge >= 0.90)",
          flush=True)
    assert actions_same and param_gap <= 1e-4
    assert ev["crash"] <= 0.05 and ev["merge"] >= 0.90, ev
    done(t0)

    t0 = phase(f"24 tabular Q: a collect round at B={TABULAR_BATCH} and its "
               f"fold on the card and the CPU")
    base = Settings()
    qcfg = base.replace(TASK="TRAIN_Q", REWARD_FUNCTION="Slotted",
                        TICK_LENGTH=base.TRAINING_TICK_LENGTH,
                        JERK_VALUES_DQN=base.JERK_VALUES)
    ticks = int(qcfg.MAX_EPISODE_LENGTH / qcfg.TICK_LENGTH) \
        + int(20.0 / qcfg.TICK_LENGTH) + 2
    t = time.perf_counter()
    rec = tabular.collect_random_round(
        qcfg, init_world(qcfg, TABULAR_BATCH, torch.float32, dev),
        CounterRandom(24), ticks, torch.Generator(device=dev).manual_seed(24))
    torch.cuda.synchronize(dev)
    collect_s = time.perf_counter() - t
    tables, fold_s = {}, {}
    for side, d in sides:
        q = tabular.initialize_q(qcfg, device=d)
        visits = tabular.initialize_q(qcfg, device=d)
        r = tabular.EpisodeRecords(*(tuple(x.to(d) for x in f)
                                     if isinstance(f, tuple) else f.to(d)
                                     for f in rec))
        t = time.perf_counter()
        tabular.fold_episodes(q, visits, r.states6, r.actions, r.rewards,
                              r.valid, qcfg.GAMMA, qcfg.STEP_SIZE)
        visits.sum().item()                   # waits for the fold
        fold_s[side] = time.perf_counter() - t
        tables[side] = (q.cpu(), visits.cpu())
    q_gap = float((tables["card"][0] - tables["cpu"][0]).abs().max())
    visits_same = torch.equal(tables["card"][1], tables["cpu"][1])
    # the single-episode form on the first scenario's episode
    first = []
    for side, d in sides:
        q = tabular.initialize_q(qcfg, device=d)
        tabular.q_update_episode(
            q, tabular.initialize_q(qcfg, device=d),
            tuple(x[0].to(d) for x in rec.states6), rec.actions[0].to(d),
            rec.rewards[0].to(d), rec.valid[0].to(d), qcfg.GAMMA,
            qcfg.STEP_SIZE)
        first.append(q.cpu())
    q_gap = max(q_gap, float((first[0] - first[1]).abs().max()))
    valid_steps = int(rec.valid.sum())
    q_table = torch.as_tensor(np.load(TABULAR_Q), device=dev)
    ecfg = qcfg.replace(TICK_LENGTH=qcfg.EVALUATION_TICK_LENGTH,
                        BATCH_SCENARIOS=TASK_EPISODES)
    t = time.perf_counter()
    agg = tasks.evaluate_controller(
        ecfg, tabular.greedy_tabular_controller(q_table, None, ecfg),
        num_episodes=TASK_EPISODES, device=dev,
        max_episode_length=qcfg.EVALUATION_EPISODE_LENGTH, verbose=False)
    ev = round_report(agg, ecfg)
    ev["seconds"] = time.perf_counter() - t
    out["tabular"] = {"ticks": ticks, "episodes": TABULAR_BATCH,
                      "valid_steps": valid_steps, "collect_s": collect_s,
                      "fold_s": fold_s, "q_gap": q_gap,
                      "visits_identical": visits_same,
                      "visited_pairs": int((tables["cpu"][1] > 0).sum()),
                      "greedy_evaluation": ev}
    print("   " + json.dumps(out["tabular"]) + "; run_data.csv lines 171 / "
          "175 (the trained table with its visit table): crash 1.0 / 1.0, "
          "merge 0.0 / 0.0 (bars: Q within 1e-6, visits identical)",
          flush=True)
    assert q_gap <= 1e-6 and visits_same and valid_steps > 0
    assert ev["episodes"] == TASK_EPISODES
    done(t0)

    t0 = phase(f"25 Gym envs, {GYM_STEPS} steps each on the card and the "
               f"CPU")
    gym_out = {}
    for cls in (gym_compat.JerkEnv, gym_compat.AccelerationEnv,
                gym_compat.ContinuousJerkEnv):
        runs = {}
        for side, d in sides:
            env = cls({"settings": base, "wait_before_start": GYM_WAIT,
                       "seed": 25, "device": d})
            rng = np.random.default_rng(25)
            obs, _ = env.reset()
            trace = [(obs, 0.0, False, False, {})]
            for _ in range(GYM_STEPS):
                if env._env is None:
                    obs, _ = env.reset()
                space = env.action_space
                action = rng.uniform(space.low, space.high).astype(
                    np.float32) if hasattr(space, "low") \
                    else int(rng.integers(space.n))
                trace.append(env.step(action))
            runs[side] = trace
        flags_same = all(a[2:] == b[2:] for a, b in
                         zip(runs["card"], runs["cpu"]))
        obs_gap = max(float(np.abs(a[0] - b[0]).max()) for a, b in
                      zip(runs["card"], runs["cpu"]))
        reward_gap = max(abs(a[1] - b[1]) for a, b in
                         zip(runs["card"], runs["cpu"]))
        gym_out[cls.__name__] = {"flags_identical": flags_same,
                                 "obs_gap": obs_gap,
                                 "reward_gap": reward_gap}
        assert flags_same and obs_gap <= 1e-4, gym_out
    gym_out["registered"] = gym_compat.register_environments()
    out["gym"] = gym_out
    out["k1_launches"] = st_kernel.launches
    print("   " + json.dumps(gym_out) + f"; K1 launches in phases 23-25: "
          f"{st_kernel.launches} (bars: flags identical, observations within "
          "1e-4, 0 K1 launches; the IDs register only where gymnasium or gym "
          "is installed)", flush=True)
    assert st_kernel.launches == 0
    done(t0)
    return out


# ---------------------------------------------------------------------------
# phase 26: the scenario mesh on one card
# ---------------------------------------------------------------------------

def _same_across(dicts) -> float:
    """Largest |difference| between the first state_dict and the others
    (0.0 when bit-identical)."""
    return max(float((d[k].float() - dicts[0][k].float()).abs().max())
               for d in dicts[1:] for k in dicts[0])


def _averaged_step(opt, losses) -> None:
    """An optimiser step on the mean of the gradients of ``losses``, taken
    one by one and averaged by hand."""
    params = opt.param_groups[0]["params"]
    grads = [torch.autograd.grad(loss, params) for loss in losses]
    for p, *gs in zip(params, *grads):
        p.grad = sum(gs) / len(gs)
    opt.step()


def _hand_ddpg_update(actor, critic, t_actor, t_critic, a_opt, c_opt,
                      batches) -> None:
    """The DDPG update of the JAX package (ddpg.py:97-140) in one process,
    the gradients of the ranks' batches averaged by hand."""
    from rl_mpc_lanemerging_torch.agents import ddpg

    def critic_loss(b):
        with torch.no_grad():
            q_next = t_critic(b["next_obs"], t_actor(b["next_obs"]))
            target = b["reward"] + ddpg.DDPG_DISCOUNT * torch.where(
                b["terminal"], 0.0, q_next)
        return torch.mean((critic(b["obs"], b["action"][:, None])
                           - target) ** 2)

    _averaged_step(c_opt, [critic_loss(b) for b in batches])
    _averaged_step(a_opt, [-torch.mean(critic(b["obs"], actor(b["obs"])))
                           for b in batches])
    ddpg._polyak((t_actor, t_critic), (actor, critic))


def _hand_dqn_step(net, target, opt, batches, cfg) -> None:
    """The custom DQN's grad step (dqn.py:107-124) in one process, the
    gradients of the ranks' batches averaged by hand."""
    from rl_mpc_lanemerging_torch.agents import dqn

    def loss(b):
        targets = dqn._targets(net, target, b, cfg)
        qa = net(b["obs"]).gather(1, b["action"][:, None])[:, 0]
        return torch.nn.functional.huber_loss(qa, targets, delta=1.0)

    _averaged_step(opt, [loss(b) for b in batches])


def _copies(modules, opts):
    """Deep copies of modules and of their Adam optimisers' state."""
    from rl_mpc_lanemerging_torch.agents.ddpg import _adam
    mods = [copy.deepcopy(m) for m in modules]
    new = []
    for m, opt in zip(mods, opts):
        o = _adam(m, opt.param_groups[0]["lr"])
        o.load_state_dict(copy.deepcopy(opt.state_dict()))
        new.append(o)
    return mods, new


def _dp_parity(mesh, modules, opts, batch, step, hand) -> float:
    """MESH_DP_UPDATES data-parallel steps, rank r always on its own
    ``batch``, against one process that averages the ranks' gradients by
    hand from the same start; the largest relative parameter gap on rank 0
    (None on the others)."""
    from rl_mpc_lanemerging_torch.parallel import sharded
    dev = next(modules[0].parameters()).device
    batches = sharded.gather_objects(batch, mesh)
    ref = _copies(modules, opts) if batches is not None else None
    for _ in range(MESH_DP_UPDATES):
        step(batch)
    if batches is None:
        return None
    batches = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    for _ in range(MESH_DP_UPDATES):
        hand(*ref, batches)
    return _param_gap([p for m in modules for p in m.parameters()],
                      [p.cpu() for m in ref[0] for p in m.parameters()])


def _allreduce_ms(grads, group, runs: int = 50) -> float:
    """Host ms of one ``average_gradients`` of ``grads`` (synchronised)."""
    from rl_mpc_lanemerging_torch.parallel import sharded
    sharded.average_gradients(grads, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        sharded.average_gradients(grads, group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3


def mesh_rank(device_type, st_cfg, train_cfg, tp_obs, tp_action) -> dict:
    """One rank of phase 26 (a), (c), (d) and (e), on the card over
    ``gloo`` (``device_type`` "cpu" rehearses it on the CPU); what rank 0
    returns carries the comparisons."""
    from rl_mpc_lanemerging_torch import checkpoint, convert, tasks
    from rl_mpc_lanemerging_torch.agents import ddpg, dqn
    from rl_mpc_lanemerging_torch.models.ddpg import DDPGCritic
    from rl_mpc_lanemerging_torch.ops import st_kernel
    from rl_mpc_lanemerging_torch.parallel import sharded, tp
    from rl_mpc_lanemerging_torch.parallel.mesh import make_mesh
    from rl_mpc_lanemerging_torch.planner import mpc
    from rl_mpc_lanemerging_torch.rl import replay as rb

    dev = torch.device("cpu") if device_type == "cpu" \
        else torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(device_type)
    group, rank, _ = sharded.axis_group(mesh)
    out = {"rank": rank, "device": str(dev)}

    # (a) the ST round, this rank's 64 scenarios
    t0 = time.perf_counter()
    controller = mpc.make_batched_controller(st_cfg)
    ticks = 0

    def counted(state):
        nonlocal ticks
        ticks += 1
        return controller(state)

    real = mpc.make_batched_controller
    mpc.make_batched_controller = lambda c: counted
    try:
        st_kernel.launches = 0
        t_round = time.perf_counter()
        agg = tasks.evaluate_st(st_cfg, device=dev, verbose=False)
        seconds = time.perf_counter() - t_round
        launches = st_kernel.launches
    finally:
        mpc.make_batched_controller = real
    out["a"] = {"columns": None if agg is None else dict(agg.columns),
                "ticks": ticks, "launches": launches, "seconds": seconds,
                "s_per_tick": seconds / max(ticks, 1),
                "part_s": time.perf_counter() - t0}

    # (c) data-parallel DDPG: a fill round, then learning ticks
    t0 = time.perf_counter()
    st_kernel.launches = 0
    cfg = train_cfg.replace(BATCH_SCENARIOS=MESH_TRAIN_BATCH)
    state, round_fn = ddpg.make_sharded_train(
        cfg, mesh, seed=26, lr=cfg.LEARNING_RATE, env_ticks=10,
        updates_per_tick=0)
    fill_ticks = 0
    while not state.learning and fill_ticks < MESH_FILL_TICKS:
        state = round_fn(state)         # the ranks agree on ``learning``
        fill_ticks += 10
    filled = int(state.replay.size)
    state = round_fn(state, env_ticks=MESH_LEARN_TICKS,
                     updates_per_tick=UPDATES_PER_TICK)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    actors = sharded.gather_state_dicts(state.actor, mesh)
    critics = sharded.gather_state_dicts(state.critic, mesh)
    obs = sharded.gather_objects(state.env.obs, mesh)
    c_grads = [p.grad.clone() for p in state.critic.parameters()]
    a_grads = [p.grad.clone() for p in state.actor.parameters()]
    allreduce_ms = (_allreduce_ms(c_grads, group)
                    + _allreduce_ms(a_grads, group))
    nets = (state.actor, state.critic, state.target_actor,
            state.target_critic)
    opts = (state.actor_opt, state.critic_opt)
    _, fixed = rb.sample(state.replay, ddpg.DDPG_BATCH,
                         generator=torch.Generator(dev).manual_seed(rank))
    update_ms = wall_ms(lambda: ddpg._update(*nets, *opts, fixed, group))
    gap = _dp_parity(
        mesh, nets, opts, fixed,
        lambda b: ddpg._update(*nets, *opts, b, group),
        lambda mods, o, bs: _hand_ddpg_update(*mods, o[0], o[1], bs))
    out["c"] = {"fill_ticks": fill_ticks, "replay_after_fill": filled,
                "updates": state.updates,
                "frames": int(state.frames), "round_s": round_s,
                "ms_per_update": update_ms, "allreduce_ms_per_update":
                allreduce_ms, "k1_launches": st_kernel.launches,
                "params_gap_across_ranks": None if actors is None else
                max(_same_across(actors), _same_across(critics)),
                "obs_differ": None if obs is None else
                not torch.equal(obs[0], obs[1]),
                "dp_vs_hand_gap": gap,
                "part_s": time.perf_counter() - t0}

    # (d) data-parallel custom DQN
    t0 = time.perf_counter()
    dstate, dround = dqn.make_sharded_train(
        cfg, mesh, seed=26, env_ticks=MESH_DQN_TICKS,
        grad_steps=MESH_DQN_GRAD_STEPS)
    dstate = dround(dstate)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    nets_d = sharded.gather_state_dicts(dstate.net, mesh)
    obs = sharded.gather_objects(dstate.env.obs, mesh)
    _, fixed = rb.sample(dstate.replay, cfg.BATCH_SIZE,
                         generator=torch.Generator(dev).manual_seed(rank))
    gap = _dp_parity(
        mesh, (dstate.net, dstate.target_net), (dstate.opt,), fixed,
        lambda b: dqn._grad_step(dstate.net, dstate.target_net, dstate.opt,
                                 b, cfg, group),
        lambda mods, o, bs: _hand_dqn_step(mods[0], mods[1], o[0], bs, cfg))
    out["d"] = {"grad_steps": dstate.grad_steps, "round_s": round_s,
                "replay_size": int(dstate.replay.size),
                "k1_launches": st_kernel.launches,
                "params_gap_across_ranks": None if nets_d is None else
                _same_across(nets_d),
                "obs_differ": None if obs is None else
                not torch.equal(obs[0], obs[1]),
                "dp_vs_hand_gap": gap, "part_s": time.perf_counter() - t0}

    # (e) the trained critic split over a 2-rank model axis
    t0 = time.perf_counter()
    tp_mesh = make_mesh(device_type, (1, 2), ("scenario", "model"))
    tree = checkpoint.load_params(TRAINED_DDPG, committed=True)["critic"]
    whole, split = DDPGCritic().to(dev), DDPGCritic().to(dev)
    for m in (whole, split):
        m.load_state_dict(convert.ddpg_critic_from_numpy(tree))
    rules = tp.mlp_tp_rules()
    want = {k: str(v) for k, v in tp.param_path_specs(split, rules).items()}
    tp.shard_params(split, tp_mesh, rules)
    got = {n: [str(p) for p in getattr(q, "placements", ())]
           for n, q in split.named_parameters()}
    x = torch.as_tensor(tp_obs, device=dev)
    a = torch.as_tensor(tp_action, device=dev)
    with torch.no_grad():
        q_split, q_whole = split(x, a), whole(x, a)
    torch.cuda.synchronize()
    out["e"] = {"rel_gap": float((q_split - q_whole).abs().max())
                / float(q_whole.abs().max()),
                "abs_gap": float((q_split - q_whole).abs().max()),
                "q_abs_max": float(q_whole.abs().max()),
                "placements_as_rules": all(
                    g == [w] or (w == "R" and not g)
                    for (n, g), w in zip(got.items(), want.values())),
                "placements": got, "part_s": time.perf_counter() - t0}
    return out


def _run_data_row(line: int) -> dict:
    """Line ``line`` (1-based, the header is line 1) of run_data.csv."""
    with open("run_data.csv", newline="") as fh:
        rows = list(csv.reader(fh))
    return dict(zip(rows[0], rows[line - 1]))


def mesh_phases(dev, main_cfg, single, states, st_kernel, st_dp) -> dict:
    """Phase 26: the scenario mesh on one card.  ``single`` is phase 6's
    one-process round (columns, s per tick) of ``main_cfg``; ``states``
    phase 3's 128 sensed states."""
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.parallel import sharded
    from rl_mpc_lanemerging_torch.rl.obs import state_vector

    t_phase = phase("26 the scenario mesh on one card: (a) sharded ST, "
                    "(c) DP DDPG, (d) DP DQN, (e) TP critic over 2 gloo "
                    "ranks; (b) NCCL at world size 1; (f) combined_default_2")
    out = {}
    train_cfg = Settings.load_from_file(TRAIN_CONFIG)
    actor = load_actor(TRAINED_DDPG, dev, train_cfg.MINIMUM_NEGATIVE_JERK,
                       train_cfg.MAXIMUM_POSITIVE_JERK, committed=True)
    with torch.no_grad():
        tp_obs = state_vector(states, train_cfg)
        tp_action = actor(tp_obs)
    t0 = time.perf_counter()
    ranks = sharded.spawn(mesh_rank, MESH_RANKS, args=(
        dev.type, main_cfg, train_cfg, tp_obs.cpu().numpy(),
        tp_action.cpu().numpy()), backend="gloo", timeout=900)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    a_parts = [r["a"] for r in ranks]

    # (a)
    cols = r0["a"]["columns"]
    diff = {k: int(np.sum(np.asarray(cols[k]) != np.asarray(v)))
            for k, v in single["columns"].items()
            if not k.startswith("clock_time")}
    ticks = [p["ticks"] for p in a_parts]
    launches = sum(p["launches"] for p in a_parts)
    out["a"] = {"ticks_per_rank": ticks, "launches": launches,
                "s_per_tick_per_rank": [p["s_per_tick"] for p in a_parts],
                "single_process_s_per_tick": single["s_per_tick"],
                "round_s_per_rank": [p["seconds"] for p in a_parts],
                "episodes": len(cols["crashed"]),
                "columns_differing": {k: n for k, n in diff.items() if n},
                "part_s": max(p["part_s"] for p in a_parts)}
    print("   (a) " + json.dumps(out["a"]), flush=True)
    assert all(r["device"].startswith(dev.type) for r in ranks), ranks
    assert out["a"]["episodes"] == BATCH and not out["a"]["columns_differing"]
    assert launches == sum(ticks) > 0, (launches, ticks)

    # (c), (d), (e)
    for part in "cde":
        rep = {k: v for k, v in r0[part].items() if k != "placements"}
        rep["part_s_per_rank"] = [r[part]["part_s"] for r in ranks]
        out[part] = rep
        print(f"   ({part}) " + json.dumps(rep), flush=True)
    c, d, e = out["c"], out["d"], out["e"]
    assert [r["c"]["updates"] for r in ranks] == [
        UPDATES_PER_TICK * MESH_LEARN_TICKS] * MESH_RANKS, ranks
    assert c["params_gap_across_ranks"] == 0.0 and c["obs_differ"]
    assert c["dp_vs_hand_gap"] <= 1e-6 and c["k1_launches"] == 0
    assert len({r["d"]["grad_steps"] for r in ranks}) == 1
    assert d["grad_steps"] == MESH_DQN_GRAD_STEPS
    assert d["params_gap_across_ranks"] == 0.0 and d["obs_differ"]
    assert d["dp_vs_hand_gap"] <= 1e-6 and d["k1_launches"] == 0
    assert all(r["e"]["rel_gap"] <= 1e-5 and r["e"]["placements_as_rules"]
               for r in ranks), [r["e"] for r in ranks]
    print(f"   spawn of {MESH_RANKS} ranks, (a) and (c)-(e): "
          f"{spawn_s:.2f} s", flush=True)

    # (b) the CLI at world size 1 over NCCL: one ST round of 8 scenarios
    t0 = time.perf_counter()
    run_dir = os.path.join("runs_torch", "chip_smoke_nccl")
    os.makedirs(run_dir, exist_ok=True)
    config = os.path.join(run_dir, "st_nccl.json")
    with open(config, "w") as fh:
        json.dump(dict(json.load(open(CONFIG)), **NCCL_SETTINGS), fh)
    rows = os.path.join(run_dir, "rows.csv")
    if os.path.exists(rows):
        os.remove(rows)
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(sharded.free_port()))
    proc = subprocess.run(
        [sys.executable, "-m", "rl_mpc_lanemerging_torch.main", config,
         "--csv", rows, "--device", dev.type], env=env, capture_output=True,
        text=True, timeout=600)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-3000:]
    with open(rows, newline="") as fh:
        csv_rows = list(csv.DictReader(fh))
    first = {k: float(np.mean(single["columns"][k][:NCCL_SETTINGS[
        "BATCH_SCENARIOS"]])) for k in ("crashed", "merged")}
    out["b"] = {"returncode": proc.returncode, "csv_rows": len(csv_rows),
                "nccl_group": f"backend {backend}, rank 0 of 1" in text,
                "round_line": next((ln for ln in text.splitlines()
                                    if ln.startswith("[")), None),
                "row": {k: float(csv_rows[-1][k]) for k in (
                    "crashed", "merged", "mean_abs_jerk", "time_to_merge")}
                if csv_rows else None,
                "phase_6_first_8": first,
                "part_s": time.perf_counter() - t0}
    print("   (b) " + json.dumps(out["b"]), flush=True)
    assert out["b"]["nccl_group"] and len(csv_rows) == 1, text[-3000:]
    assert all(out["b"]["row"][k] == v for k, v in first.items()), out["b"]

    # (f) a newly converted actor through the arbiter
    t0 = time.perf_counter()
    rep = combined_round(COMBINED_2_CONFIG, COMBINED_2_BATCH, dev, st_kernel,
                         st_dp)
    rows = {line: _run_data_row(line) for line in (92, 241)}
    rep["run_data"] = {line: {k: float(r[k]) for k in
                              ("crashed", "merged", "mean_abs_jerk",
                               "time_to_merge")}
                       for line, r in rows.items()}
    rep["part_s"] = time.perf_counter() - t0
    out["f"] = rep
    print(f"   (f) combined_default_2 through ddpg_default2_extended: crash "
          f"{rep['crash']:.4f} merge {rep['merge']:.4f} |jerk| "
          f"{rep['mean_abs_jerk']:.4f} time to merge "
          f"{rep['time_to_merge_s']:.2f} s; run_data.csv "
          + json.dumps(rep["run_data"]), flush=True)
    n = COMBINED_2_BATCH
    assert rep["crash"] * n <= 1 and rep["merge"] * n >= n - 1
    out["seconds"] = time.perf_counter() - t_phase
    print("   phase 26 parts (s): " + json.dumps(
        {p: out[p]["part_s"] for p in "abcdef"}), flush=True)
    done(t_phase)
    return out


def merge_region_grids(cfg, dev, controller, seed: int = 0):
    """SNAPSHOTS snapshots, SNAPSHOT_EVERY ticks apart from FIRST_SNAPSHOT
    ticks after the ego joins, of BATCH worlds of ``cfg`` driven through
    the merge region by ``controller``: (the arguments of st_wavefront per
    snapshot, the first snapshot's sensed states, its worlds, t_values)."""
    from rl_mpc_lanemerging_torch.planner.grid import build_st_grid
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, add_ego,
                                              init_world, sense, warmup,
                                              world_step)
    rng = CounterRandom(seed)
    worlds = init_world(cfg, BATCH, torch.float32, dev)
    worlds = warmup(worlds, cfg, int(50.0 / cfg.TICK_LENGTH), rng)
    worlds = add_ego(worlds, torch.full((BATCH,), 15.0, device=dev))
    snapshots = []
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
            if states is None:
                states, worlds0, t_values = sensed, worlds, g.t_values
    return snapshots, states, worlds0, t_values


def kernel_vs_plain(snapshots, kw, num_t: int, visited=None):
    """K1 in one launch over every snapshot's grids against its plain
    version, snapshot by snapshot: >= 99.9% of the s sequences identical
    within 1e-4 m and every first-step difference <= 0.101 m.  Returns
    (the kernel's sequences, as numpy, the identical share, the largest
    absolute difference)."""
    from rl_mpc_lanemerging_torch.ops import st_kernel
    all_args = tuple(torch.cat([snap[i] for snap in snapshots])
                     for i in range(5))
    n_grids = all_args[0].shape[0]
    seq_k = st_kernel.st_wavefront(*all_args, **kw, visited=visited)
    seq_r = torch.cat([st_kernel.st_wavefront_reference(*snap, **kw)
                       for snap in snapshots])
    torch.cuda.synchronize()
    k_np, r_np = seq_k.cpu().numpy(), seq_r.cpu().numpy()
    assert k_np.shape == (n_grids, num_t) and np.isfinite(k_np).all()
    identical = float(np.mean(np.all(np.abs(k_np - r_np) <= 1e-4, axis=1)))
    first_kr = np.abs((k_np[:, 1] - k_np[:, 0]) - (r_np[:, 1] - r_np[:, 0]))
    max_abs_err = float(np.abs(k_np - r_np).max())
    print(f"   {n_grids} grids in one launch: identical paths "
          f"{identical:.4f} (bar >= 0.999), max first-step diff "
          f"{first_kr.max():.6f} m (bar <= 0.101), max abs err "
          f"{max_abs_err:.3g}; complete paths "
          f"{int((k_np[:, -1] != 0).sum())}", flush=True)
    assert identical >= 0.999 and first_kr.max() <= 0.101
    return seq_k, k_np, identical, max_abs_err


def gate_b_phase(dev, st_kernel, st_dp) -> dict:
    """Phase 27: gate b and the hysteresis carry on the card."""
    from rl_mpc_lanemerging_torch.agents import combined, ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, add_ego,
                                              init_world, sense, warmup,
                                              world_step)

    t0 = phase(f"27 gate b and the hysteresis carry: {COMBINED_B_CONFIG} "
               f"with {json.dumps(GATE_B_SETTINGS)} and DESIRED_SPEED at the "
               f"RL's median speed, card (kernel) vs CPU (dense twin) over "
               f"{CARRY_TICKS} ticks of {BATCH} states; a round at "
               f"B={GATE_B_BATCH}")
    cfg = Settings.load_from_file(COMBINED_B_CONFIG).replace(
        **GATE_B_SETTINGS)
    assert cfg.TEST_ST_STRICTLY_BETTER     # the carry acts inside gate d
    policy, policy_cpu = (ddpg.actor_jerk(load_actor(
        cfg.MODEL_NAME, d, cfg.MINIMUM_NEGATIVE_JERK,
        cfg.MAXIMUM_POSITIVE_JERK, committed=True), cfg)
        for d in (dev, "cpu"))
    control, init_carry, _ = combined.combined_controller(policy, cfg)
    rng = CounterRandom(2)
    worlds = init_world(cfg, BATCH, torch.float32, dev)
    worlds = warmup(worlds, cfg, int(50.0 / cfg.TICK_LENGTH), rng)
    worlds = add_ego(worlds, torch.full((BATCH,), 15.0, device=dev))
    carry = init_carry(BATCH, dev)
    for _ in range(CARRY_FIRST_TICK):
        (speed, _), carry = control(sense(worlds, cfg), carry)
        worlds = world_step(worlds, speed, cfg, rng)
    sensed = sense(worlds, cfg)
    desired = float(combined._rl_rollout(policy, sensed, policy(sensed),
                                         cfg)[3].median())
    cfg = cfg.replace(DESIRED_SPEED=desired)
    # each side carries its own previous choice from the driven run's
    gates = ("take", "crash_pred", "over_speed", "condemned", "st_better")
    last_card, last_cpu = carry, carry.cpu()
    agree, fired, carried, by_carry = [], {g: [0, 0] for g in gates}, 0, 0
    for tick in range(CARRY_TICKS):
        sensed = sense(worlds, cfg)
        carried += int(last_card.sum())
        card = combined.arbitrate(policy, sensed, cfg, last_card)
        # where a takeover is carried and gates a-c stay quiet, the carry
        # decides gate d
        by_carry += int((last_card & ~(card.crash_pred | card.over_speed
                                       | card.condemned)).sum())
        sensed_cpu = to_cpu(sensed)
        parts = [combined.arbitrate(
            policy_cpu, type(sensed)(*(x[i:i + 32] for x in sensed_cpu)),
            cfg, last_cpu[i:i + 32]) for i in range(0, BATCH, 32)]
        cpu = type(card)(*(torch.cat(x) for x in zip(*parts)))
        card_cpu = type(card)(*(x.cpu() for x in card))
        same = card_cpu.take == cpu.take
        agree.append(same)
        for i in torch.nonzero(~same)[:, 0].tolist():
            print(f"   tick {tick} state {i} (carried {bool(last_cpu[i])}): "
                  + json.dumps({g: [bool(getattr(card_cpu, g)[i]),
                                    bool(getattr(cpu, g)[i])]
                                for g in gates}) + " (card, cpu)",
                  flush=True)
        for g in gates:
            fired[g][0] += int(getattr(card_cpu, g).sum())
            fired[g][1] += int(getattr(cpu, g).sum())
        last_card, last_cpu = card.take, cpu.take
        worlds = world_step(worlds, card.speed, cfg, rng)
    agreement = float(torch.cat(agree).float().mean())
    print(f"   DESIRED_SPEED {desired:.4f} m/s; {CARRY_TICKS} ticks x "
          f"{BATCH} states ({carried} of them with "
          f"a carried takeover, {by_carry} where the carry decides gate d): "
          f"flag agreement {agreement:.4f} (bar >= 0.97); firings (card, "
          f"cpu) " + json.dumps(fired), flush=True)
    assert agreement >= 0.97 and fired["over_speed"][0] > 0 and carried > 0
    rep = combined_round(COMBINED_B_CONFIG, GATE_B_BATCH, dev, st_kernel,
                         st_dp, DESIRED_SPEED=desired, **GATE_B_SETTINGS)
    assert rep["crash"] == 0.0
    done(t0)
    return {"desired_speed": desired, "flag_agreement": agreement,
            "firings": fired,
            "carried_takeovers": carried, "decided_by_carry": by_carry,
            "round": rep}


def st_fast_phase(dev, st_kernel) -> dict:
    """Phase 28: K1 against its plain version on st_fast's grids."""
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.ops import st_dp
    from rl_mpc_lanemerging_torch.planner import mpc

    t0 = phase(f"28 kernel vs plain version, {SNAPSHOTS * BATCH} grids of "
               f"{ST_FAST_CONFIG}")
    cfg = Settings.load_from_file(ST_FAST_CONFIG)
    kw = dict(delta_t=cfg.T_DISCRETIZATION, delta_s=cfg.S_DISCRETIZATION,
              w=mpc.weights_from_settings(cfg),
              max_offset=st_dp.default_max_offset(
                  cfg.MAX_SPEED, cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION))
    snapshots = merge_region_grids(cfg, dev,
                                   mpc.make_batched_controller(cfg))[0]
    _, k_np, identical, max_abs_err = kernel_vs_plain(snapshots, kw,
                                                      cfg.num_t)
    done(t0)
    return {"grids": len(k_np), "identical": identical,
            "max_abs_err": max_abs_err}


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
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, sense,
                                              world_step)
    from rl_mpc_lanemerging_torch.sim.episode import (empty_history,
                                                      record_tick)

    t_script = time.perf_counter()
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
    snapshots, states, worlds0, t_values = merge_region_grids(
        cfg, dev, controller)
    args = snapshots[0]
    all_args = tuple(torch.cat([snap[i] for snap in snapshots])
                     for i in range(5))
    n_grids = all_args[0].shape[0]
    visited_all = torch.zeros(1, dtype=torch.int64, device=dev)
    seq_k, k_np, identical, max_abs_err = kernel_vs_plain(
        snapshots, kw, cfg.num_t, visited=visited_all)
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

    t0 = phase("6 main path: evaluate_st (history on), st_default, B=128")
    ticks_run = 0

    def counted(state):
        nonlocal ticks_run
        ticks_run += 1
        return controller(state)

    main_cfg = cfg.replace(BATCH_SCENARIOS=BATCH, NUM_EPISODES=BATCH,
                           LOG_DIR="chip_smoke_st")
    make_controller = mpc.make_batched_controller
    mpc.make_batched_controller = lambda c: counted
    try:
        st_kernel.launches = 0
        t_main = time.perf_counter()
        agg = tasks.evaluate_st(main_cfg, device=dev, verbose=False)
        main_s = time.perf_counter() - t_main
        launches = st_kernel.launches
    finally:
        mpc.make_batched_controller = make_controller
    cols = agg.columns
    crash = float(np.mean(cols["crashed"]))
    merge = float(np.mean(cols["merged"]))
    mean_ticks = float(np.mean(cols["time_taken"])) / cfg.TICK_LENGTH
    jerk = float(np.mean(cols["mean_abs_jerk"]))
    s_per_tick = main_s / max(ticks_run, 1)
    print(f"   max_episode_length {MAX_EPISODE_LENGTH} s; crash {crash:.4f} "
          f"merge {merge:.4f} mean ticks {mean_ticks:.1f} mean |jerk| "
          f"{jerk:.4f}; {ticks_run} control ticks in {main_s:.2f} s = "
          f"{s_per_tick:.4f} s per tick (warmup and the history included); "
          f"st_wavefront launches {launches}", flush=True)
    assert len(cols["crashed"]) == BATCH and np.isfinite(jerk)
    assert launches == ticks_run > 0, (launches, ticks_run)
    done(t0)

    t0 = phase("7 tick split and kernel timing")
    rng = CounterRandom(0)
    a0 = args[3]
    op = qp.build_operator(cfg.fine_horizon, cfg.TICK_LENGTH)
    seq, valid, _ = mpc.batched_plan(states, cfg, use_kernel=True)
    # the recording's per-tick cost: run_episode_batch's own write
    # (record_tick) into a (B, 501, ...) history, every scenario active
    history = empty_history(states, int(MAX_EPISODE_LENGTH / cfg.TICK_LENGTH))
    active = torch.ones((BATCH,), dtype=torch.bool, device=dev)
    at = torch.full((BATCH,), 7, dtype=torch.int32, device=dev)

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
        "history_write_ms": wall_ms(
            lambda: record_tick(history, states, active, at)),
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
          f"({visited_pairs / pairs:.3f} x; B={n_grids}: "
          f"{int(visited_all.item())}); {cells} reachable cells, "
          f"{window_cells} window cells; bytes {n_bytes} "
          f"({bytes_ms:.5f} ms; every input cell once: {all_bytes}, "
          f"{all_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms), ops {n_ops} "
          f"({ops_ms:.5f} ms); kernel / bound {k_ms / bound_ms:.1f}",
          flush=True)
    assert min(new + [cold_ms]) > bound_ms, "a kernel time below its bound"
    done(t0)

    comb = combined_phases(dev, states, worlds0, kw)
    train = training_phases(dev)
    t_new = time.perf_counter()
    forms = forensics_phases(dev, states)
    rest = dqn_tabular_gym_phases(dev, states)
    print(f"   phases 20-25: {time.perf_counter() - t_new:.2f} s", flush=True)
    mesh = mesh_phases(dev, main_cfg,
                       {"columns": cols, "s_per_tick": s_per_tick}, states,
                       st_kernel, st_dp)
    gate_b = gate_b_phase(dev, st_kernel, st_dp)
    st_fast = st_fast_phase(dev, st_kernel)
    print(f"   the script: {time.perf_counter() - t_script:.2f} s",
          flush=True)

    kernels = [{
        "name": "st_wavefront",
        "route": "cuda",
        "source": "rl_mpc_lanemerging_torch/csrc/st_wavefront.cu",
        "replaces": "rl_mpc_lanemerging_tpu/ops/st_pallas.py:70",
        "launches": launches + comb["main"]["launches"]
        + mesh["a"]["launches"] + mesh["f"]["launches"]
        + gate_b["round"]["launches"],
        "launches_st_path": launches,
        "launches_combined_path": comb["main"]["launches"],
        "launches_sharded_st_path": mesh["a"]["launches"],
        "launches_combined_default_2": mesh["f"]["launches"],
        "launches_gate_b_hysteresis_path": gate_b["round"]["launches"],
        "max_abs_err": max(max_abs_err, comb["rollout_max_abs_err"],
                           st_fast["max_abs_err"]),
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
        "rollout_grids_compared": comb["rollout_grids"],
        "rollout_identical_paths": comb["rollout_identical"],
        "combined_control_ticks": comb["main"]["control_ticks"],
        "combined_seconds_per_tick": comb["main"]["seconds_per_tick"],
        "launches_training_paths": train["ddpg_rounds"]["k1_launches"]
        + train["rainbow_rounds"]["k1_launches"]
        + train["tasks"]["k1_launches"],
        "launches_conditional_st_call":
        forms["planner_forms"]["conditional_launches"],
        "launches_capture_replay_rollout_plans":
        forms["replay"]["k1_launches"],
        "launches_dqn_tabular_gym": rest["k1_launches"],
        "sharded_st_control_ticks": sum(mesh["a"]["ticks_per_rank"]),
        "sharded_st_seconds_per_tick_per_rank":
        mesh["a"]["s_per_tick_per_rank"],
        "launches_dp_training": mesh["c"]["k1_launches"]
        + mesh["d"]["k1_launches"],
        "gate_b_hysteresis_flag_agreement": gate_b["flag_agreement"],
        "gate_b_hysteresis_control_ticks":
        gate_b["round"]["control_ticks"],
        "st_fast_grids_compared": st_fast["grids"],
        "st_fast_identical_paths": st_fast["identical"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
