"""Task runners: the batched equivalents of the reference's experiment loops.

Port of ``rl_mpc_lanemerging_tpu/tasks.py`` (reference main.py:16-40 and
control.py:343-363 ``evaluate_control``) on a single device: a batch of
scenarios runs per round and the host only aggregates statistics between
rounds.
"""

from __future__ import annotations

import os
import secrets
import time
from typing import Optional

import torch

from ._device import resolve_device
from .config import Settings
from .planner import mpc
from .rundir import RUNS_ROOT
from .sim import CounterRandom, init_world, run_episode_batch
from .sim.episode import Controller
from .stats import StatsAggregator

__all__ = ["seed_of", "make_worlds", "evaluate_controller", "evaluate_st"]


def seed_of(cfg: Settings) -> int:
    """Integer seed from cfg.SEED (reference main.py:94-100); "Random"
    draws one."""
    if cfg.SEED == "Random":
        return secrets.randbits(31)
    return int(cfg.SEED)


def make_worlds(cfg: Settings, batch: Optional[int] = None,
                dtype=torch.float32, device="cuda"):
    """(worlds, rng): empty worlds and the counter-based draw source seeded
    from cfg.SEED."""
    batch = batch or cfg.BATCH_SCENARIOS
    return init_world(cfg, batch, dtype, device), CounterRandom(seed_of(cfg))


def evaluate_controller(cfg: Settings, controller: Controller,
                        num_episodes: Optional[int] = None,
                        batch: Optional[int] = None,
                        dtype=torch.float32, device="cuda",
                        max_episode_length: float = 100.0,
                        wait_before_start: float = 50.0,
                        verbose: bool = True) -> StatsAggregator:
    """Batched ``evaluate_control`` (reference control.py:343-363): run
    ceil(num_episodes / batch) rounds of lockstep episodes and aggregate the
    per-episode metrics.  The traffic world persists across rounds, like
    the reference's persistent SUMO process."""
    num_episodes = num_episodes or cfg.NUM_EPISODES
    worlds, rng = make_worlds(cfg, batch, dtype, resolve_device(device))
    batch = worlds.ego_arc.shape[0]
    agg = StatsAggregator(cfg)
    rounds = -(-num_episodes // batch)
    crashes, merges = [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        worlds, stats = run_episode_batch(
            worlds, cfg, controller, rng,
            max_episode_length=max_episode_length,
            wait_before_start=wait_before_start)
        if worlds.ego_arc.is_cuda:
            torch.cuda.synchronize(worlds.ego_arc.device)
        wall = time.perf_counter() - t0
        agg.add_batch(stats, wall_clock_seconds=wall)
        crashes.append(stats.crashed.float().mean().item())
        merges.append(stats.merged.float().mean().item())
        if verbose:
            done = min((r + 1) * batch, num_episodes)
            print(f"[{done}/{num_episodes}] "
                  f"crash={sum(crashes) / len(crashes):.4f} "
                  f"merge={sum(merges) / len(merges):.4f} "
                  f"({wall:.1f}s/round)", flush=True)
    return agg


def evaluate_st(cfg: Settings, num_episodes: Optional[int] = None,
                dtype=torch.float32, device="cuda",
                verbose: bool = True) -> StatsAggregator:
    """TASK="ST": pure MPC evaluation (reference st.py:817-824) with the
    production controller: the CUDA kernel on the card, the dense DP on the
    CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # build the kernel before the first round so that no round's wall
        # clock includes the nvcc build
        from .ops import st_kernel
        st_kernel.load_kernel()
    controller = mpc.make_batched_controller(cfg)
    agg = evaluate_controller(cfg, controller, num_episodes, dtype=dtype,
                              device=dev, verbose=verbose)
    run_dir = os.path.join(RUNS_ROOT, cfg.LOG_DIR)
    os.makedirs(run_dir, exist_ok=True)
    agg.save_plots(run_dir)
    if verbose:
        agg.print_stats()
    return agg
