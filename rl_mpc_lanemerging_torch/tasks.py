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
from typing import Callable, Optional

import torch

from ._device import resolve_device
from .config import Settings
from .planner import mpc
from .rundir import RUNS_ROOT
from .sim import CounterRandom, init_world, run_episode_batch
from .sim.episode import Controller
from .stats import StatsAggregator

__all__ = ["seed_of", "make_worlds", "evaluate_controller", "evaluate_st",
           "report"]


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
                        verbose: bool = True,
                        custom_stats: Optional[Callable] = None,
                        save_state_on_crash: bool = False,
                        run_dir: str = ".",
                        controller_carry=None) -> StatsAggregator:
    """Batched ``evaluate_control`` (reference control.py:343-363): run
    ceil(num_episodes / batch) rounds of lockstep episodes and aggregate the
    per-episode metrics.  The traffic world persists across rounds, like
    the reference's persistent SUMO process.

    ``custom_stats``: EpisodeStats -> dict of per-episode arrays, aggregated
    beside the standard columns.  ``controller_carry``: per-scenario state
    of a stateful controller (``run_episode_batch``), threaded through every
    round.  ``save_state_on_crash``: record every tick's sensed state and
    pickle each crashing episode's history under ``run_dir``
    (``forensics.dump_crashes``, tagged ``r<round>_``)."""
    num_episodes = num_episodes or cfg.NUM_EPISODES
    worlds, rng = make_worlds(cfg, batch, dtype, resolve_device(device))
    batch = worlds.ego_arc.shape[0]
    agg = StatsAggregator(cfg)
    rounds = -(-num_episodes // batch)
    crashes, merges = [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        out = run_episode_batch(
            worlds, cfg, controller, rng,
            max_episode_length=max_episode_length,
            wait_before_start=wait_before_start,
            record_history=save_state_on_crash,
            controller_carry=controller_carry)
        if controller_carry is not None:
            controller_carry = out[-1]
        worlds, stats = out[:2]
        if worlds.ego_arc.is_cuda:
            torch.cuda.synchronize(worlds.ego_arc.device)
        wall = time.perf_counter() - t0
        # the history leaves the device only when a scenario crashed
        if save_state_on_crash and bool(stats.crashed.any()):
            from .forensics import dump_crashes
            dump_crashes(stats, out[2], run_dir=run_dir, tag=f"r{r}_")
        agg.add_batch(stats, wall_clock_seconds=wall,
                      custom=custom_stats(stats) if custom_stats else None)
        crashes.append(stats.crashed.float().mean().item())
        merges.append(stats.merged.float().mean().item())
        if verbose:
            done = min((r + 1) * batch, num_episodes)
            print(f"[{done}/{num_episodes}] "
                  f"crash={sum(crashes) / len(crashes):.4f} "
                  f"merge={sum(merges) / len(merges):.4f} "
                  f"({wall:.1f}s/round)", flush=True)
    return agg


def report(agg: StatsAggregator, cfg: Settings, verbose: bool) -> None:
    """Save the run's plots under its run directory and print the stats."""
    run_dir = os.path.join(RUNS_ROOT, cfg.LOG_DIR)
    os.makedirs(run_dir, exist_ok=True)
    agg.save_plots(run_dir)
    if verbose:
        agg.print_stats()


def evaluate_st(cfg: Settings, num_episodes: Optional[int] = None,
                dtype=torch.float32, device="cuda",
                verbose: bool = True) -> StatsAggregator:
    """TASK="ST": pure MPC evaluation (reference st.py:817-824) with the
    production controller: the CUDA kernel on the card, the dense DP on the
    CPU.  Crashing episodes are dumped to ``runs_torch/<LOG_DIR>`` for
    offline replay (reference st.py:822-824 evaluate_st_and_dump_crash)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # build the kernel before the first round so that no round's wall
        # clock includes the nvcc build
        from .ops import st_kernel
        st_kernel.load_kernel()
    controller = mpc.make_batched_controller(cfg)
    agg = evaluate_controller(cfg, controller, num_episodes, dtype=dtype,
                              device=dev, verbose=verbose,
                              save_state_on_crash=True,
                              run_dir=os.path.join(RUNS_ROOT, cfg.LOG_DIR))
    report(agg, cfg, verbose)
    return agg
