"""Task runners: the batched equivalents of the reference's experiment loops.

Port of ``rl_mpc_lanemerging_tpu/tasks.py`` (reference main.py:16-40 and
control.py:343-363 ``evaluate_control``): a batch of scenarios runs per
round and the host only aggregates statistics between rounds.  In a run of
several ranks (``parallel/sharded.py``) the batch is split over them and
rank 0 alone aggregates.
"""

from __future__ import annotations

import os
import secrets
import time
from typing import Callable, Optional

import torch

from . import tracing
from ._device import resolve_device
from .config import Settings
from .planner import mpc
from .rundir import RUNS_ROOT
from .sim import CounterRandom, init_world
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
                dtype=torch.float32, device="cuda", offset: int = 0):
    """(worlds, rng): empty worlds and the counter-based draw source seeded
    from cfg.SEED, whose row i draws as global scenario ``offset + i`` (a
    rank's shard passes its first scenario)."""
    batch = batch or cfg.BATCH_SCENARIOS
    return (init_world(cfg, batch, dtype, device),
            CounterRandom(seed_of(cfg), offset))


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
                        controller_carry=None,
                        mesh="auto") -> Optional[StatsAggregator]:
    """Batched ``evaluate_control`` (reference control.py:343-363): run
    ceil(num_episodes / batch) rounds of lockstep episodes and aggregate the
    per-episode metrics.  The traffic world persists across rounds, like
    the reference's persistent SUMO process.

    ``custom_stats``: EpisodeStats -> dict of per-episode arrays, aggregated
    beside the standard columns.  ``controller_carry``: per-scenario state
    of a stateful controller (``run_episode_batch``), threaded through every
    round.  ``save_state_on_crash``: record every tick's sensed state and
    pickle each crashing episode's history under ``run_dir``
    (``forensics.dump_crashes``, tagged ``r<round>_``).

    ``mesh``: the scenario mesh of a run of several ranks
    (``parallel/sharded.py``); "auto" takes every rank of the process group
    when there is more than one, None runs this process alone.  On a mesh
    the batch is padded to a multiple of the ranks, rank r runs global
    scenarios ``[r * b, (r + 1) * b)`` with their own draws (a global
    ``controller_carry`` is split the same way), and every rank's stats
    reach rank 0 in global scenario order.  Rank 0 alone aggregates and
    prints, and takes each round's wall time as the slowest rank's; every
    rank dumps its own crashes, tagged ``r<round>_rank<r>_``.  Returns the
    aggregator on rank 0 and None on the other ranks."""
    from .parallel import sharded
    num_episodes = num_episodes or cfg.NUM_EPISODES
    batch = batch or cfg.BATCH_SCENARIOS
    dev = resolve_device(device)
    if mesh == "auto":
        mesh = sharded.auto_mesh(dev.type)
    run = sharded.sharded_episode_runner(
        cfg, controller, max_episode_length=max_episode_length,
        wait_before_start=wait_before_start,
        record_history=save_state_on_crash)
    rank, local = 0, batch
    if mesh is not None:
        from .parallel.mesh import padded_batch, shard_batch
        _, rank, n = sharded.axis_group(mesh)
        batch = padded_batch(batch, mesh)
        local = batch // n
        if controller_carry is not None:
            controller_carry = shard_batch(controller_carry, mesh)
    worlds, rng = make_worlds(cfg, local, dtype, dev, offset=rank * local)
    agg = StatsAggregator(cfg) if rank == 0 else None
    rounds = -(-num_episodes // batch)
    crashes, merges = [], []
    for r in range(rounds):
        tracing.set_round(r)
        t0 = time.perf_counter()
        out = run(worlds, rng, controller_carry=controller_carry)
        if controller_carry is not None:
            controller_carry = out[-1]
        worlds, stats = out[:2]
        if worlds.ego_arc.is_cuda:
            torch.cuda.synchronize(worlds.ego_arc.device)
        wall = time.perf_counter() - t0
        # the history leaves the device only when a scenario crashed
        if save_state_on_crash and bool(stats.crashed.any()):
            from .forensics import dump_crashes
            tag = f"r{r}_" if mesh is None else f"r{r}_rank{rank}_"
            dump_crashes(stats, out[2], run_dir=run_dir, tag=tag)
        if mesh is not None:
            shards = sharded.gather_objects((stats, wall), mesh)
            if rank != 0:
                continue
            stats = sharded.cat_batches([s for s, _ in shards])
            wall = max(w for _, w in shards)
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


def report(agg: Optional[StatsAggregator], cfg: Settings,
           verbose: bool) -> None:
    """Save the run's plots under its run directory and print the stats
    (nothing on a rank other than 0, whose aggregator is None)."""
    if agg is None:
        return
    run_dir = os.path.join(RUNS_ROOT, cfg.LOG_DIR)
    os.makedirs(run_dir, exist_ok=True)
    agg.save_plots(run_dir)
    if verbose:
        agg.print_stats()


def evaluate_st(cfg: Settings, num_episodes: Optional[int] = None,
                dtype=torch.float32, device="cuda",
                verbose: bool = True, mesh="auto"
                ) -> Optional[StatsAggregator]:
    """TASK="ST": pure MPC evaluation (reference st.py:817-824) with the
    production controller: the CUDA kernel on the card, the dense DP on the
    CPU.  Crashing episodes are dumped to ``runs_torch/<LOG_DIR>`` for
    offline replay (reference st.py:822-824 evaluate_st_and_dump_crash).
    ``mesh`` as in :func:`evaluate_controller`: each rank runs its shard of
    the batch."""
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
                              run_dir=os.path.join(RUNS_ROOT, cfg.LOG_DIR),
                              mesh=mesh)
    report(agg, cfg, verbose)
    return agg
