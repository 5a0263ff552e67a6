"""Vectorized merge-world simulator and batched episode runtime."""

from .world import WorldState, init_world, world_step, sense, add_ego, \
    remove_ego
from .episode import EpisodeStats, run_episode_batch, warmup
from .rng import CounterRandom, StepDraws

__all__ = ["WorldState", "init_world", "world_step", "sense", "add_ego",
           "remove_ego", "EpisodeStats", "run_episode_batch", "warmup",
           "CounterRandom", "StepDraws"]
