"""Batched episode runtime: warmup, tick loop, per-scenario metrics.

Port of ``rl_mpc_lanemerging_tpu/sim/episode.py`` (reference
control.py:229-363 ``run_episode``/``evaluate_control``).  A batch of B
scenarios advances in lockstep; the JAX package's ``lax.while_loop`` is a
Python loop here that stops once every scenario is done or the tick budget
is spent.  Scenarios that finish early are frozen, including their random
step count, so each behaves as if it ran alone.

Per-tick bookkeeping mirrors control.py:269-318: sensed speed and
acceleration feed running sums, jerk is the difference of sensed
accelerations, the closest-vehicle distance is recorded past CRASH_MIN_S,
and follower disruption collects the trailing car's deceleration.  The
traffic world, spawner countdown included, persists across episodes; each
episode begins with a ``wait_before_start`` warmup of pure traffic before
the ego is inserted at a random start speed (control.py:198-204, 257-258).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import geometry
from .._device import const
from ..config import Settings
from ..prediction import HighwayState, get_closest_cars
from .world import WorldState, add_ego, remove_ego, sense, world_step

__all__ = ["EpisodeStats", "BIN_EDGES", "warmup", "run_episode_batch",
           "Controller", "empty_history", "record_tick"]

# x-histogram bins of the stats aggregator (reference stats.py:33)
BIN_EDGES = np.arange(-220, 61, 20).astype(np.float64)
NUM_BINS = len(BIN_EDGES) - 1

# HighwayState -> speed commands (B,), or -> (speeds, flag (B,)); with a
# carry: (HighwayState, carry) -> (one of those, carry)
Controller = Callable[..., object]


class EpisodeStats(NamedTuple):
    """Per-scenario episode metrics; every field has leading batch shape."""

    crashed: torch.Tensor
    merged: torch.Tensor
    ticks: torch.Tensor             # control ticks (= len(state_history))
    sum_speed: torch.Tensor
    max_speed: torch.Tensor
    sum_abs_jerk: torch.Tensor
    min_closest: torch.Tensor       # inf when never recorded
    sum_closest: torch.Tensor
    n_closest: torch.Tensor
    sum_disruption: torch.Tensor
    max_disruption: torch.Tensor
    n_disruption: torch.Tensor
    n_disruption_nonzero: torch.Tensor
    bin_counts: torch.Tensor        # (B, NUM_BINS)
    bin_jerk: torch.Tensor          # (B, NUM_BINS)
    bin_speed: torch.Tensor         # (B, NUM_BINS)
    bin_aux: torch.Tensor           # (B, NUM_BINS) controller flag per bin
    start_speed: torch.Tensor
    aux_sum: torch.Tensor           # (B,) controller flag accumulator


def _zero_stats(batch: int, dtype, device) -> EpisodeStats:
    def z():
        return torch.zeros((batch,), dtype=dtype, device=device)

    def zi():
        return torch.zeros((batch,), dtype=torch.int32, device=device)

    def zb():
        return torch.zeros((batch, NUM_BINS), dtype=dtype, device=device)

    return EpisodeStats(
        crashed=torch.zeros((batch,), dtype=torch.bool, device=device),
        merged=torch.zeros((batch,), dtype=torch.bool, device=device),
        ticks=zi(), sum_speed=z(), max_speed=z(), sum_abs_jerk=z(),
        min_closest=torch.full((batch,), float("inf"), dtype=dtype,
                               device=device),
        sum_closest=z(), n_closest=zi(), sum_disruption=z(),
        max_disruption=z(), n_disruption=zi(), n_disruption_nonzero=zi(),
        bin_counts=zb(), bin_jerk=zb(), bin_speed=zb(), bin_aux=zb(),
        start_speed=z(), aux_sum=z())


def warmup(world: WorldState, cfg: Settings, ticks: int, rng) -> WorldState:
    """Advance traffic with no ego (control.py:257-258)."""
    for _ in range(ticks):
        world = world_step(world, world.ego_v, cfg, rng)
    return world


def _sample_start_speed(world: WorldState, cfg: Settings, rng):
    """Reference control.py:198-204."""
    dtype = world.ego_v.dtype
    if not cfg.RANDOMIZE_START_SPEED:
        return torch.full_like(world.ego_v, cfg.START_SPEED)
    v = cfg.START_SPEED + cfg.START_SPEED_VARIANCE \
        * rng.start_normal(world.steps, dtype)
    return v.clamp(cfg.MIN_START_SPEED, cfg.MAX_START_SPEED)


def _bin_index(x):
    idx = torch.floor((x - BIN_EDGES[0]) / const(20.0, x)).to(torch.int64)
    return idx.clamp(0, NUM_BINS - 1)


def _tick_metrics(stats: EpisodeStats, state: HighwayState, prev_accel,
                  active, cfg: Settings) -> EpisodeStats:
    """Accumulate one control tick's metrics for active scenarios
    (control.py:280-308 + stats.py:43-74)."""
    dtype = stats.sum_speed.dtype
    speed = state.ego_speed.to(dtype)
    accel = state.ego_accel.to(dtype)
    first = stats.ticks == 0
    jerk = torch.where(first, 0.0,
                       (accel - prev_accel) / const(cfg.TICK_LENGTH, accel))

    ego_s = geometry.get_ego_s(state.ego_x, state.ego_y).to(dtype)
    front, behind = get_closest_cars(state)
    front_x = torch.where(front[3], front[0], float("inf")).to(dtype)
    behind_x = torch.where(behind[3], behind[0], float("inf")).to(dtype)
    behind_decel = torch.where(behind[3],
                               -torch.clamp_max(behind[2], 0.0),
                               0.0).to(dtype)
    min_dist = torch.clamp_max(torch.minimum(
        torch.abs(front_x - state.ego_x), torch.abs(behind_x - state.ego_x)),
        100.0).to(dtype)
    past_merge = ego_s > cfg.MERGE_POINT_X          # quirk kept: s vs x
    rec_closest = active & past_merge & (ego_s > cfg.CRASH_MIN_S)
    rec_disrupt = active & past_merge

    b = _bin_index(state.ego_x.to(dtype))[:, None]
    one = torch.where(active, 1.0, 0.0).to(dtype)[:, None]
    return stats._replace(
        ticks=stats.ticks + active.to(torch.int32),
        sum_speed=stats.sum_speed + torch.where(active, speed, 0.0),
        max_speed=torch.where(active, torch.maximum(stats.max_speed, speed),
                              stats.max_speed),
        sum_abs_jerk=stats.sum_abs_jerk
        + torch.where(active, torch.abs(jerk), 0.0),
        min_closest=torch.where(rec_closest,
                                torch.minimum(stats.min_closest, min_dist),
                                stats.min_closest),
        sum_closest=stats.sum_closest + torch.where(rec_closest, min_dist,
                                                    0.0),
        n_closest=stats.n_closest + rec_closest.to(torch.int32),
        sum_disruption=stats.sum_disruption
        + torch.where(rec_disrupt, behind_decel, 0.0),
        max_disruption=torch.where(
            rec_disrupt, torch.maximum(stats.max_disruption, behind_decel),
            stats.max_disruption),
        n_disruption=stats.n_disruption + rec_disrupt.to(torch.int32),
        n_disruption_nonzero=stats.n_disruption_nonzero
        + (rec_disrupt & (behind_decel != 0.0)).to(torch.int32),
        bin_counts=stats.bin_counts.scatter_add(1, b, one),
        bin_jerk=stats.bin_jerk.scatter_add(
            1, b, one * torch.abs(jerk)[:, None]),
        bin_speed=stats.bin_speed.scatter_add(
            1, b, one * torch.abs(speed)[:, None]))


def _mask_select(mask, new, old):
    m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
    return torch.where(m, new, old)


def _select_world(mask, new: WorldState, old: WorldState) -> WorldState:
    return WorldState(*(_mask_select(mask, a, b) for a, b in zip(new, old)))


def empty_history(state: HighwayState, max_ticks: int) -> HighwayState:
    """A zeroed (B, max_ticks + 1, ...) history of ``state``'s fields, on
    its device: one row per control tick and a scratch row last."""
    batch = state.ego_x.shape[0]
    return HighwayState(*(
        torch.zeros((batch, max_ticks + 1) + x.shape[1:], dtype=x.dtype,
                    device=x.device) for x in state))


def record_tick(history: HighwayState, state: HighwayState,
                active: torch.Tensor, ticks: torch.Tensor) -> None:
    """Write ``state`` into row ``ticks`` of each active scenario's
    history, and into the scratch row of each frozen one (reference
    episode.py: frozen scenarios write row max_ticks).  One indexed write
    per field and no host read."""
    rows = torch.arange(active.shape[0], device=active.device)
    idx = torch.where(active, ticks,
                      history.ego_x.shape[1] - 1).to(torch.int64)
    for h, x in zip(history, state):
        h.index_put_((rows, idx), x)


def run_episode_batch(world: WorldState, cfg: Settings,
                      controller: Controller, rng,
                      max_episode_length: float = 100.0,
                      wait_before_start: float = 50.0,
                      record_history: bool = False,
                      controller_carry=None):
    """One full episode for every scenario in the batch.

    Returns (world_after, EpisodeStats).  The loop runs until every
    scenario has terminated (arrival / collision / tick budget); scenarios
    that finish early are frozen.  ``rng`` is the draw source
    (``sim/rng.py``).

    ``record_history``: also return the sensed ``HighwayState`` of every
    control tick as a (B, max_ticks + 1, ...) history on the device (the
    crash-forensics capture; reference control.py:280-281 state_history +
    stats.py:75-77 crash pickling): row t of scenario b is the state sensed
    at its control tick t, and a frozen scenario writes the scratch row
    ``max_ticks``.  The return is then (world_after, EpisodeStats,
    history).

    A controller may return ``(speed, flag)`` in place of the speeds alone:
    the flag (B,) of active scenarios is summed into ``aux_sum`` and into
    ``bin_aux`` at the ego's x-bin (the takeover-vs-x histogram, reference
    dqn.py:215-226).

    ``controller_carry``: optional per-scenario controller state; when
    given, ``controller`` is called as ``controller(state, carry) -> (out,
    carry)``, the carry persists across ticks and, handed back in by the
    caller, across rounds (like the reference's ``takeover_history``,
    dqn.py:126-127, which is never reset), and it is returned last:
    (world_after, EpisodeStats[, history], carry).
    """
    batch = world.ego_arc.shape[0]
    dtype = world.ego_arc.dtype
    device = world.ego_arc.device
    max_ticks = int(max_episode_length / cfg.TICK_LENGTH)
    warm_ticks = int(wait_before_start / cfg.TICK_LENGTH)

    world = warmup(world, cfg, warm_ticks, rng)
    start_speeds = _sample_start_speed(world, cfg, rng)
    world = add_ego(world, start_speeds)
    # the insertion step (control.py:264): ego holds its depart speed
    world = world_step(world, start_speeds, cfg, rng)

    stats = _zero_stats(batch, dtype, device)._replace(
        start_speed=start_speeds)
    prev_a = torch.zeros((batch,), dtype=dtype, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    history = (empty_history(sense(world, cfg), max_ticks)
               if record_history else None)
    tick = 1
    while tick <= max_ticks and not bool(done.all()):
        arrived = world.ego_arrived & ~done
        collided = world.ego_collided & ~done
        stats = stats._replace(merged=stats.merged | arrived,
                               crashed=stats.crashed | collided)
        done = done | arrived | collided
        active = ~done

        state = sense(world, cfg)
        if history is not None:
            record_tick(history, state, active, stats.ticks)
        stats = _tick_metrics(stats, state, prev_a, active, cfg)
        prev_a = torch.where(active, state.ego_accel.to(dtype), prev_a)

        if controller_carry is not None:
            out, controller_carry = controller(state, controller_carry)
        else:
            out = controller(state)
        if isinstance(out, tuple):
            speed_cmd, aux = out
            aux_on = torch.where(active, aux.to(dtype), 0.0)
            bi = _bin_index(state.ego_x.to(dtype))[:, None]
            stats = stats._replace(
                aux_sum=stats.aux_sum + aux_on,
                bin_aux=stats.bin_aux.scatter_add(1, bi, aux_on[:, None]))
        else:
            speed_cmd = out
        speed_cmd = speed_cmd.to(dtype)
        # frozen scenarios coast (their world is masked below anyway)
        speed_cmd = torch.where(active, speed_cmd, world.ego_v)
        world = _select_world(active, world_step(world, speed_cmd, cfg, rng),
                              world)
        tick += 1

    # tick-budget overrun: remove ego, not merged, not crashed
    # (control.py:312-316)
    world = _select_world(~done, remove_ego(world), world)
    out = (world, stats) if history is None else (world, stats, history)
    if controller_carry is not None:
        out = out + (controller_carry,)
    return out
