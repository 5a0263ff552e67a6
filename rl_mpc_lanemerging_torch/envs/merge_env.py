"""Batched, asynchronously resetting RL environment over the merge world.

Port of ``rl_mpc_lanemerging_tpu/envs/merge_env.py`` (reference
merge_gym.py:15-246 ``JerkEnv`` / ``AccelerationEnv`` /
``ContinuousJerkEnv``).  B scenarios run in lockstep and each manages its
own episode phase: a per-scenario warmup countdown replaces the blocking
``reset``-time warmup loop (merge_gym.py:142-149), so finished scenarios
re-enter warmup while the others keep training.

Action semantics replicated:

* discrete jerk (5 actions) and continuous jerk: clamp the projected
  acceleration/speed and record the invalid-action penalty + projected
  jerk (merge_gym.py:83-96 ``_handle_jerk``), then actuate through the
  jerk->speed integrator (control.py:160-179 ``set_ego_jerk``);
* discrete acceleration (20 actions): jerk-clamped acceleration targets
  actuated as speed commands (merge_gym.py:193-213);
* rewards come from the *next* sensed state with the sensed jerk
  (merge_gym.py:128-140); a crash or an arrival takes its terminal reward
  (merge_gym.py:108-117);
* episodes end on collision, arrival, or the tick budget
  (merge_gym.py:118-126); the ego is removed on timeout.

The world's draws come from a source object (``sim/rng.py``).  Every tick
``env_step`` asks it for the world step's draws and then, for every
scenario, for a start-speed normal at the new step count, used where a
scenario spawns its ego: the order in which the JAX world splits its key.
``env_step`` never reads a tensor on the host.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from .._device import const
from ..config import Settings
from ..prediction import HighwayState
from ..rl.obs import state_vector
from ..rl.rewards import get_reward_function
from ..sim.episode import _select_world
from ..sim.world import WorldState, add_ego, remove_ego, sense, world_step

__all__ = ["EnvKind", "MergeEnvState", "env_reset", "env_step"]


class EnvKind(str, enum.Enum):
    JERK = "jerk"                # sumo-jerk-v0
    ACCELERATION = "accel"       # sumo-accel-v0
    CONTINUOUS_JERK = "jerk-continuous"  # sumo-jerk-continuous-v0


class MergeEnvState(NamedTuple):
    world: WorldState            # batched
    prev_accel: torch.Tensor     # (B,) previous sensed ego acceleration
    ticks: torch.Tensor          # (B,) int32 control ticks this episode
    warmup_left: torch.Tensor    # (B,) int32 ticks of traffic-only warmup
    obs: torch.Tensor            # (B, D) current observation
    state: HighwayState          # batched sensed state


def env_reset(world: WorldState, cfg: Settings,
              wait_before_start: float = 20.0) -> MergeEnvState:
    """Start every scenario in its warmup phase."""
    b = world.ego_arc.shape[0]
    dtype, device = world.ego_arc.dtype, world.ego_arc.device
    warm = int(wait_before_start / cfg.TICK_LENGTH)
    return MergeEnvState(
        world=world,
        prev_accel=torch.zeros((b,), dtype=dtype, device=device),
        ticks=torch.zeros((b,), dtype=torch.int32, device=device),
        warmup_left=torch.full((b,), warm, dtype=torch.int32, device=device),
        obs=torch.zeros((b, cfg.obs_dim), dtype=dtype, device=device),
        state=sense(world, cfg))


def _apply_action(env: MergeEnvState, action, cfg: Settings,
                  kind: EnvKind):
    """-> (speed_command, projected_jerk, invalid_penalty)."""
    dtype = env.world.ego_arc.dtype
    device = env.world.ego_arc.device
    dt = cfg.TICK_LENGTH
    dtc = const(dt, env.world.ego_arc)
    v = env.state.ego_speed.to(dtype)
    a = env.state.ego_accel.to(dtype)
    penalty_rate = cfg.INVALID_ACTION_PENALTY * dt

    def penalty(invalid):
        return torch.where(invalid, torch.full_like(v, penalty_rate), 0.0)

    if kind == EnvKind.ACCELERATION:
        table = torch.tensor(cfg.ACCELERATION_VALUES_DQN, dtype=dtype,
                             device=device)
        proj_a = table[action]
        proj_v = v + proj_a * dt
        proj_jerk = (proj_a - env.prev_accel) / dtc
        jerk_hi = proj_jerk > cfg.MAXIMUM_POSITIVE_JERK
        jerk_lo = proj_jerk < cfg.MINIMUM_NEGATIVE_JERK
        speed_bad = (proj_v > cfg.MAX_SPEED) | (proj_v < 0.0)
        invalid = jerk_hi | jerk_lo | speed_bad
        # jerk-clamped branches actuate through set_ego_jerk
        jerk_cmd = torch.clamp(proj_jerk, cfg.MINIMUM_NEGATIVE_JERK,
                               cfg.MAXIMUM_POSITIVE_JERK)
        new_a = torch.clamp(a + jerk_cmd * dt, cfg.MAX_NEGATIVE_ACCELERATION,
                            cfg.MAX_POSITIVE_ACCELERATION)
        speed_from_jerk = torch.clamp(v + new_a * dt, 0.0, cfg.MAX_SPEED)
        clipped_v = torch.clamp(proj_v, 0.0, cfg.MAX_SPEED)
        recomputed_a = (clipped_v - v) / dtc
        out_jerk = torch.where(
            jerk_hi, cfg.MAXIMUM_POSITIVE_JERK,
            torch.where(jerk_lo, cfg.MINIMUM_NEGATIVE_JERK,
                        torch.where(speed_bad,
                                    (recomputed_a - env.prev_accel) / dtc,
                                    proj_jerk)))
        speed_cmd = torch.where(jerk_hi | jerk_lo, speed_from_jerk,
                                clipped_v)
        return speed_cmd, out_jerk, penalty(invalid)

    if kind == EnvKind.JERK:
        table = torch.tensor(cfg.JERK_VALUES_DQN, dtype=dtype, device=device)
        jerk = table[action]
    else:
        jerk = torch.as_tensor(action, device=device).to(dtype).reshape(
            v.shape)

    # _handle_jerk (merge_gym.py:83-96): projections use prev sensed accel
    proj_a = env.prev_accel + jerk * dt
    proj_v = v + proj_a * dt
    accel_bad = (proj_a > cfg.MAX_POSITIVE_ACCELERATION) \
        | (proj_a < cfg.MAX_NEGATIVE_ACCELERATION)
    proj_a_cl = torch.clamp(proj_a, cfg.MAX_NEGATIVE_ACCELERATION,
                            cfg.MAX_POSITIVE_ACCELERATION)
    speed_bad = ~accel_bad & ((proj_v > cfg.MAX_SPEED) | (proj_v < 0.0))
    proj_v_cl = torch.clamp(proj_v, 0.0, cfg.MAX_SPEED)
    proj_a_final = torch.where(speed_bad, (proj_v_cl - v) / dtc, proj_a_cl)
    proj_jerk = (proj_a_final - env.prev_accel) / dtc
    invalid = accel_bad | speed_bad
    # actuation = set_ego_jerk from *sensed* accel (control.py:174-179)
    new_a = torch.clamp(a + jerk * dt, cfg.MAX_NEGATIVE_ACCELERATION,
                        cfg.MAX_POSITIVE_ACCELERATION)
    speed_cmd = torch.clamp(v + new_a * dt, 0.0, cfg.MAX_SPEED)
    return speed_cmd, proj_jerk, penalty(invalid)


def _start_speed(z: torch.Tensor, cfg: Settings) -> torch.Tensor:
    """Reference control.py:198-204 from a standard normal draw ``z``."""
    if not cfg.RANDOMIZE_START_SPEED:
        return torch.full_like(z, cfg.START_SPEED)
    v = cfg.START_SPEED + cfg.START_SPEED_VARIANCE * z
    return torch.clamp(v, cfg.MIN_START_SPEED, cfg.MAX_START_SPEED)


def env_step(env: MergeEnvState, action, cfg: Settings, rng,
             kind: EnvKind = EnvKind.CONTINUOUS_JERK,
             max_episode_length: float = 100.0,
             wait_before_start: float = 20.0):
    """One batched env tick with asynchronous auto-reset; ``rng`` is the
    world's draw source.

    Returns (env', transition) where transition carries (obs, action,
    reward, next_obs, terminal, done, valid, collided, arrived, spawn_now):
    ``valid`` is False for scenarios in warmup (no learnable transition this
    tick)."""
    dtype = env.world.ego_arc.dtype
    max_ticks = int(max_episode_length / cfg.TICK_LENGTH)
    warm = int(wait_before_start / cfg.TICK_LENGTH)
    reward_fn = get_reward_function(cfg)

    in_warmup = env.warmup_left > 0
    running = ~in_warmup

    speed_cmd, proj_jerk, invalid_penalty = _apply_action(
        env, action, cfg, kind)
    # warmup scenarios coast their (absent) ego
    speed_cmd = torch.where(running, speed_cmd, env.world.ego_v)

    world = world_step(env.world, speed_cmd, cfg, rng)

    collided = running & world.ego_collided
    arrived = running & world.ego_arrived
    ticks = env.ticks + running.to(torch.int32)
    timeout = running & ~collided & ~arrived & (ticks >= max_ticks)
    done = collided | arrived | timeout

    next_states = sense(world, cfg)
    next_obs = state_vector(next_states, cfg)
    jerk_sensed = (next_states.ego_accel.to(dtype) - env.prev_accel) \
        / const(cfg.TICK_LENGTH, env.prev_accel)

    # rewards (merge_gym.py:108-140).  The JAX package scores a crash or an
    # arrival on an empty state with the projected jerk; a family returns
    # its constant there whatever the state, so one call on the sensed
    # state gives the same rewards.
    terminal = collided | arrived
    reward = reward_fn(next_states, torch.where(terminal, proj_jerk,
                                                jerk_sensed),
                       collided, arrived, cfg) + invalid_penalty
    obs_out = torch.where(terminal[:, None], torch.zeros_like(next_obs),
                          next_obs)

    # --- async reset bookkeeping ---
    # timeout removes the ego (merge_gym.py:124-125); all done scenarios
    # re-enter warmup
    world = _select_world(done, remove_ego(world), world)
    warmup_left = torch.where(done, warm,
                              torch.clamp_min(env.warmup_left - 1, 0)
                              ).to(torch.int32)
    # scenarios whose warmup just finished get their ego inserted; the
    # start-speed draw is made for every scenario, as the JAX world splits
    # every key
    spawn_now = in_warmup & (env.warmup_left == 1)
    start_speed = _start_speed(rng.start_normal(world.steps, dtype), cfg)
    world = _select_world(spawn_now, add_ego(world, start_speed), world)

    transition = dict(obs=env.obs, action=action, reward=reward,
                      next_obs=obs_out, terminal=terminal, done=done,
                      valid=running, collided=collided, arrived=arrived,
                      spawn_now=spawn_now)

    states2 = sense(world, cfg)
    reset = done | spawn_now
    env2 = MergeEnvState(
        world=world,
        prev_accel=torch.where(reset, 0.0,
                               torch.where(running,
                                           next_states.ego_accel.to(dtype),
                                           env.prev_accel)),
        ticks=torch.where(reset, 0, ticks).to(torch.int32),
        warmup_left=warmup_left,
        obs=state_vector(states2, cfg),
        state=states2)
    return env2, transition
