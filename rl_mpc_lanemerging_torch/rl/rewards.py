"""Reward families, selected by cfg.REWARD_FUNCTION.

Port of ``rl_mpc_lanemerging_tpu/rl/rewards.py``, written for a whole batch
where the JAX package maps one scenario under ``vmap``:

* "Slotted"       — reference rl.py:168-174
* "Slotted Jerk"  — reference dqn.py:557-563 (used by every paper config)
* "Continuous"    — reference dqn.py:463-505
* "ST"            — reference dqn.py:508-554 (mirror of the solver cost)

Each has signature ``reward(state, jerk, crashed, arrived, cfg)`` on a
batched ``HighwayState`` and (B,) tensors; crashed/arrived are booleans for
*this* transition.
"""

from __future__ import annotations

import torch

from .. import geometry
from ..config import Settings
from ..prediction import HighwayState, get_closest_cars

__all__ = ["get_reward_function", "slotted_reward",
           "slotted_reward_with_jerk", "continuous_reward", "st_reward"]


def _outcome(live, crashed, arrived, crash_value, success_value):
    return torch.where(crashed, crash_value,
                       torch.where(arrived, success_value, live))


def slotted_reward(state: HighwayState, jerk, crashed, arrived,
                   cfg: Settings):
    live = torch.full_like(jerk, cfg.TIME_REWARD * cfg.TICK_LENGTH)
    return _outcome(live, crashed, arrived, float(cfg.CRASH_REWARD),
                    float(cfg.SUCCESS_REWARD))


def slotted_reward_with_jerk(state: HighwayState, jerk, crashed, arrived,
                             cfg: Settings):
    live = cfg.TIME_REWARD * cfg.TICK_LENGTH \
        - cfg.ALT_J_WEIGHT * jerk ** 2 * cfg.TICK_LENGTH
    return _outcome(live, crashed, arrived, float(cfg.CRASH_REWARD),
                    float(cfg.SUCCESS_REWARD))


def _closest_gap_metrics(state: HighwayState, cfg: Settings):
    """(min bumper distance with inf-when-absent semantics, s>0 gate)."""
    front, behind = get_closest_cars(state)
    front_dist = torch.where(front[3],
                             front[0] - state.ego_x - cfg.CAR_LENGTH,
                             float("inf"))
    back_dist = torch.where(behind[3],
                            state.ego_x - behind[0] - cfg.CAR_LENGTH,
                            float("inf"))
    min_dist = torch.minimum(front_dist, back_dist)
    ego_s = geometry.get_ego_s(state.ego_x, state.ego_y)
    return min_dist, ego_s > 0


def continuous_reward(state: HighwayState, jerk, crashed, arrived,
                      cfg: Settings):
    """Weighted smooth/safe/efficient shaping (dqn.py:463-505)."""
    smooth = -torch.abs(jerk) * cfg.TICK_LENGTH
    min_dist, past_merge = _closest_gap_metrics(state, cfg)
    safety = torch.where(min_dist < cfg.MIN_FOLLOW_DISTANCE, -1.0,
                         torch.where(torch.isfinite(min_dist),
                                     -1.0 / min_dist, 0.0))
    safety = torch.where(past_merge, safety * cfg.TICK_LENGTH, 0.0)
    efficiency = -cfg.TICK_LENGTH * torch.abs(state.ego_speed
                                              - cfg.DESIRED_SPEED)
    live = (cfg.WT_SMOOTH * smooth + cfg.WT_SAFE * safety
            + cfg.WT_EFFICIENT * efficiency)
    return _outcome(live, crashed, arrived, -10.0, 10.0)


def st_reward(state: HighwayState, jerk, crashed, arrived, cfg: Settings):
    """Mirror of the ST solver cost (dqn.py:508-554)."""
    tick = cfg.TICK_LENGTH
    jerk_m = -jerk ** 2 * tick
    speed_m = -tick * (state.ego_speed - cfg.DESIRED_SPEED) ** 2
    accel_m = -tick * state.ego_accel ** 2
    min_dist, past_merge = _closest_gap_metrics(state, cfg)
    dist_m = torch.where(
        min_dist < cfg.MIN_FOLLOW_DISTANCE,
        -2.0 / torch.clamp_min(min_dist, 1.0),
        torch.where(torch.isfinite(min_dist), -1.0 / min_dist, 0.0))
    dist_m = torch.where(past_merge, dist_m * tick, 0.0)
    live = (cfg.ALT_A_WEIGHT * accel_m + cfg.ALT_D_WEIGHT * dist_m
            + cfg.ALT_J_WEIGHT * jerk_m + cfg.ALT_V_WEIGHT * speed_m)
    return _outcome(live, crashed, arrived, -10.0, 10.0)


_REWARDS = {
    "Continuous": continuous_reward,
    "Slotted": slotted_reward,
    "Slotted Jerk": slotted_reward_with_jerk,
    "ST": st_reward,
}


def get_reward_function(cfg: Settings):
    """Dispatch mirroring reference dqn.py:449-460."""
    try:
        return _REWARDS[cfg.REWARD_FUNCTION]
    except KeyError:
        raise ValueError("Invalid reward function {} specified in settings."
                         .format(cfg.REWARD_FUNCTION)) from None
