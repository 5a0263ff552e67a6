"""The RL+MPC arbiter (the paper's dqn.py:117-200 ``do_combined_control``)
with the DDPG actor (ddpg.py:83-87) and its observation vector
(dqn.py:389-446).

The actor's weights are read from the raw ``.npz`` file of the trained
network (Flax layout: ``actor/Dense_<i>/kernel`` (in, out) and ``bias``),
which the program reads too; nothing the program built from it is used.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import planner
from .forecast import State, const, ego_s, matmul, predict_with_ego

__all__ = ["Actor", "Decision", "observation", "decide"]


class Decision(NamedTuple):
    """One tick of the arbiter, each (B,)."""
    speed: torch.Tensor     # the command
    take: torch.Tensor      # the planner takes over
    plan: torch.Tensor      # the plan's first-step speed command
    rl_speed: torch.Tensor  # the actor's
    gate_a: torch.Tensor    # the rollout predicts a crash
    gate_b: torch.Tensor    # its speed exceeds DESIRED_SPEED
    gate_c: torch.Tensor    # the certificate condemns its test state
    gate_d: torch.Tensor    # the plan is strictly better


class Actor:
    """obs (B, obs_dim) -> jerk (B,): three dense layers, ReLU, ReLU, then
    tanh scaled to [low, high]."""

    def __init__(self, npz_path: str, low: float, high: float, device):
        with np.load(npz_path) as data:
            self.layers = [
                (torch.as_tensor(data[f"actor/Dense_{i}/kernel"]).to(
                    device=device, dtype=torch.float32),
                 torch.as_tensor(data[f"actor/Dense_{i}/bias"]).to(
                    device=device, dtype=torch.float32))
                for i in range(3)]
        self.mid = 0.5 * (high + low)
        self.half = 0.5 * (high - low)

    def __call__(self, obs, tf32: bool = False):
        x = obs
        for i, (kernel, bias) in enumerate(self.layers):
            x = matmul(x, kernel, tf32) + bias
            if i < 2:
                x = torch.relu(x)
        return self.mid + self.half * torch.tanh(x)[:, 0]


def _nearest(state: State, ahead: bool, count: int):
    dx = state.other_x - state.ego_x[:, None]
    if ahead:
        mask = state.other_present & (dx > 0)
        key = torch.where(mask, dx, float("inf"))
    else:
        mask = state.other_present & ~(dx > 0)
        key = torch.where(mask, -dx, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)[:, :count]
    return order, torch.gather(mask, 1, order)


def observation(state: State, p):
    """[front_1.., back_1.., ego]: per car (accel/9, (v - v_ego)/MAX_SPEED,
    (x - x_ego)/SENSOR_RADIUS, present), nearest first; ego (v/MAX_SPEED,
    a/9, x/300, y/100)."""
    dtype = state.ego_speed.dtype
    norm = p.NORMALIZE_VECTOR_INPUT

    def cars(order, ok):
        x = torch.where(ok, torch.gather(state.other_x, 1, order)
                        - state.ego_x[:, None], 0.0)
        v = torch.gather(state.other_speed, 1, order)
        if p.USE_SPEED_DIFFERENCE:
            v = v - state.ego_speed[:, None]
        v = torch.where(ok, v, 0.0)
        cols = []
        if p.USE_ACCELERATION_OF_OTHER_CARS:
            a = torch.where(ok, torch.gather(state.other_accel, 1, order),
                            0.0)
            cols.append(a / const(9.0, a) if norm else a)
        if norm:
            v = v / const(p.MAX_SPEED, v)
            x = x / const(p.SENSOR_RADIUS, x)
        cols.extend([v, x, ok.to(dtype)])
        return torch.stack(cols, dim=-1).flatten(1)

    front = cars(*_nearest(state, True, p.CARS_AHEAD))
    back = cars(*_nearest(state, False, p.CARS_BEHIND))
    ego = torch.stack([state.ego_speed, state.ego_accel, state.ego_x,
                       state.ego_y], dim=1)
    if norm:
        ego = ego / torch.tensor([p.MAX_SPEED, 9.0, 300.0, 100.0],
                                 dtype=ego.dtype, device=ego.device)
    return torch.cat([front, back, ego], dim=1).to(dtype)


def _speed_from_jerk(v, a, jerk, p):
    """control.py:160-171."""
    new_a = torch.clamp(a + jerk * p.TICK_LENGTH, p.MAX_NEGATIVE_ACCELERATION,
                        p.MAX_POSITIVE_ACCELERATION)
    return torch.clamp(v + new_a * p.TICK_LENGTH, 0.0, p.MAX_SPEED)


def _rollout(policy, state: State, first_jerk, p):
    """dqn.py:129-143: ROLLOUT_LENGTH virtual steps, the policy asked again
    each step; a scenario stops after a predicted crash or past STOP_X.
    Returns (s history, recorded points, crash, last speed, test state)."""
    steps = max(p.ROLLOUT_LENGTH, 1)
    b = state.ego_speed.shape[0]
    device = state.ego_speed.device
    stopped = torch.zeros((b,), dtype=torch.bool, device=device)
    crash = torch.zeros((b,), dtype=torch.bool, device=device)
    last_speed = torch.zeros_like(state.ego_speed)
    st, test = state, state
    jerk = first_jerk
    s_hist = [ego_s(state.ego_x, state.ego_y)]
    valid = [torch.ones((b,), dtype=torch.bool, device=device)]
    for i in range(1, steps + 1):
        if i != 1:
            jerk = policy(st)
        sel = _speed_from_jerk(st.ego_speed, st.ego_accel, jerk, p)
        nxt, crashed = predict_with_ego(st, sel, p.TICK_LENGTH, p,
                                        p.COMBINATION_MIN_DISTANCE)
        nxt = State(*(torch.where(
            stopped.reshape((b,) + (1,) * (new.dim() - 1)), old, new)
            for new, old in zip(nxt, st)))
        last_speed = torch.where(stopped, last_speed, sel)
        crash = crash | (~stopped & crashed)
        s_hist.append(ego_s(nxt.ego_x, nxt.ego_y))
        valid.append(~stopped)
        if i == p.ST_TEST_ROLLOUTS:
            test = nxt
        stopped = stopped | crash | (nxt.ego_x > p.STOP_X)
        st = nxt
    if p.ST_TEST_ROLLOUTS > steps or p.ST_TEST_ROLLOUTS < 1:
        test = st
    valid_m = torch.stack(valid, dim=1)
    hist = torch.where(valid_m, torch.stack(s_hist, dim=1), 0.0)
    return hist, valid_m.sum(dim=1), crash, last_speed, test


def _mean_abs_jerk(seq, length, v0, a0, delta_t):
    """st.py:274-288 over the first ``length`` points."""
    n = seq.shape[1]
    dt = const(delta_t, seq)
    v = torch.diff(seq, dim=1) / dt
    a = (v - torch.cat([v0[:, None], v[:, :-1]], dim=1)) / dt
    j = (a - torch.cat([a0[:, None], a[:, :-1]], dim=1)) / dt
    steps = torch.arange(1, n, device=seq.device)
    mask = steps[None, :] <= (length[:, None] - 1)
    return torch.sum(torch.where(mask, torch.abs(j), 0.0), dim=1) \
        / torch.clamp_min(length - 1, 1)


def decide(actor: Actor, state: State, p, last_take=None,
           dtype=torch.float32, tf32: bool = False) -> Decision:
    """One tick of the arbiter.  Gate a: the rollout predicts a crash; b:
    its speed exceeds DESIRED_SPEED; c: the certificate condemns the
    step-ST_TEST_ROLLOUTS state; d: the ST path is strictly better (lower
    mean |jerk| and more progress, or no RL progress).  ``tf32``: every
    matrix product in TF32 (the control)."""
    def policy(s):
        return actor(observation(s, p), tf32)

    first = policy(state)
    v = state.ego_speed.to(dtype)
    a = state.ego_accel.to(dtype)
    hist, hist_len, crash, last_speed, test = _rollout(policy, state, first,
                                                       p)
    st_speed, fine, fine_len = planner.st_control(state, p, dtype, tf32)
    off = torch.zeros_like(crash)
    gate_a = crash if p.CHECK_ROLLOUT_CRASH else off
    gate_b = last_speed > p.DESIRED_SPEED if p.LIMIT_DQN_SPEED else off
    gate_c = planner.certificate(test, p, dtype) if p.TEST_ROLLOUT_STATE \
        else off
    take = gate_a | gate_b | gate_c
    gate_d = off
    rl_speed = _speed_from_jerk(v, a, first.to(dtype), p)
    if p.TEST_ST_STRICTLY_BETTER:
        n = torch.minimum(fine_len, hist_len)
        st_jerk = _mean_abs_jerk(fine, n, v, a, p.TICK_LENGTH)
        rl_jerk = _mean_abs_jerk(hist, n, v, a, p.TICK_LENGTH)
        idx = torch.clamp_min(n - 1, 0).to(torch.int64)[:, None]
        st_dist = torch.gather(fine, 1, idx)[:, 0] - fine[:, 0]
        rl_dist = torch.gather(hist, 1, idx)[:, 0] - hist[:, 0]
        better = ((st_jerk < rl_jerk) & (st_dist > rl_dist)) \
            | (rl_dist == 0.0)
        if p.REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED:
            rl_better = (rl_jerk < st_jerk) & (rl_dist > st_dist)
            better = torch.where(last_take, ~rl_better, better)
        gate_d = better & (fine_len > 1)
        take = take | gate_d
    speed = torch.where(take, st_speed, rl_speed)
    return Decision(speed.to(state.ego_speed.dtype), take, st_speed,
                    rl_speed, gate_a, gate_b, gate_c, gate_d)
