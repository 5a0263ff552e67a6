"""Tabular Q-learning over the discretized 6-D merge state (legacy path).

Port of ``rl_mpc_lanemerging_tpu/rl/tabular.py`` (reference rl.py:22-80
discretizers, rl.py:218-304 Q update and training loop).  State = (ego x
bucket, ego speed bucket, behind-car distance bucket, ahead-car distance
bucket, behind relative-speed bucket, ahead relative-speed bucket); Q table
shape (3, 6, 5, 5, 6, 6, |JERK_VALUES|) (rl.py:228-229).

The discretizers are ``searchsorted`` over whole batches.  The backward
per-episode Q update (rl.py:218-225) is sequential: each step reads the
maximum of the already-updated table at the next state.  ``fold_episodes``
computes every flat (state, action) and next-state index of a batch of
episodes in one vectorised pass, reads the indices, rewards and valid mask
to the host once, and then runs only the valid steps, in the JAX scan's
order (episode by episode, each in reverse), as a few in-place operations
on the table per step.

``collect_random_round`` is the collection half of
``scripts/train_tabular_torch.py``: one round of B synchronized episodes
under uniformly random actions, keeping each scenario's first episode.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Settings
from ..envs.merge_env import EnvKind, env_reset, env_step
from ..prediction import HighwayState, get_closest_cars

__all__ = ["initialize_q", "discretize_state", "q_update_episode",
           "fold_episodes", "greedy_tabular_controller", "EpisodeRecords",
           "collect_random_round"]

_X_EDGES = (-66.0, -51.0)                       # rl.py:22-30
_SPEED_EDGES = (2.0, 5.0, 10.0, 20.0, 30.0)     # rl.py:33-46
_REL_X_EDGES = (5.0, 10.0, 20.0, 50.0)          # rl.py:49-63
_REL_V_EDGES = (-15.0, -5.0, 0.0, 5.0, 15.0)    # rl.py:66-80
TABLE_SHAPE = (3, 6, 5, 5, 6, 6)


def initialize_q(cfg: Settings, dtype=torch.float32, device="cpu"
                 ) -> torch.Tensor:
    """rl.py:228-229."""
    return torch.zeros(TABLE_SHAPE + (len(cfg.JERK_VALUES),), dtype=dtype,
                       device=device)


def _bucket(edges, values: torch.Tensor) -> torch.Tensor:
    e = torch.tensor(edges, dtype=values.dtype, device=values.device)
    return torch.searchsorted(e, values.contiguous(), right=True)


def discretize_state(state: HighwayState):
    """HighwayState (B,) -> 6-tuple of (B,) int64 bucket indices
    (rl.py:104-112).

    The reference buckets use < comparisons on ascending edges
    (``searchsorted(right=True)``), except the x bucket, which *descends*
    with x (rl.py:22-30): ego_x < -66 -> 2, < -51 -> 1, else 0.  Absent cars
    sit at +-inf (rl.py:92-96), in the farthest distance bucket.
    """
    ego_x = state.ego_x
    x_state = torch.where(ego_x < _X_EDGES[0], 2,
                          torch.where(ego_x < _X_EDGES[1], 1, 0))
    front, behind = get_closest_cars(state)
    front_x = torch.where(front[3], front[0], float("inf"))
    behind_x = torch.where(behind[3], behind[0], float("-inf"))
    front_v = torch.where(front[3], front[1], 0.0)
    behind_v = torch.where(behind[3], behind[1], 0.0)
    return (x_state.to(torch.int64),
            _bucket(_SPEED_EDGES, state.ego_speed),
            _bucket(_REL_X_EDGES, torch.abs(ego_x - behind_x)),
            _bucket(_REL_X_EDGES, torch.abs(ego_x - front_x)),
            _bucket(_REL_V_EDGES, behind_v - state.ego_speed),
            _bucket(_REL_V_EDGES, front_v - state.ego_speed))


def _flat_state(states6) -> torch.Tensor:
    """Row-major flat index of the 6 bucket indices."""
    flat = torch.zeros_like(states6[0])
    for idx, size in zip(states6, TABLE_SHAPE):
        flat = flat * size + idx
    return flat


def fold_episodes(q: torch.Tensor, visits: torch.Tensor, states6, actions,
                  rewards, valid, discount: float, step_size: float):
    """Backward Q updates (rl.py:218-225) of B episodes, folded in order:
    episode 0 first, each iterated in reverse and bootstrapping from the
    *already-updated* table.  The last valid transition of an episode is
    terminal (no bootstrap).

    states6: 6 (B, T) bucket-index tensors; actions, rewards, valid: (B, T).
    Updates ``q`` and ``visits`` in place and returns them."""
    n_act = q.shape[-1]
    qf, vf = q.view(-1, n_act), visits.view(-1, n_act)
    t_len = actions.shape[1]
    flat = _flat_state([s.to(torch.int64) for s in states6])      # (B, T)
    nxt = flat[:, torch.clamp_max(torch.arange(t_len) + 1, t_len - 1)
               .to(flat.device)]
    # one read to the host: indices, rewards and the valid mask
    flat, nxt, act, rew, ok = (x.cpu().tolist() for x in (
        flat, nxt, actions.to(torch.int64), rewards.to(q.dtype), valid))
    keep = 1.0 - step_size
    for b in range(len(ok)):
        steps = [t for t in range(t_len) if ok[b][t]]
        last = steps[-1] if steps else -1
        for t in reversed(steps):
            cell = qf[flat[b][t], act[b][t]]
            if t == last:
                cell.mul_(keep).add_(step_size * rew[b][t])
            else:
                target = qf[nxt[b][t]].amax().mul_(discount).add_(rew[b][t])
                cell.mul_(keep).add_(target, alpha=step_size)
            vf[flat[b][t], act[b][t]] += 1.0
    return q, visits


def q_update_episode(q, visits, states6, actions, rewards, valid,
                     discount: float, step_size: float):
    """The backward update of one episode: states6 a tuple of (T,) bucket
    indices, actions / rewards / valid (T,).  In place; returns (q,
    visits)."""
    return fold_episodes(q, visits, [s[None] for s in states6],
                         actions[None], rewards[None], valid[None], discount,
                         step_size)


def greedy_tabular_controller(q: torch.Tensor, visits, cfg: Settings):
    """Batched greedy control over the table (rl.py:177-187), mapping the
    chosen jerk through the set_ego_jerk integrator.  With
    AVOID_UNVISITED_STATES and a visit table, unvisited actions are never
    chosen."""
    table = torch.tensor(cfg.JERK_VALUES, dtype=q.dtype, device=q.device)

    def control(states):
        idx = discretize_state(states)
        qv = q[idx]
        if cfg.AVOID_UNVISITED_STATES and visits is not None:
            qv = torch.where(visits[idx] == 0, float("-inf"), qv)
        jerk = table[torch.argmax(qv, dim=-1)].to(states.ego_speed.dtype)
        a = torch.clamp(states.ego_accel + jerk * cfg.TICK_LENGTH,
                        cfg.MAX_NEGATIVE_ACCELERATION,
                        cfg.MAX_POSITIVE_ACCELERATION)
        return torch.clamp(states.ego_speed + a * cfg.TICK_LENGTH, 0.0,
                           cfg.MAX_SPEED)

    return control


class EpisodeRecords(NamedTuple):
    """One round's transitions, episode-major: each scenario's first
    episode only."""

    states6: tuple            # 6 x (B, T) int64 bucket indices
    actions: torch.Tensor     # (B, T) int64
    rewards: torch.Tensor     # (B, T)
    valid: torch.Tensor       # (B, T) bool


def collect_random_round(cfg: Settings, worlds, world_rng, ticks: int,
                         generator: torch.Generator,
                         wait_before_start: float = 20.0) -> EpisodeRecords:
    """``ticks`` ticks of B synchronized episodes on the JERK env under
    uniformly random actions (reference rl.py:250-300 at epsilon = 1).  Only
    the FIRST episode each scenario runs is kept: the env's auto-reset would
    otherwise splice a second episode into the same row."""
    env = env_reset(worlds, cfg, wait_before_start=wait_before_start)
    batch = worlds.ego_arc.shape[0]
    device = worlds.ego_arc.device
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    n_actions = len(cfg.JERK_VALUES)
    idx, acts, rews, oks = [], [], [], []
    for _ in range(ticks):
        idx.append(torch.stack(discretize_state(env.state)))
        action = torch.randint(0, n_actions, (batch,), generator=generator,
                               device=device)
        env, tr = env_step(env, action, cfg, world_rng, EnvKind.JERK,
                           max_episode_length=cfg.MAX_EPISODE_LENGTH,
                           wait_before_start=wait_before_start)
        oks.append(tr["valid"] & ~done)
        done = done | tr["done"]
        acts.append(action)
        rews.append(tr["reward"])
    states6 = torch.stack(idx, dim=2)                             # (6, B, T)
    return EpisodeRecords(tuple(states6), torch.stack(acts, dim=1),
                          torch.stack(rews, dim=1), torch.stack(oks, dim=1))
