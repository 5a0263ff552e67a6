"""The observation vector of the RL agents.

Port of ``rl_mpc_lanemerging_tpu/rl/obs.py`` (reference dqn.py:389-446
``get_state_vector_from_base_state``), written for a whole batch where the
JAX package maps one scenario under ``vmap``.  Layout (defaults:
CARS_AHEAD=2, CARS_BEHIND=2, acceleration + speed difference +
normalization on):

    [front_1, front_2, back_1, back_2, ego_v, ego_a, ego_x, ego_y]

where each car tuple is (accel/9, (v - v_ego)/MAX_SPEED,
(x - x_ego)/SENSOR_RADIUS, present) with front_1 the *nearest* car ahead
and back_1 the nearest car behind; absent slots are zeros.  Ego features
normalize by (MAX_SPEED, 9, 300, 100) per dqn.py:436-441.
"""

from __future__ import annotations

import torch

from .._device import const
from ..config import Settings
from ..prediction import HighwayState

__all__ = ["state_vector"]


def _nearest(state: HighwayState, ahead: bool, count: int):
    """Slot indices (B, count) and presence of the ``count`` nearest cars
    ahead or behind.  The sort is stable, as ``jnp.argsort`` is: absent
    slots all carry ``inf`` and two cars may share an x, and the slot order
    settles both."""
    dx = state.other_x - state.ego_x[:, None]
    if ahead:
        mask = state.other_present & (dx > 0)
        key = torch.where(mask, dx, float("inf"))
    else:
        mask = state.other_present & ~(dx > 0)
        key = torch.where(mask, -dx, float("inf"))
    order = torch.argsort(key, dim=1, stable=True)[:, :count]
    return order, torch.gather(mask, 1, order)


def state_vector(state: HighwayState, cfg: Settings) -> torch.Tensor:
    """(B, obs_dim) observations of a batch of sensed states."""
    dtype = state.ego_speed.dtype
    use_acc = cfg.USE_ACCELERATION_OF_OTHER_CARS
    norm = cfg.NORMALIZE_VECTOR_INPUT

    def car_feats(order, ok):
        x = torch.where(ok, torch.gather(state.other_x, 1, order)
                        - state.ego_x[:, None], 0.0)
        v = torch.gather(state.other_speed, 1, order)
        if cfg.USE_SPEED_DIFFERENCE:
            v = v - state.ego_speed[:, None]
        v = torch.where(ok, v, 0.0)
        cols = []
        if use_acc:
            a = torch.where(ok, torch.gather(state.other_accel, 1, order),
                            0.0)
            if norm:
                a = a / const(9.0, a)
            cols.append(a)
        if norm:
            v = v / const(cfg.MAX_SPEED, v)
            x = x / const(cfg.SENSOR_RADIUS, x)
        cols.extend([v, x, ok.to(dtype)])
        return torch.stack(cols, dim=-1).flatten(1)   # (B, count * per_car)

    front = car_feats(*_nearest(state, True, cfg.CARS_AHEAD))
    back = car_feats(*_nearest(state, False, cfg.CARS_BEHIND))

    ego = torch.stack([state.ego_speed, state.ego_accel, state.ego_x,
                       state.ego_y], dim=1)
    if norm:
        ego = ego / torch.tensor([cfg.MAX_SPEED, 9.0, 300.0, 100.0],
                                 dtype=ego.dtype, device=ego.device)
    out = torch.cat([front, back, ego], dim=1).to(dtype)
    assert out.shape[1] == cfg.obs_dim
    return out
