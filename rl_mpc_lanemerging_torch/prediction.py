"""Batched traffic forecaster — the world model behind the planner.

Port of ``rl_mpc_lanemerging_tpu/prediction.py`` (reference
prediction.py:9-182).  A state is a ``HighwayState`` of tensors with a
leading scenario axis B: ego fields are (B,), car fields (B, K) with the
cars sorted front to back and absent slots at ``x = -inf``.  The JAX
package's leader-chain ``lax.scan`` over the K car slots is a Python loop
over K here, carried over the whole batch at once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import geometry
from ._device import const
from .config import Settings

__all__ = ["HighwayState", "predict_step_with_ego",
           "predict_step_without_ego", "get_closest_cars"]

# Interaction thresholds (reference prediction.py:11-12).
EGO_REACTION_THRESHOLD = 8.0
EGO_CRASH_THRESHOLD = 11.0
# Followers react to a closing leader within this gap (prediction.py:85).
REACTION_GAP = 30.0


class HighwayState(NamedTuple):
    """Sensor snapshot of B scenarios: ego pose + padded, front-to-back
    sorted other cars."""

    ego_x: torch.Tensor          # (B,)
    ego_y: torch.Tensor          # (B,)
    ego_speed: torch.Tensor      # (B,)
    ego_accel: torch.Tensor      # (B,)
    other_x: torch.Tensor        # (B, K) descending; -inf for absent slots
    other_speed: torch.Tensor    # (B, K)
    other_accel: torch.Tensor    # (B, K)
    other_present: torch.Tensor  # (B, K) bool

    @property
    def num_slots(self) -> int:
        return self.other_x.shape[-1]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` of a boolean row."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _last_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the last True along the last axis (K-1 when none)."""
    k = mask.shape[-1]
    return k - 1 - _first_true(torch.flip(mask, dims=(-1,)))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, K) x and (B,) idx."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _predict_ego_position(ego_x, ego_y, selected_speed, delta_t):
    """Ego moves straight toward merge_point2, clamped to the highway lane y
    (reference prediction.py:48-59)."""
    mx, my = geometry.MERGE_POINT2
    dx = mx - ego_x
    dy = my - ego_y
    norm = torch.sqrt(dx * dx + dy * dy)
    step = selected_speed * delta_t
    safe = torch.clamp_min(norm, 1e-12)
    pre_x = ego_x + step * dx / safe
    pre_y = ego_y + step * dy / safe
    pre_y = torch.clamp_min(pre_y, geometry.HIGHWAY_Y)
    post_x = ego_x + selected_speed * delta_t
    on_ramp = ego_x < mx
    return (torch.where(on_ramp, pre_x, post_x),
            torch.where(on_ramp, pre_y, ego_y))


def predict_step_with_ego(state: HighwayState, selected_speed, delta_t: float,
                          cfg: Settings, min_crash_distance: float = 5.0
                          ) -> Tuple[HighwayState, torch.Tensor]:
    """One forecast step with the ego commanding ``selected_speed`` (B,)
    (reference prediction.py:46-105).  Returns (next_state, crashed (B,))."""
    dtype = state.ego_speed.dtype
    selected_speed = torch.as_tensor(selected_speed, dtype=dtype,
                                     device=state.ego_x.device)
    pred_x, pred_y = _predict_ego_position(
        state.ego_x, state.ego_y, selected_speed, delta_t)
    next_accel = (selected_speed - state.ego_speed) / const(delta_t,
                                                            state.ego_speed)

    pred_s = geometry.get_ego_s(pred_x, pred_y)
    ego_can_crash = pred_s > EGO_CRASH_THRESHOLD
    ego_has_merged = pred_s > EGO_REACTION_THRESHOLD
    max_decel = cfg.MAX_PREDICTED_DECELERATION

    # Leader chain, front to back (the JAX package's lax.scan over slots).
    # The scan's ego_seen flag is an OR over the earlier present slots of
    # (x < pred_x), so the splice mask is computed for all slots at once;
    # only the carried leader position and speed stay sequential.
    behind = state.other_x < pred_x[:, None]                        # (B, K)
    seen = torch.cumsum((behind & state.other_present).to(torch.int32),
                        dim=1) - (behind & state.other_present).to(torch.int32)
    # splice the merged ego into the leader chain (prediction.py:78-82)
    use_ego = behind & (seen == 0) & ego_has_merged[:, None]
    last_x = torch.full_like(state.ego_x, float("inf"))
    last_speed = torch.zeros_like(state.ego_speed)
    xs, speeds, accels = [], [], []
    for k in range(state.num_slots):
        x = state.other_x[:, k]
        speed = state.other_speed[:, k]
        present = state.other_present[:, k]
        lead_x = torch.where(use_ego[:, k], pred_x, last_x)
        lead_speed = torch.where(use_ego[:, k], selected_speed, last_speed)
        speed_diff = lead_speed - speed
        reacting = (speed_diff < 0) & (lead_x - x < REACTION_GAP)
        new_accel = torch.where(reacting,
                                torch.clamp_min(speed_diff, max_decel), 0.0)
        new_speed = torch.where(reacting, speed + new_accel * delta_t, speed)
        new_x = x + new_speed * delta_t
        # absent slots must not disturb the leader chain
        last_x = torch.where(present, new_x, lead_x)
        last_speed = torch.where(present, new_speed, lead_speed)
        xs.append(new_x)
        speeds.append(new_speed)
        accels.append(new_accel)
    present = state.other_present
    new_x = torch.where(present, torch.stack(xs, dim=1), float("-inf"))
    new_speed = torch.where(present, torch.stack(speeds, dim=1), 0.0)
    new_accel = torch.where(present, torch.stack(accels, dim=1), 0.0)

    crash_distance = max(cfg.CAR_LENGTH, min_crash_distance)
    crashed = torch.any(state.other_present
                        & (torch.abs(new_x - pred_x[:, None])
                           < crash_distance), dim=1)
    crashed = crashed & ego_can_crash

    next_state = HighwayState(pred_x, pred_y, selected_speed, next_accel,
                              new_x, new_speed, new_accel,
                              state.other_present)
    return next_state, crashed


def predict_step_without_ego(state: HighwayState, delta_t: float,
                             cfg: Settings, min_crash_distance: float = 5.0
                             ) -> Tuple[HighwayState, torch.Tensor]:
    """Forecast with the ego replaced by a space-holding virtual vehicle
    (reference prediction.py:22-44), used by the planner's obstacle grid.

    Three branchless cases:
      A. ego pre-merge (s < 8) or no cars: ego unchanged, speed 0.
      B. ego ahead of every car: ghost ego at (-20, -10), speed 0.
      C. some car behind the ego: ego tails the car in front of it
         (position front_x - CAR_LENGTH - 5, its speed); if every car is in
         front, ego keeps its position at the rearmost car's speed.
    """
    ego_s = geometry.get_ego_s(state.ego_x, state.ego_y)
    present = state.other_present
    any_present = present.any(dim=1)
    behind = present & (state.other_x < state.ego_x[:, None])
    any_behind = behind.any(dim=1)
    first_behind = _first_true(behind)
    front_most_behind = behind[:, 0]

    # car directly in front of the ego (valid when first_behind > 0)
    prev_idx = torch.clamp_min(first_behind - 1, 0)
    prev_x = _take(state.other_x, prev_idx)
    prev_speed = _take(state.other_speed, prev_idx)

    # rearmost present car (valid when any_present)
    rear_speed = torch.where(any_present,
                             _take(state.other_speed, _last_true(present)),
                             0.0)

    case_a = (ego_s < EGO_REACTION_THRESHOLD) | ~any_present
    case_b = ~case_a & front_most_behind
    case_c1 = ~case_a & ~case_b & any_behind
    # case_c2 (all cars in front) is the fallthrough

    ego_x = torch.where(case_b, -20.0,
                        torch.where(case_c1, prev_x - cfg.CAR_LENGTH - 5.0,
                                    state.ego_x))
    ego_y = torch.where(case_b, -10.0, state.ego_y)
    ego_speed = torch.where(case_a, state.ego_speed,
                            torch.where(case_b, 0.0,
                                        torch.where(case_c1, prev_speed,
                                                    state.ego_speed)))
    selected = torch.where(case_a | case_b, 0.0,
                           torch.where(case_c1, prev_speed, rear_speed))

    mod = state._replace(ego_x=ego_x, ego_y=ego_y, ego_speed=ego_speed)
    return predict_step_with_ego(mod, selected, delta_t, cfg,
                                 min_crash_distance)


def get_closest_cars(state: HighwayState):
    """(front_car, behind_car), each (x, speed, accel, present) of shape
    (B,) (reference prediction.py:162-182).  ``present`` flags replace the
    reference's ``None`` returns."""
    present = state.other_present
    is_behind = state.other_x < state.ego_x[:, None]
    behind = present & is_behind
    in_front = present & ~is_behind
    idx_behind = _first_true(behind)
    any_behind = behind.any(dim=1)
    idx_front = _last_true(in_front)
    any_front = in_front.any(dim=1)

    def pick(idx, ok):
        return (torch.where(ok, _take(state.other_x, idx), float("inf")),
                torch.where(ok, _take(state.other_speed, idx), 0.0),
                torch.where(ok, _take(state.other_accel, idx), 0.0),
                ok)

    return pick(idx_front, any_front), pick(idx_behind, any_behind)
