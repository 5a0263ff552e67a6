"""Sensed state, merge geometry and the traffic forecaster.

The paper's prediction.py:9-182 and control.py:366-389, batched over B
scenarios: ego fields (B,), car fields (B, K) sorted front to back with
absent slots at x = -inf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["State", "const", "matmul", "ego_s", "obstacle_s",
           "predict_with_ego", "predict_without_ego"]

MERGE_POINT = (-50.9, 1.72)
MERGE_POINT2 = (1.5, -1.5)
MERGE_POINT3 = (-51.0, -1.5)
COMMON_S = MERGE_POINT2[0] - MERGE_POINT3[0]
HIGHWAY_Y = -1.6
EGO_REACTION_THRESHOLD = 8.0
EGO_CRASH_THRESHOLD = 11.0
REACTION_GAP = 30.0


class State(NamedTuple):
    ego_x: torch.Tensor
    ego_y: torch.Tensor
    ego_speed: torch.Tensor
    ego_accel: torch.Tensor
    other_x: torch.Tensor
    other_speed: torch.Tensor
    other_accel: torch.Tensor
    other_present: torch.Tensor


def const(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype and device: a divisor
    that keeps true IEEE division (a Python-float divisor becomes a multiply
    by its reciprocal on CUDA)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest, ties to
    even: what the tensor cores read of each input under TF32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False):
    """a @ b in float32, or with both inputs rounded to TF32 (the
    control's precision) and the products summed in float32."""
    if tf32:
        a, b = _tf32(a), _tf32(b)
    return a @ b


def ego_s(x, y):
    """control.py:373-380."""
    dx = x - MERGE_POINT[0]
    dy = y - MERGE_POINT[1]
    d = torch.sqrt(dx * dx + dy * dy)
    after = x - MERGE_POINT2[0] + COMMON_S
    return torch.where(x < MERGE_POINT[0], -d,
                       torch.where(x < MERGE_POINT2[0], d, after))


def obstacle_s(x):
    """control.py:388-389."""
    return x - MERGE_POINT3[0]


def _first_true(mask):
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _last_true(mask):
    return mask.shape[-1] - 1 - _first_true(torch.flip(mask, dims=(-1,)))


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def _ego_position(x, y, speed, delta_t):
    """prediction.py:48-59: straight toward merge point 2, clamped to the
    highway lane."""
    mx, my = MERGE_POINT2
    dx = mx - x
    dy = my - y
    norm = torch.sqrt(dx * dx + dy * dy)
    step = speed * delta_t
    safe = torch.clamp_min(norm, 1e-12)
    pre_x = x + step * dx / safe
    pre_y = torch.clamp_min(y + step * dy / safe, HIGHWAY_Y)
    post_x = x + speed * delta_t
    on_ramp = x < mx
    return torch.where(on_ramp, pre_x, post_x), torch.where(on_ramp, pre_y, y)


def predict_with_ego(state: State, speed, delta_t: float, p,
                     min_crash_distance: float = 5.0):
    """prediction.py:46-105: one step with the ego at ``speed`` (B,);
    followers react to their leader (the merged ego spliced in).  Returns
    (next state, crashed (B,))."""
    dtype = state.ego_speed.dtype
    speed = torch.as_tensor(speed, dtype=dtype, device=state.ego_x.device)
    px, py = _ego_position(state.ego_x, state.ego_y, speed, delta_t)
    accel = (speed - state.ego_speed) / const(delta_t, state.ego_speed)
    ps = ego_s(px, py)
    can_crash = ps > EGO_CRASH_THRESHOLD
    merged = ps > EGO_REACTION_THRESHOLD

    behind = state.other_x < px[:, None]
    hit = (behind & state.other_present).to(torch.int32)
    seen = torch.cumsum(hit, dim=1) - hit
    use_ego = behind & (seen == 0) & merged[:, None]
    last_x = torch.full_like(state.ego_x, float("inf"))
    last_v = torch.zeros_like(state.ego_speed)
    xs, vs, acs = [], [], []
    for k in range(state.other_x.shape[1]):
        x = state.other_x[:, k]
        v = state.other_speed[:, k]
        present = state.other_present[:, k]
        lead_x = torch.where(use_ego[:, k], px, last_x)
        lead_v = torch.where(use_ego[:, k], speed, last_v)
        diff = lead_v - v
        react = (diff < 0) & (lead_x - x < REACTION_GAP)
        a = torch.where(react, torch.clamp_min(diff,
                                               p.MAX_PREDICTED_DECELERATION),
                        0.0)
        nv = torch.where(react, v + a * delta_t, v)
        nx = x + nv * delta_t
        last_x = torch.where(present, nx, lead_x)
        last_v = torch.where(present, nv, lead_v)
        xs.append(nx)
        vs.append(nv)
        acs.append(a)
    present = state.other_present
    nx = torch.where(present, torch.stack(xs, dim=1), float("-inf"))
    nv = torch.where(present, torch.stack(vs, dim=1), 0.0)
    na = torch.where(present, torch.stack(acs, dim=1), 0.0)
    crash_d = max(p.CAR_LENGTH, min_crash_distance)
    crashed = torch.any(present & (torch.abs(nx - px[:, None]) < crash_d),
                        dim=1) & can_crash
    return State(px, py, speed, accel, nx, nv, na, present), crashed


def predict_without_ego(state: State, delta_t: float, p,
                        min_crash_distance: float = 5.0):
    """prediction.py:22-44: the ego replaced by a space-holding virtual
    car (unchanged before the merge or with no cars; a ghost when it is
    ahead of every car; else tailing the car in front of it)."""
    s = ego_s(state.ego_x, state.ego_y)
    present = state.other_present
    any_present = present.any(dim=1)
    behind = present & (state.other_x < state.ego_x[:, None])
    any_behind = behind.any(dim=1)
    first_behind = _first_true(behind)
    front_most_behind = behind[:, 0]
    prev_idx = torch.clamp_min(first_behind - 1, 0)
    prev_x = _take(state.other_x, prev_idx)
    prev_v = _take(state.other_speed, prev_idx)
    rear_v = torch.where(any_present,
                         _take(state.other_speed, _last_true(present)), 0.0)
    case_a = (s < EGO_REACTION_THRESHOLD) | ~any_present
    case_b = ~case_a & front_most_behind
    case_c = ~case_a & ~case_b & any_behind
    x = torch.where(case_b, -20.0,
                    torch.where(case_c, prev_x - p.CAR_LENGTH - 5.0,
                                state.ego_x))
    y = torch.where(case_b, -10.0, state.ego_y)
    v = torch.where(case_a, state.ego_speed,
                    torch.where(case_b, 0.0,
                                torch.where(case_c, prev_v,
                                            state.ego_speed)))
    selected = torch.where(case_a | case_b, 0.0,
                           torch.where(case_c, prev_v, rear_v))
    mod = state._replace(ego_x=x, ego_y=y, ego_speed=v)
    return predict_with_ego(mod, selected, delta_t, p, min_crash_distance)
