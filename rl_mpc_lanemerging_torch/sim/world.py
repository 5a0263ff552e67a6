"""Vectorized merge world — the simulation backend, batched.

Port of ``rl_mpc_lanemerging_tpu/sim/world.py`` (the reference's SUMO
process + TraCI bridge, sumo.py:33-68 and control.py:17-226).  A
``WorldState`` holds B scenarios; every field has a leading batch axis.

* Traffic: Krauss-model followers (merge_impossible.rou.xml: accel 4.5,
  decel 6.0, length 5, minGap 1, tau 0.5, sigma 0), or, with
  USE_ALTERNATE_TRAFFIC_DISTRIBUTION, the 6-personality IDM mix.
* Spawner: one car every BASE_TRAFFIC_INTERVAL (+U[0,1) when
  VARY_TRAFFIC_START_TIMES) seconds, with the countdown carried across
  episodes (control.py:26, 215-226).
* Ego: speed-actuated with speedMode 22 semantics along the ramp -> merge
  lane -> highway polyline.
* Collision: ego overlaps a traffic car once laterally on the highway lane
  and past the crash threshold.

The JAX world carries a PRNG key; this one carries a per-scenario step count
``steps`` instead and takes its draws from a source object (``sim/rng.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import geometry
from .._device import const, resolve_device
from ..config import Settings
from ..prediction import EGO_CRASH_THRESHOLD, HighwayState

__all__ = ["WorldState", "init_world", "world_step", "sense", "add_ego",
           "remove_ego", "IDM_TYPE_TABLE", "IDM_TYPE_PROBS",
           "alternate_flow_probability"]

_INACTIVE_X = -1e9
CAR_WIDTH = 1.8   # SUMO default vehicle width; no vType overrides it

# Alternate traffic distribution: the 6-personality IDM vType mix of
# merge2{,b,c}.rou.xml.  Columns: accel a, decel b, minGap s0, headway tau,
# speedFactor mean, dev, min, max, vType maxSpeed, emergencyDecel.  Rows:
# aggressive, cautious, slowbrake, slow, reallyslow, normal.
IDM_TYPE_TABLE = np.asarray([
    # a     b    s0   tau  sfm   sfd  sfmin sfmax vmax  emerg
    [4.5,  6.0,  2.0, 0.5, 1.30, 0.1, 0.2,  2.0,  40.0, 9.0],   # aggressive
    [4.5,  6.0,  7.5, 1.5, 0.90, 0.1, 0.2,  2.0,  40.0, 9.0],   # cautious
    [1.5,  2.0,  2.5, 1.0, 1.00, 0.1, 0.2,  2.0,  40.0, 3.0],   # slowbrake
    [3.0,  4.5,  2.5, 1.0, 0.50, 0.1, 0.2,  2.0,  20.0, 6.0],   # slow
    [3.0,  4.5,  2.5, 1.0, 0.25, 0.1, 0.15, 2.0,  10.0, 6.0],   # reallyslow
    [4.5,  6.0,  2.5, 1.0, 1.00, 0.1, 0.2,  2.0,  40.0, 9.0],   # normal
], dtype=np.float64)
IDM_TYPE_PROBS = np.asarray([0.2, 0.1, 0.1, 0.08, 0.02, 0.5])
_SPEED_LIMIT = 30.0          # every lane in merge.net.xml is speed="30.00"
_IDM_DELTA = 4.0
_CAUTIOUS_IDX = 1


def alternate_flow_probability(cfg: Settings) -> float:
    """Per-tick insertion probability of the alternate flow (reference
    sumo.py:36-44)."""
    table = {"low": 0.3, "medium": 0.45, "high": 0.6}
    try:
        return table[cfg.TRAFFIC_DENSITY]
    except KeyError:
        raise ValueError(
            f"Unknown TRAFFIC_DENSITY: {cfg.TRAFFIC_DENSITY}") from None


class WorldState(NamedTuple):
    """B merge scenarios."""

    cars_x: torch.Tensor        # (B, N) front-bumper x; _INACTIVE_X if off
    cars_v: torch.Tensor        # (B, N)
    cars_prev_v: torch.Tensor   # (B, N) for accel sensing
    cars_active: torch.Tensor   # (B, N) bool
    cars_params: torch.Tensor   # (B, N, 6) IDM params [a, b, s0, tau, v0, e]
    ego_active: torch.Tensor    # (B,) bool
    ego_arc: torch.Tensor       # (B,) route arc position
    ego_v: torch.Tensor         # (B,)
    ego_prev_v: torch.Tensor    # (B,)
    spawn_delay: torch.Tensor   # (B,) seconds until next traffic injection
    ego_arrived: torch.Tensor   # (B,) bool, set the tick the ego exits
    ego_collided: torch.Tensor  # (B,) bool
    steps: torch.Tensor         # (B,) int64 world steps taken: keys draws


def init_world(cfg: Settings, batch: int, dtype=torch.float32,
               device="cuda") -> WorldState:
    """B empty worlds on ``device`` (the card unless the caller asks for
    another)."""
    device = resolve_device(device)
    n = cfg.MAX_CARS
    z = torch.zeros((batch,), dtype=dtype, device=device)
    f = torch.zeros((batch,), dtype=torch.bool, device=device)
    return WorldState(
        cars_x=torch.full((batch, n), _INACTIVE_X, dtype=dtype,
                          device=device),
        cars_v=torch.zeros((batch, n), dtype=dtype, device=device),
        cars_prev_v=torch.zeros((batch, n), dtype=dtype, device=device),
        cars_active=torch.zeros((batch, n), dtype=torch.bool, device=device),
        cars_params=torch.zeros((batch, n, 6), dtype=dtype, device=device),
        ego_active=f, ego_arc=z, ego_v=z, ego_prev_v=z, spawn_delay=z,
        ego_arrived=f, ego_collided=f,
        steps=torch.zeros((batch,), dtype=torch.int64, device=device))


def _ego_xy(world: WorldState):
    xy = geometry.route_xy(world.ego_arc)
    return xy[..., 0], xy[..., 1]


def _krauss_next_speed(v, gap, leader_v, cfg: Settings):
    """SUMO Krauss safe-velocity follower (decel b=6, tau=0.5, accel
    a=4.5)."""
    b = -cfg.MAX_NEGATIVE_ACCELERATION          # 6.0
    tau = 0.5
    dt = cfg.TICK_LENGTH
    v_safe = -b * tau + torch.sqrt(torch.clamp_min(
        b * b * tau * tau + leader_v * leader_v + 2.0 * b * gap, 0.0))
    v_des = torch.clamp_max(
        torch.minimum(v + cfg.MAX_POSITIVE_ACCELERATION * dt, v_safe),
        cfg.OTHER_CAR_SPEED)
    # physical braking limit: followers cannot exceed their decel rating,
    # which is what makes collisions possible when the ego cuts in too hard
    return torch.clamp_min(torch.maximum(v_des, v - b * dt), 0.0)


def _idm_next_speed(v, net_gap, leader_v, has_leader, params, dt):
    """IDM follower for the alternate traffic personalities (delta=4,
    braking capped at the vType's emergencyDecel)."""
    a = params[..., 0]
    b = params[..., 1]
    s0 = params[..., 2]
    tau = params[..., 3]
    v0 = torch.clamp_min(params[..., 4], 0.1)
    emerg = params[..., 5]
    dv = v - leader_v
    s_star = s0 + torch.clamp_min(
        v * tau + v * dv / (2.0 * torch.sqrt(a * b)), 0.0)
    gap = torch.clamp_min(net_gap, 0.1)
    ratio = s_star / gap
    interaction = torch.where(has_leader, ratio * ratio, 0.0)
    acc = a * (1.0 - torch.pow(v / v0, _IDM_DELTA) - interaction)
    acc = torch.maximum(acc, -emerg)
    return torch.clamp_min(v + acc * dt, 0.0)


def world_step(world: WorldState, ego_speed_command: torch.Tensor,
               cfg: Settings, rng) -> WorldState:
    """One simulation tick for every scenario (reference control.py:215-226
    ``step`` + SUMO's vehicle update).  ``ego_speed_command`` (B,) is the
    setSpeed target; pass the current ego speed to coast.  ``rng`` gives the
    spawner's draws (``sim/rng.py``)."""
    dtype = world.cars_x.dtype
    device = world.cars_x.device
    dt = cfg.TICK_LENGTH
    dtc = const(dt, world.cars_x)
    n = world.cars_x.shape[1]

    ego_x, ego_y = _ego_xy(world)
    # SUMO junction semantics: once the ego has entered the junction's
    # internal merge lane it occupies the conflict area and highway cars
    # brake for it
    ego_on_highway = world.ego_active \
        & (world.ego_arc > geometry.EGO_JUNCTION_ARC)

    # --- traffic: nearest leader ahead among cars (and the merged ego) ---
    x = world.cars_x
    active = world.cars_active
    ahead = (x[:, None, :] > x[:, :, None]) & active[:, None, :] \
        & active[:, :, None]
    cand_x = torch.where(ahead, x[:, None, :], float("inf"))
    leader_idx = torch.argmin(cand_x, dim=2)
    has_leader = torch.isfinite(cand_x.amin(dim=2))
    leader_x = torch.where(has_leader, torch.gather(x, 1, leader_idx),
                           float("inf"))
    leader_v = torch.where(has_leader,
                           torch.gather(world.cars_v, 1, leader_idx), 0.0)
    # the merged ego splices in if it is the nearest vehicle ahead and the
    # follower can yield within its braking rating (gap acceptance)
    b_cap = -cfg.MAX_NEGATIVE_ACCELERATION
    gap_e = ego_x[:, None] - cfg.CAR_LENGTH - x - 1.0     # bumper + minGap
    ego_v = world.ego_v[:, None]
    rel_brake = torch.clamp_min(world.cars_v * world.cars_v - ego_v * ego_v,
                                0.0) / const(2.0 * b_cap, x)
    can_yield = (gap_e >= 0.0) & (gap_e >= rel_brake)
    if cfg.DIAG_YIELD_MODE == "always":
        can_yield = gap_e >= 0.0
    elif cfg.DIAG_YIELD_MODE == "never":
        can_yield = torch.zeros_like(can_yield)
    ego_between = ego_on_highway[:, None] & can_yield \
        & (ego_x[:, None] > x) & (ego_x[:, None] < leader_x)
    leader_x = torch.where(ego_between, ego_x[:, None], leader_x)
    leader_v = torch.where(ego_between, ego_v, leader_v)

    if cfg.USE_ALTERNATE_TRAFFIC_DISTRIBUTION:
        net_gap = leader_x - cfg.CAR_LENGTH - x      # bumper-to-bumper
        has_lead = torch.isfinite(leader_x)
        new_cars_v = torch.where(
            active,
            _idm_next_speed(world.cars_v, net_gap, leader_v, has_lead,
                            world.cars_params, dt),
            0.0)
    else:
        gap = leader_x - cfg.CAR_LENGTH - x - 1.0   # minGap=1 (rou.xml)
        new_cars_v = torch.where(
            active, _krauss_next_speed(world.cars_v, gap, leader_v, cfg),
            0.0)
    new_cars_x = torch.where(active, x + new_cars_v * dt, x)
    # a SUMO follower never passes its leader: a car that yielded to the
    # spliced ego queues behind it
    x_floor = x + torch.clamp_min(world.cars_v - b_cap * dt, 0.0) * dt
    ego_block = ego_x[:, None] - cfg.CAR_LENGTH
    blocked = ego_between & (new_cars_x > ego_block)
    if cfg.DIAG_NO_PASS_CLAMP_OFF:
        blocked = torch.zeros_like(blocked)
    clamped_x = torch.maximum(torch.minimum(new_cars_x, ego_block), x_floor)
    new_cars_x = torch.where(blocked, clamped_x, new_cars_x)
    new_cars_v = torch.where(blocked, (new_cars_x - x) / dtc, new_cars_v)

    # --- ego: speedMode 22 -> accel/decel limited toward the command ---
    cmd = ego_speed_command.to(dtype)
    lo = world.ego_v + cfg.MAX_NEGATIVE_ACCELERATION * dt
    hi = world.ego_v + cfg.MAX_POSITIVE_ACCELERATION * dt
    new_ego_v = torch.minimum(torch.maximum(cmd, lo), hi).clamp(0.0, 40.0)
    new_ego_v = torch.where(world.ego_active, new_ego_v, 0.0)
    new_ego_arc = world.ego_arc + new_ego_v * dt

    # --- arrivals / exits ---
    car_exited = active & (new_cars_x >= geometry.TRAFFIC_EXIT_X)
    new_active = active & ~car_exited
    new_cars_x = torch.where(new_active, new_cars_x, _INACTIVE_X)
    arrived_now = world.ego_active \
        & (new_ego_arc >= geometry.EGO_ARRIVAL_ARC)

    # --- collision (post-move positions): vehicle shapes intersect only
    # with lateral overlap, and past the forecaster's crash threshold ---
    new_xy = geometry.route_xy(new_ego_arc)
    new_ego_x, new_ego_y = new_xy[..., 0], new_xy[..., 1]
    new_ego_s = geometry.get_ego_s(new_ego_x, new_ego_y)
    lateral_overlap = torch.abs(new_ego_y - geometry.HIGHWAY_Y) < CAR_WIDTH
    overlap = new_active & (torch.abs(new_cars_x - new_ego_x[:, None])
                            < cfg.CAR_LENGTH)
    collided_now = world.ego_active & ~arrived_now \
        & (new_ego_s > EGO_CRASH_THRESHOLD) & lateral_overlap \
        & overlap.any(dim=1)

    # --- spawner ---
    draws = rng.step_draws(world.steps, dtype)
    free = ~new_active
    slot = torch.argmax(free.to(torch.uint8), dim=1)
    # insertion safety: rearmost car must leave room at the entry point
    entry_gap = torch.where(new_active, new_cars_x, float("inf")).amin(dim=1) \
        - geometry.TRAFFIC_SPAWN_X - cfg.CAR_LENGTH

    if cfg.USE_ALTERNATE_TRAFFIC_DISTRIBUTION:
        p_flow = alternate_flow_probability(cfg)
        do_spawn = draws.vary < p_flow
        table = torch.as_tensor(IDM_TYPE_TABLE).to(device=device,
                                                   dtype=dtype)
        row = table[draws.type_idx]                                 # (B, 10)
        sf = torch.minimum(torch.maximum(
            row[:, 4] + row[:, 5] * draws.speed_factor, row[:, 6]),
            row[:, 7])
        v_desired = torch.minimum(sf * _SPEED_LIMIT, row[:, 8])
        params_new = torch.stack([row[:, 0], row[:, 1], row[:, 2],
                                  row[:, 3], v_desired, row[:, 9]], dim=1)
        # flow departSpeed=10 clamped to the type's desired speed; the
        # cautious personality departs at departSpeed="random"
        spawn_v = torch.where(draws.type_idx == _CAUTIOUS_IDX,
                              draws.depart * v_desired,
                              torch.clamp_max(v_desired, 10.0))
        can_spawn = do_spawn & free.any(dim=1) & (entry_gap > row[:, 2])
        new_delay = world.spawn_delay            # unused by this flow
    else:
        do_spawn = world.spawn_delay <= 0.0
        can_spawn = do_spawn & free.any(dim=1) & (entry_gap > 1.0)
        spawn_v = torch.full_like(world.spawn_delay, cfg.OTHER_CAR_SPEED)
        params_new = torch.zeros((x.shape[0], 6), dtype=dtype, device=device)
        vary = draws.vary if cfg.VARY_TRAFFIC_START_TIMES \
            else torch.zeros_like(world.spawn_delay)
        interval = vary + cfg.BASE_TRAFFIC_INTERVAL
        new_delay = torch.where(do_spawn & can_spawn, interval,
                                world.spawn_delay)
        # an unsafe insertion retries next tick (delay stays <= 0)
        new_delay = torch.where(do_spawn & ~can_spawn, world.spawn_delay,
                                new_delay) - dt

    put = can_spawn[:, None] & (torch.arange(n, device=device)[None, :]
                                == slot[:, None])
    new_cars_x = torch.where(put, geometry.TRAFFIC_SPAWN_X, new_cars_x)
    new_cars_v_s = torch.where(put, spawn_v[:, None], new_cars_v)
    prev_v = torch.where(put, spawn_v[:, None], world.cars_v)
    new_params = torch.where(put[:, :, None], params_new[:, None, :],
                             world.cars_params)
    new_active = put | new_active

    return WorldState(
        cars_x=new_cars_x, cars_v=new_cars_v_s, cars_prev_v=prev_v,
        cars_active=new_active, cars_params=new_params,
        ego_active=world.ego_active & ~arrived_now & ~collided_now,
        ego_arc=new_ego_arc, ego_v=new_ego_v, ego_prev_v=world.ego_v,
        spawn_delay=new_delay,
        ego_arrived=arrived_now, ego_collided=collided_now,
        steps=world.steps + 1)


def add_ego(world: WorldState, start_speed: torch.Tensor) -> WorldState:
    """Insert the ego at ramp position 40 with the given speeds (B,)
    (reference control.py:41-44)."""
    v = start_speed.to(world.cars_x.dtype)
    true = torch.ones_like(world.ego_active)
    return world._replace(
        ego_active=true,
        ego_arc=torch.full_like(v, geometry.EGO_DEPART_ARC),
        ego_v=v, ego_prev_v=v,
        ego_arrived=~true, ego_collided=~true)


def remove_ego(world: WorldState) -> WorldState:
    false = torch.zeros_like(world.ego_active)
    return world._replace(ego_active=false, ego_arrived=false,
                          ego_collided=false)


def sense(world: WorldState, cfg: Settings) -> HighwayState:
    """Sensor snapshot -> HighwayState (reference prediction.py:111-142).

    Cars within SENSOR_RADIUS of the ego, front-to-back sorted, padded to
    cfg.MAX_SENSED_CARS slots.  When the ego is absent the reference reports
    it at (-200, 0) with zero speed.
    """
    k = cfg.MAX_SENSED_CARS
    dtc = const(cfg.TICK_LENGTH, world.cars_x)

    ego_x, ego_y = _ego_xy(world)
    ego_x = torch.where(world.ego_active, ego_x, -200.0)
    ego_y = torch.where(world.ego_active, ego_y, 0.0)
    ego_v = torch.where(world.ego_active, world.ego_v, 0.0)
    ego_a = torch.where(world.ego_active,
                        (world.ego_v - world.ego_prev_v) / dtc, 0.0)

    dx = world.cars_x - ego_x[:, None]
    dy = geometry.HIGHWAY_Y - ego_y[:, None]
    dist = torch.sqrt(dx * dx + dy * dy)
    visible = world.cars_active & (dist < cfg.SENSOR_RADIUS)
    key_x = torch.where(visible, world.cars_x, float("-inf"))
    # stable, as jnp.argsort: invisible cars keep their slot order
    order = torch.argsort(-key_x, dim=1, stable=True)[:, :k]
    present = torch.gather(visible, 1, order)
    xs_o = torch.gather(world.cars_x, 1, order)
    vs_o = torch.gather(world.cars_v, 1, order)
    pv_o = torch.gather(world.cars_prev_v, 1, order)
    return HighwayState(
        ego_x=ego_x, ego_y=ego_y, ego_speed=ego_v, ego_accel=ego_a,
        other_x=torch.where(present, xs_o, float("-inf")),
        other_speed=torch.where(present, vs_o, 0.0),
        other_accel=torch.where(present, (vs_o - pv_o) / dtc, 0.0),
        other_present=present)
