"""Spatio-temporal obstacle grid construction.

Port of ``rl_mpc_lanemerging_tpu/planner/grid.py`` (reference st.py:25-70
``find_s_t_obstacles_from_state``).  For each of the ``num_t`` horizon slices
the surrounding traffic is rolled forward with the ego-less forecaster and
projected onto the discretized s axis:

* cells within +-(CAR_LENGTH + uncertainty) of an obstacle are blocked and
  get distance 0 (st.py:59-65);
* every cell records the distance to the nearest obstacle bumper, initialized
  to 1e10 (st.py:52-57);
* cars behind ``CRASH_MIN_S - MIN_ALLOWED_DISTANCE`` do not obstruct and
  cars beyond the horizon are skipped (st.py:46-49).

The trunc-toward-zero cell index (st.py:20-22) is kept.  The whole batch of
B scenarios is built at once.  On the card, one launch of
``csrc/obstacle_grid.cu`` (``ops/grid_kernel.py``) builds it; on the CPU
and in float64 :func:`build_st_grid_plain` does, whose 17-slice forecast
roll is a Python loop and which is the kernel's plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import geometry, tracing
from .._device import const
from ..config import Settings
from ..ops import grid_kernel
from ..prediction import HighwayState, predict_step_without_ego

__all__ = ["STGrid", "build_st_grid", "build_st_grid_plain",
           "kernel_reach"]


class STGrid(NamedTuple):
    obstacles: torch.Tensor   # (B, T, S) bool
    s_values: torch.Tensor    # (B, S)
    t_values: torch.Tensor    # (T,), shared by every scenario
    ego_speed: torch.Tensor   # (B,)
    distances: torch.Tensor   # (B, T, S)


def _mark_slice(state: HighwayState, s_values, start_s, delta_s,
                discrete_reach: int, reach, cfg: Settings, dtype):
    """Obstacle/distance rows (B, S) for one time slice (st.py:44-65)."""
    num_s = s_values.shape[1]
    obs_s = geometry.get_obstacle_s_from_x(state.other_x).to(dtype)  # (B, K)
    active = state.other_present \
        & (obs_s >= cfg.CRASH_MIN_S - cfg.MIN_ALLOWED_DISTANCE) \
        & (obs_s <= s_values[:, -1:] + cfg.CAR_LENGTH)

    # distance field: min over cars of distance to either bumper, via
    # min(|s-f|, |s-b|) = ||s - obs| - reach| with f/b = obs -/+ reach
    y = torch.abs(s_values[:, None, :] - obs_s[:, :, None])       # (B, K, S)
    per_car = torch.abs(y - reach)
    per_car = torch.where(active[:, :, None], per_car, 1e10)
    distances = torch.clamp_max(per_car.amin(dim=1), 1e10)

    # blocked cells: trunc-toward-zero start index, +- body + uncertainty.
    # The JAX package tests the half-open band [start - dr, start + dr) as
    # one unsigned compare, uint32(iota - start + dr) < 2 dr: a negative
    # offset wraps to a huge unsigned value and fails.  That is exactly the
    # signed test 0 <= off < 2 dr written here (torch has no uint32 compare
    # on every backend).  Inactive cars (absent ones sit at -inf) are placed
    # at the grid start before the index conversion so that no infinite
    # value is cast to an integer; `active` masks them out either way.
    rel = torch.where(active, obs_s, start_s[:, None]) - start_s[:, None]
    start_idx = (rel / delta_s).to(torch.int32)                    # (B, K)
    iota = torch.arange(num_s, dtype=torch.int32, device=s_values.device)
    off = iota[None, None, :] - start_idx[:, :, None] + discrete_reach
    cell_blocked = active[:, :, None] & (off >= 0) \
        & (off < 2 * discrete_reach)
    obstacles = cell_blocked.any(dim=1)
    distances = torch.where(obstacles, 0.0, distances)
    return obstacles, distances


def _slice_reach(cfg: Settings):
    """Per-slice uncertainty in metres (host doubles) and blocked half width
    in cells (st.py:37-41, trunc semantics)."""
    delta_s = float(cfg.S_DISCRETIZATION)
    t_host = np.arange(cfg.num_t, dtype=np.float64) \
        * float(cfg.T_DISCRETIZATION)
    unc_host = (float(cfg.START_UNCERTAINTY)
                + float(cfg.UNCERTAINTY_PER_SECOND) * t_host)
    discrete_length = int(cfg.CAR_LENGTH / delta_s)
    return unc_host, [discrete_length + int(u / delta_s) for u in unc_host]


def kernel_reach(cfg: Settings):
    """The per-slice reach as the kernel takes it: in metres as f32 (T,),
    and in cells.  The metres are :func:`build_st_grid_plain`'s: slice 0's
    a host double rounded once, the later slices' an f32 add of the
    rounded uncertainty and CAR_LENGTH."""
    unc_host, discrete_reach = _slice_reach(cfg)
    car = np.float32(cfg.CAR_LENGTH)
    reach = [np.float32(cfg.CAR_LENGTH + float(unc_host[0]))]
    reach += [np.float32(u) + car for u in unc_host[1:]]
    return np.asarray(reach, np.float32), discrete_reach


def build_st_grid(state: HighwayState, cfg: Settings,
                  dtype=torch.float32) -> STGrid:
    """Build the (B, T, S) obstacle grid from a batch of sensed states.

    T = cfg.num_t, S = cfg.num_s.  Where ``grid_kernel.supports`` the state
    (on a CUDA device, and neither it nor the grid float64), one kernel
    launch builds it, bit for bit :func:`build_st_grid_plain`'s, or the
    kernel's wrapper raises; on the CPU and in float64 that plain path
    builds it.  The counter ``grid.path`` records 1 for a kernel build and
    0 for a plain one.
    """
    if not grid_kernel.supports(state, dtype):
        tracing.count("grid.path", 0)
        return build_st_grid_plain(state, cfg, dtype)
    tracing.count("grid.path", 1)
    obstacles, distances, s_values, t_values = grid_kernel.build(
        state, cfg, *kernel_reach(cfg), dtype)
    return STGrid(obstacles, s_values, t_values, state.ego_speed.to(dtype),
                  distances)


def build_st_grid_plain(state: HighwayState, cfg: Settings,
                        dtype=torch.float32) -> STGrid:
    """:func:`build_st_grid` in plain PyTorch on any device and dtype: the
    forecast rolled one ``predict_step_without_ego`` a slice, each slice
    marked by :func:`_mark_slice`."""
    num_t, num_s = cfg.num_t, cfg.num_s
    delta_s = float(cfg.S_DISCRETIZATION)
    delta_t = float(cfg.T_DISCRETIZATION)
    device = state.ego_x.device

    start_s = geometry.get_ego_s(state.ego_x, state.ego_y).to(dtype)
    ds = torch.tensor(delta_s, dtype=dtype, device=device)
    idx = torch.arange(num_s, dtype=dtype, device=device)
    s_values = start_s[:, None] + idx * ds
    t_values = torch.arange(num_t, dtype=dtype, device=device) \
        * const(delta_t, ds)

    # static per-slice reach in cells (st.py:37-41, trunc semantics)
    unc_host, discrete_reach = _slice_reach(cfg)

    # slice 0's reach is a host float; the JAX package scans the later
    # slices' uncertainty in as dtype scalars, so their reach is a dtype add
    obst = [None] * num_t
    dist = [None] * num_t
    obst[0], dist[0] = _mark_slice(
        state, s_values, start_s, ds, discrete_reach[0],
        cfg.CAR_LENGTH + float(unc_host[0]), cfg, dtype)
    rolled = state
    for t in range(1, num_t):
        with tracing.span("grid.forecast"):
            rolled, _ = predict_step_without_ego(rolled, delta_t, cfg)
        reach = const(float(unc_host[t]), ds) + cfg.CAR_LENGTH
        obst[t], dist[t] = _mark_slice(rolled, s_values, start_s, ds,
                                       discrete_reach[t], reach, cfg, dtype)

    return STGrid(torch.stack(obst, dim=1), s_values, t_values,
                  state.ego_speed.to(dtype), torch.stack(dist, dim=1))
