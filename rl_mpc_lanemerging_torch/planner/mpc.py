"""Receding-horizon MPC controller and safety certificate, batched.

Port of the batched half of ``rl_mpc_lanemerging_tpu/planner/mpc.py``
(reference st.py:726-814): build the obstacle grids, run the lattice DP,
trim the trailing zeros the solver emits when no full-horizon path exists
(st.py:762-768), refine to tick resolution with the QP smoother
(st.py:770-772), and execute the first step as a speed command
(st.py:779-783).  Every function takes a ``HighwayState`` of B scenarios.
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import const, pin_fp32_matmul
from ..config import Settings
from ..ops import qp, st_dp, st_kernel
from ..prediction import HighwayState
from .grid import build_st_grid

__all__ = ["weights_from_settings", "batched_plan", "batched_st_control",
           "batched_test_guaranteed_crash", "make_batched_controller"]


def weights_from_settings(cfg: Settings) -> st_dp.STWeights:
    """Solver parameter pack (the argument list the reference passes at
    st.py:740-746)."""
    return st_dp.STWeights(
        d_weight=cfg.D_WEIGHT, v_weight=cfg.V_WEIGHT, a_weight=cfg.A_WEIGHT,
        j_weight=cfg.J_WEIGHT, desired_speed=cfg.DESIRED_SPEED,
        max_speed=cfg.MAX_SPEED,
        negative_acceleration_limit=cfg.MAX_NEGATIVE_ACCELERATION,
        positive_acceleration_limit=cfg.MAX_POSITIVE_ACCELERATION,
        negative_jerk_limit=cfg.MINIMUM_NEGATIVE_JERK,
        positive_jerk_limit=cfg.MAXIMUM_POSITIVE_JERK,
        min_allowed_distance=cfg.MIN_ALLOWED_DISTANCE)


def _max_offset(cfg: Settings) -> int:
    return st_dp.default_max_offset(
        cfg.MAX_SPEED, cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION)


def batched_plan(states: HighwayState, cfg: Settings, dtype=torch.float32,
                 use_kernel: bool = False):
    """Whole-batch grid build + DP solve + trailing-zero trim.

    With ``use_kernel`` the solve goes through ``st_kernel.st_wavefront``
    (the CUDA kernel for CUDA tensors, its plain version for CPU tensors).
    Like the JAX package's kernel path, it always runs the jerk-limited DP.
    Otherwise the dense twin runs, honouring ``USE_FAST_ST_SOLVER``.

    Returns (seq (B, T), valid_len (B,) int32, grids: STGrid).
    """
    grids = build_st_grid(states, cfg, dtype)
    ego_accel = states.ego_accel.to(dtype)
    w = weights_from_settings(cfg)
    if use_kernel:
        seq = st_kernel.st_wavefront(
            grids.obstacles, grids.s_values, grids.ego_speed, ego_accel,
            grids.distances, cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION, w,
            _max_offset(cfg)).to(dtype)
    elif cfg.USE_FAST_ST_SOLVER:
        seq = st_dp.solve_st_fast(
            grids.obstacles, grids.s_values, grids.t_values,
            grids.ego_speed, ego_accel, grids.distances, w, _max_offset(cfg))
    else:
        seq = st_dp.solve_st_no_jerk_fast(
            grids.obstacles, grids.s_values, grids.t_values,
            grids.ego_speed, grids.distances, w, _max_offset(cfg))
    num_t = seq.shape[1]
    nonzero = torch.flip(seq, dims=(1,)) != 0.0
    trailing = torch.argmax(nonzero.to(torch.uint8), dim=1)
    all_zero = ~nonzero.any(dim=1)
    valid = torch.where(all_zero, 1, num_t - trailing).to(torch.int32)
    return seq, valid, grids


def batched_st_control(states: HighwayState, cfg: Settings,
                       dtype=torch.float32, use_kernel: bool = False):
    """Whole-batch ``do_st_control`` (st.py:757-783): DP plan + QP refine +
    first-step speed command.  Returns
    (speed (B,), seq (B, T), valid (B,), fine (B, n), fine_len (B,), grids).
    When the smoothed plan has <= 1 usable point the current speed is held
    (st.py:774-777)."""
    seq, valid, grids = batched_plan(states, cfg, dtype, use_kernel)
    v0 = states.ego_speed.to(dtype)
    a0 = states.ego_accel.to(dtype)
    if cfg.TICK_LENGTH < cfg.T_DISCRETIZATION:
        op = qp.build_operator(cfg.fine_horizon, cfg.TICK_LENGTH)
        fine, fine_len = qp.finer_fit_qp(
            seq, valid, v0, a0, op, cfg.T_DISCRETIZATION, cfg.MAX_SPEED,
            cfg.MAX_POSITIVE_ACCELERATION, cfg.MAX_NEGATIVE_ACCELERATION,
            cfg.MAXIMUM_POSITIVE_JERK, cfg.MINIMUM_NEGATIVE_JERK,
            iterations=cfg.QP_ITERATIONS)
        step_dt = cfg.TICK_LENGTH
    else:
        fine, fine_len = seq, valid
        step_dt = cfg.T_DISCRETIZATION
    speed = (fine[:, 1] - fine[:, 0]) / const(step_dt, fine)
    speed = torch.where(fine_len <= 1, v0, speed)
    return speed, seq, valid, fine, fine_len, grids


def batched_test_guaranteed_crash(states: HighwayState, cfg: Settings,
                                  dtype=torch.float32,
                                  use_kernel: bool = False):
    """Whole-batch safety certificate (st.py:790-802): True where the solver
    finds no complete horizon path, or the path passes closer than
    COMBINATION_MIN_DISTANCE - CAR_LENGTH to an obstacle."""
    seq, valid, grids = batched_plan(states, cfg, dtype, use_kernel)
    num_t = seq.shape[1]
    incomplete = valid < num_t
    delta_s = grids.s_values[:, 1] - grids.s_values[:, 0]
    idx = ((seq - grids.s_values[:, :1]) / delta_s[:, None]).to(torch.int32)
    idx = idx.clamp(0, grids.s_values.shape[1] - 1).to(torch.int64)
    d = torch.gather(grids.distances, 2, idx[:, :, None])[..., 0]
    threshold = cfg.COMBINATION_MIN_DISTANCE - cfg.CAR_LENGTH
    t_iota = torch.arange(num_t, device=seq.device)
    too_close = ((t_iota[None, :] < valid[:, None])
                 & (d < threshold)).any(dim=1)
    return incomplete | too_close


def make_batched_controller(cfg: Settings) -> Callable:
    """The production controller: HighwayState (B,) -> speed commands (B,).

    It takes the CUDA kernel when the states lie on the card and the dense
    DP when they lie on the CPU, as the JAX package takes its Pallas kernel
    on an accelerator and the dense DP on the CPU.  The QP's products are
    pinned to true fp32."""
    pin_fp32_matmul()

    def controller(states: HighwayState) -> torch.Tensor:
        return batched_st_control(states, cfg,
                                  use_kernel=states.ego_x.is_cuda)[0]
    return controller
