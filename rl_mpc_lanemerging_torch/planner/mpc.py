"""Receding-horizon MPC controller and safety certificate.

Port of ``rl_mpc_lanemerging_tpu/planner/mpc.py`` (reference
st.py:726-814): build the obstacle grids, run the lattice DP, trim the
trailing zeros the solver emits when no full-horizon path exists
(st.py:762-768), refine to tick resolution with the QP smoother
(st.py:770-772), and execute the first step as a speed command
(st.py:779-783).

The ``batched_*`` functions, ``corridor_from_state`` and
``path_cost_report`` take a ``HighwayState`` of B scenarios.  The
single-scenario forms ``plan_st``, ``st_control_speed`` and
``test_guaranteed_crash`` take one unbatched state and run the batched code
on a batch of one, with the dense DP, as the JAX package's do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import geometry, tracing
from .._device import const, pin_fp32_matmul
from ..config import Settings
from ..ops import qp, st_dp, st_kernel
from ..prediction import HighwayState, predict_step_with_ego
from .grid import STGrid, build_st_grid

__all__ = ["weights_from_settings", "PlanResult", "plan_st",
           "st_control_speed", "test_guaranteed_crash", "corridor_from_state",
           "path_cost_report", "batched_plan", "batched_st_control",
           "batched_test_guaranteed_crash", "batched_conditional_st",
           "make_batched_controller"]


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

    ``USE_FAST_ST_SOLVER`` picks the DP, as in the reference (st.py:726-768):
    the jerk-limited DP when True, the no-jerk dense DP when False.  With
    ``use_kernel`` the jerk-limited DP goes through
    ``st_kernel.st_wavefront`` (the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors), otherwise through the dense twin; the no-jerk
    DP has no kernel and runs dense on either device.

    Returns (seq (B, T), valid_len (B,) int32, grids: STGrid).
    """
    with tracing.span("grid.build"):
        grids = build_st_grid(states, cfg, dtype)
    ego_accel = states.ego_accel.to(dtype)
    w = weights_from_settings(cfg)
    with tracing.span("dp.solve"):
        if use_kernel and cfg.USE_FAST_ST_SOLVER:
            seq = st_kernel.st_wavefront(
                grids.obstacles, grids.s_values, grids.ego_speed, ego_accel,
                grids.distances, cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION,
                w, _max_offset(cfg)).to(dtype)
        elif cfg.USE_FAST_ST_SOLVER:
            seq = st_dp.solve_st_fast(
                grids.obstacles, grids.s_values, grids.t_values,
                grids.ego_speed, ego_accel, grids.distances, w,
                _max_offset(cfg))
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


def corridor_from_state(states: HighwayState, plan_last_s, cfg: Settings,
                        dtype=torch.float32):
    """Per-fine-step position bounds from the lead/trail cars (reference
    st.py:551-581 ``get_before_after_constraints`` + the C_7 corridor rows
    of finer_fit, st.py:672-705), for B scenarios.

    The "after" car is the one ending (at the horizon) closest ahead of the
    plan's final position ``plan_last_s`` (B,); the "before" car the one
    ending closest behind.  Returns (pos_lo, pos_hi), each (B,
    cfg.fine_horizon), +-inf where no corridor car exists or its projection
    is still before the merge."""
    n = cfg.fine_horizon
    device = states.ego_x.device
    t_fine = torch.arange(n, dtype=dtype, device=device) * cfg.TICK_LENGTH
    t_last = (cfg.num_t - 1) * cfg.T_DISCRETIZATION

    obs_s = geometry.get_obstacle_s_from_x(states.other_x).to(dtype)
    v = states.other_speed.to(dtype)
    end_s = obs_s + v * t_last
    present = states.other_present & (end_s >= -cfg.CAR_LENGTH)
    last = torch.as_tensor(plan_last_s, dtype=dtype, device=device)[:, None]
    after_mask = present & (end_s > last)
    before_mask = present & (end_s < last)
    inf = float("inf")
    after_idx = torch.argmin(torch.where(after_mask, end_s, inf), dim=1,
                             keepdim=True)
    before_idx = torch.argmax(torch.where(before_mask, end_s, -inf), dim=1,
                              keepdim=True)
    has_after = after_mask.any(dim=1, keepdim=True)
    has_before = before_mask.any(dim=1, keepdim=True)

    def projection(idx):
        return torch.gather(obs_s, 1, idx) \
            + t_fine[None, :] * torch.gather(v, 1, idx)

    after_proj = projection(after_idx)
    before_proj = projection(before_idx)
    hi = torch.where(has_after & (after_proj >= -cfg.CAR_LENGTH),
                     after_proj - cfg.CAR_LENGTH, inf)
    lo = torch.where(has_before & (before_proj >= -cfg.CAR_LENGTH),
                     before_proj + cfg.CAR_LENGTH, -inf)
    return lo, hi


def batched_st_control(states: HighwayState, cfg: Settings,
                       dtype=torch.float32, use_kernel: bool = False,
                       use_corridor: bool = False):
    """Whole-batch ``do_st_control`` (st.py:757-783): DP plan + QP refine +
    first-step speed command.  Returns
    (speed (B,), seq (B, T), valid (B,), fine (B, n), fine_len (B,), grids).
    When the smoothed plan has <= 1 usable point the current speed is held
    (st.py:774-777).  ``use_corridor`` adds the lead/trail position
    corridor to the smoother (reference st.py:672-705; like the reference's
    main path, off by default)."""
    seq, valid, grids = batched_plan(states, cfg, dtype, use_kernel)
    v0 = states.ego_speed.to(dtype)
    a0 = states.ego_accel.to(dtype)
    if cfg.TICK_LENGTH < cfg.T_DISCRETIZATION:
        op = qp.build_operator(cfg.fine_horizon, cfg.TICK_LENGTH)
        pos_lo = pos_hi = None
        if use_corridor:
            last = torch.clamp_min(valid - 1, 0).to(torch.int64)
            last_s = torch.gather(seq, 1, last[:, None])[:, 0]
            pos_lo, pos_hi = corridor_from_state(states, last_s, cfg, dtype)
        with tracing.span("qp.admm"):
            fine, fine_len = qp.finer_fit_qp(
                seq, valid, v0, a0, op, cfg.T_DISCRETIZATION, cfg.MAX_SPEED,
                cfg.MAX_POSITIVE_ACCELERATION, cfg.MAX_NEGATIVE_ACCELERATION,
                cfg.MAXIMUM_POSITIVE_JERK, cfg.MINIMUM_NEGATIVE_JERK,
                iterations=cfg.QP_ITERATIONS, pos_lo=pos_lo, pos_hi=pos_hi)
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


def batched_conditional_st(states: HighwayState, proposed_speed,
                           cfg: Settings, dtype=torch.float32,
                           use_kernel: Optional[bool] = None):
    """``do_conditional_st_based_on_first_step`` (reference st.py:805-814),
    batched: predict one tick with the ego at ``proposed_speed``; where the
    prediction crashes or the safety certificate condemns the predicted
    state, the ST controller takes over, otherwise the proposed speed
    executes.  Both plans go through the kernel where ``use_kernel`` (by
    default: where the states lie on the card).  Returns (speed (B,),
    st_took_over (B,) bool)."""
    if use_kernel is None:
        use_kernel = states.ego_x.is_cuda
    proposed = torch.as_tensor(proposed_speed, device=states.ego_x.device)
    nxt, crashed = predict_step_with_ego(
        states, proposed.to(states.ego_speed.dtype), cfg.TICK_LENGTH, cfg,
        cfg.MIN_ALLOWED_DISTANCE)
    condemned = batched_test_guaranteed_crash(nxt, cfg, dtype, use_kernel)
    take = crashed | condemned
    st_speed = batched_st_control(states, cfg, dtype, use_kernel)[0]
    return torch.where(take, st_speed, proposed.to(st_speed.dtype)), take


# --- single-scenario forms (one unbatched state, a batch of one inside) ---

class PlanResult(NamedTuple):
    s_sequence: torch.Tensor   # (T,) coarse DP path, zero-filled tail
    valid_len: torch.Tensor    # () int32: points before the zero tail
    grid: STGrid               # one scenario's grid, no batch axis


def _batch_of_one(state: HighwayState) -> HighwayState:
    return HighwayState(*(torch.as_tensor(x)[None] for x in state))


def _one_grid(grids: STGrid) -> STGrid:
    """Scenario 0 of a batch of grids (``t_values`` has no batch axis)."""
    return STGrid(grids.obstacles[0], grids.s_values[0], grids.t_values,
                  grids.ego_speed[0], grids.distances[0])


def plan_st(state: HighwayState, cfg: Settings, dtype=torch.float32
            ) -> PlanResult:
    """Grid build + dense DP solve + trailing-zero trim of one scenario
    (st.py:726-768), honouring ``USE_FAST_ST_SOLVER``."""
    seq, valid, grids = batched_plan(_batch_of_one(state), cfg, dtype)
    return PlanResult(seq[0], valid[0], _one_grid(grids))


def st_control_speed(state: HighwayState, cfg: Settings, dtype=torch.float32,
                     use_corridor: bool = False):
    """Full ``do_st_control`` of one scenario (st.py:757-783): returns
    (speed, plan, fine, fine_len)."""
    speed, seq, valid, fine, fine_len, grids = batched_st_control(
        _batch_of_one(state), cfg, dtype, use_corridor=use_corridor)
    return (speed[0], PlanResult(seq[0], valid[0], _one_grid(grids)), fine[0],
            fine_len[0])


def test_guaranteed_crash(state: HighwayState, cfg: Settings,
                          dtype=torch.float32) -> torch.Tensor:
    """Safety certificate of one scenario (st.py:790-802)."""
    return batched_test_guaranteed_crash(_batch_of_one(state), cfg, dtype)[0]


def path_cost_report(s_sequence, ego_start_speed, ego_start_acceleration,
                     delta_t: float, distances, s_values, w: st_dp.STWeights):
    """Path cost + kinematic-limit violation counts of B paths (reference
    st.py:291-336 ``get_path_cost``, which prints a line per violated
    limit).  ``s_sequence`` (B, T), start speed and acceleration (B,),
    ``distances`` (B, T, S), ``s_values`` (B, S).  Returns (total_cost (B,),
    {speed/accel/jerk violation counts (B,)}); the cost is inf where a path
    point falls off the s lattice."""
    dtype = s_sequence.dtype
    num_s = s_values.shape[1]
    dt = const(delta_t, s_sequence)
    v0 = ego_start_speed.to(dtype)
    a0 = ego_start_acceleration.to(dtype)
    start_s = s_values[:, :1]
    delta_s = s_values[:, 1:2] - s_values[:, :1]

    est_prev = s_sequence[:, 0] - v0 * delta_t
    est_second = est_prev - (v0 - a0 * delta_t) * delta_t
    ext = torch.cat([est_second[:, None], est_prev[:, None], s_sequence],
                    dim=1)
    s = ext[:, 3:]                 # s_i        for i in 1..n-1
    s_1 = ext[:, 2:-1]             # s_{i-1}
    s_2 = ext[:, 1:-2]
    s_3 = ext[:, :-3]

    v = (s - s_1) / dt
    # violations exactly as the reference checks them (v/a/j from
    # consecutive differences seeded with the measured start state)
    v_prev = torch.cat([v0[:, None], v[:, :-1]], dim=1)
    acc = (v - v_prev) / dt
    a_prev = torch.cat([a0[:, None], acc[:, :-1]], dim=1)
    jerk = (acc - a_prev) / dt

    idx = torch.round((s - start_s) / delta_s).to(torch.int32)
    on_grid = ((start_s + idx.to(dtype) * delta_s - s).abs() < 1e-6) \
        & (idx >= 0) & (idx < num_s)
    # the distance at path point i (layers 1..T-1)
    d = torch.gather(distances[:, 1:], 2,
                     idx.clamp(0, num_s - 1).to(torch.int64)[:, :, None])[..., 0]
    costs = st_dp._edge_cost_jerk(s, s_1, s_2, s_3, dt, d, w)
    total = torch.where(on_grid.all(dim=1), costs.sum(dim=1),
                        torch.full_like(costs[:, 0], float("inf")))
    report = {
        "speed_violations": (v > w.max_speed).sum(dim=1),
        "accel_violations": ((acc > w.positive_acceleration_limit)
                             | (acc < w.negative_acceleration_limit)
                             ).sum(dim=1),
        "jerk_violations": ((jerk > w.positive_jerk_limit)
                            | (jerk < w.negative_jerk_limit)).sum(dim=1),
    }
    return total, report


def make_batched_controller(cfg: Settings) -> Callable:
    """The production controller: HighwayState (B,) -> speed commands (B,).

    It takes the CUDA kernel when the states lie on the card and the dense
    DP when they lie on the CPU, as the JAX package takes its Pallas kernel
    on an accelerator and the dense DP on the CPU.  The QP's products are
    pinned to true fp32."""
    pin_fp32_matmul()

    def controller(states: HighwayState) -> torch.Tensor:
        with tracing.span("controller.plan"):
            return batched_st_control(states, cfg,
                                      use_kernel=states.ego_x.is_cuda)[0]
    return controller
