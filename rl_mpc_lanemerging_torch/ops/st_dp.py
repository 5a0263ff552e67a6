"""Dense wavefront DP solver for the (t, s) trajectory lattice.

Port of ``rl_mpc_lanemerging_tpu/ops/st_dp.py``, the dense twins of the
reference's heap-Dijkstra solvers (st_cy.pyx:315-399 ``solve_s_t_path_fast``
and st_cy.pyx:209-312 ``solve_s_t_path_no_jerk_fast``).  Every edge advances
exactly one time layer and every edge cost is positive, so settling layer
t+1 as

    V[t+1, j] = min_i  V[t, i] + edge_cost(i -> j)

over all layer-t nodes gives Dijkstra's settle values; ties go to the
smallest predecessor index, as in the heap.

Float semantics (cost expression order, ceil/trunc index rounding,
``distance_penalty``) follow st_cy.pyx:34-93 operation for operation, so that
float64 runs agree with the native oracle in ``csrc/``.  This is the
controller's non-kernel DP and the golden for the CUDA kernel in
``st_kernel.py``.  Each layer holds (B, max_offset, S) candidate tensors, so
keep batches small on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["STWeights", "solve_st_fast", "solve_st_no_jerk_fast",
           "default_max_offset"]


class STWeights(NamedTuple):
    """Runtime solver parameters (mirrors st_cy.pyx:315 argument list)."""

    d_weight: float
    v_weight: float
    a_weight: float
    j_weight: float
    desired_speed: float
    max_speed: float
    negative_acceleration_limit: float
    positive_acceleration_limit: float
    negative_jerk_limit: float
    positive_jerk_limit: float
    min_allowed_distance: float


def default_max_offset(max_speed: float, delta_t: float,
                       delta_s: float) -> int:
    """Static bound on j - i: top speed covers max_speed*dt of s per step."""
    return int(max_speed * delta_t / delta_s) + 2


def _distance_penalty(min_distance, min_allowed_distance):
    """reference st_cy.pyx:34-38 (the weight is applied by the caller)."""
    near = 1000000.0 / torch.clamp_min(min_distance, 1.0)
    far = 1.0 / min_distance
    return torch.where(min_distance < min_allowed_distance, near, far)


def _edge_cost_jerk(s, s_1, s_2, s_3, delta_t, min_distance, w: STWeights):
    """reference st_cy.pyx:46-50 ``cost_with_jerk``."""
    v = (s - s_1) / delta_t
    a = (s - 2.0 * s_1 + s_2) / (delta_t * delta_t)
    j = (s - 3.0 * s_1 + 3.0 * s_2 - s_3) / (delta_t * delta_t * delta_t)
    dv = v - w.desired_speed
    return (w.v_weight * (dv * dv)
            + w.a_weight * (a * a)
            + w.j_weight * (j * j)
            + w.d_weight * _distance_penalty(min_distance,
                                             w.min_allowed_distance))


def _edge_cost_no_jerk(s, s_1, s_2, delta_t, min_distance, w: STWeights):
    """reference st_cy.pyx:41-44 ``cost``, with the weights taken from
    ``w``."""
    v = (s - s_1) / delta_t
    a = (s - 2.0 * s_1 + s_2) / (delta_t * delta_t)
    dv = v - w.desired_speed
    return (w.v_weight * (dv * dv)
            + w.a_weight * (a * a)
            + w.d_weight * _distance_penalty(min_distance,
                                             w.min_allowed_distance))


def _range_indices(start_s, delta_s, range_min, range_max):
    """Inclusive index interval [lo, hi] of grid values within
    [range_min, range_max]; exact integer semantics of st_cy.pyx:78-93
    (ceil via trunc-then-bump for the lower bound, trunc for the upper)."""
    lo_exact = (range_min - start_s) / delta_s
    lo = lo_exact.to(torch.int32)
    lo = lo + (lo.to(lo_exact.dtype) < lo_exact).to(torch.int32)
    hi = ((range_max - start_s) / delta_s).to(torch.int32)
    return lo, hi


def _feasible_range_with_jerk(s, s_1, s_2, delta_t, w: STWeights):
    """reference st_cy.pyx:65-75."""
    prev_v = (s_1 - s_2) / delta_t
    v = (s - s_1) / delta_t
    a = (v - prev_v) / delta_t
    min_a = torch.clamp_min(a + w.negative_jerk_limit * delta_t,
                            w.negative_acceleration_limit)
    max_a = torch.clamp_max(a + w.positive_jerk_limit * delta_t,
                            w.positive_acceleration_limit)
    min_v = torch.clamp_min(v + min_a * delta_t, 0.0)
    max_v = torch.clamp_max(v + max_a * delta_t, w.max_speed)
    return s + min_v * delta_t, s + max_v * delta_t


def _feasible_range_no_jerk(s, s_1, delta_t, w: STWeights):
    """reference st_cy.pyx:56-62."""
    v = (s - s_1) / delta_t
    min_v = torch.clamp_min(v + w.negative_acceleration_limit * delta_t, 0.0)
    max_v = torch.clamp_max(v + w.positive_acceleration_limit * delta_t,
                            w.max_speed)
    return s + min_v * delta_t, s + max_v * delta_t


def _backtrace(v_layers, bp_layers, s_values):
    """Reconstruct the s sequences (B, T) (reference st_cy.pyx:390-399),
    zero-filled past the furthest reachable layer."""
    batch, num_t, _ = v_layers.shape
    finite_any = torch.isfinite(v_layers).any(dim=2)                # (B, T)
    best_t = num_t - 1 - torch.argmax(
        torch.flip(finite_any, dims=(1,)).to(torch.uint8), dim=1)
    rows = torch.arange(batch, device=v_layers.device)
    idx = torch.argmin(v_layers[rows, best_t], dim=1)              # (B,)
    seq = torch.zeros((batch, num_t), dtype=s_values.dtype,
                      device=s_values.device)
    for t in range(num_t - 1, 0, -1):
        active = t <= best_t
        seq[:, t] = torch.where(active, s_values[rows, idx], 0.0)
        idx = torch.where(active, bp_layers[rows, t, idx], idx)
    seq[:, 0] = s_values[rows, idx]
    return seq


def _dp_sweep(obstacles, s_values, t_values, distances, w, max_offset,
              init_v, init_prev, init_second, with_jerk: bool):
    """Shared layered sweep over a batch; the path context (prev value,
    second value) rides along per node so that the jerk-limited feasibility
    and cost see the context the heap algorithm would."""
    batch, num_s = s_values.shape
    device = s_values.device
    dtype = s_values.dtype
    delta_t = t_values[1] - t_values[0]
    delta_s = (s_values[:, 1] - s_values[:, 0])[:, None]
    start_s = s_values[:, :1]

    # candidate rows scan predecessors in ascending i (descending offset) so
    # that argmin tie-breaks on the smallest predecessor index, like the heap
    offs = torch.arange(max_offset - 1, -1, -1, dtype=torch.int64,
                        device=device)                              # (D,)
    j_idx = torch.arange(num_s, dtype=torch.int64, device=device)   # (S,)
    src = j_idx[None, :] - offs[:, None]                            # (D, S)
    src_ok = src >= 0
    src_c = torch.clamp_min(src, 0)
    rows = torch.arange(batch, device=device)[:, None]

    v, prev_val, second_val = init_v, init_prev, init_second
    v_rows, bp_rows = [init_v], [torch.zeros_like(init_v, dtype=torch.int64)]
    for t in range(1, obstacles.shape[1]):
        if with_jerk:
            mn, mx = _feasible_range_with_jerk(
                s_values, prev_val, second_val, delta_t, w)
        else:
            mn, mx = _feasible_range_no_jerk(s_values, prev_val, delta_t, w)
        lo, hi = _range_indices(start_s, delta_s, mn, mx)

        feas = src_ok & (j_idx >= lo[:, src_c]) & (j_idx <= hi[:, src_c]) \
            & ~obstacles[:, t, None, :]                             # (B, D, S)
        # edge costs only for the feasible (source, destination) pairs, a
        # few per source: elementwise, so each pair's value is the one the
        # dense (B, D, S) evaluation gives
        bi, di, ji = feas.nonzero(as_tuple=True)
        si_idx = src_c[di, ji]
        s_i = s_values[bi, si_idx]
        p_i = prev_val[bi, si_idx]
        s_j = s_values[bi, ji]
        d_j = distances[bi, t, ji]
        if with_jerk:
            cost = _edge_cost_jerk(s_j, s_i, p_i, second_val[bi, si_idx],
                                   delta_t, d_j, w)
        else:
            cost = _edge_cost_no_jerk(s_j, s_i, p_i, delta_t, d_j, w)
        cand = torch.full(feas.shape, float("inf"), dtype=dtype,
                          device=device)
        cand[bi, di, ji] = v[bi, si_idx] + cost

        new_v = cand.amin(dim=1)
        am = torch.argmin(cand, dim=1)
        i_star = j_idx - offs[am]
        settled = torch.isfinite(new_v)
        i_safe = torch.where(settled, i_star, 0)
        new_prev = torch.where(settled, s_values[rows, i_safe], 0.0)
        new_second = torch.where(settled, prev_val[rows, i_safe], 0.0)
        v, prev_val, second_val = new_v, new_prev, new_second
        v_rows.append(new_v)
        bp_rows.append(i_safe)

    return _backtrace(torch.stack(v_rows, dim=1), torch.stack(bp_rows, dim=1),
                      s_values)


def solve_st_fast(obstacles, s_values, t_values, ego_start_speed,
                  ego_start_acceleration, distances, w: STWeights,
                  max_offset: int):
    """Jerk-limited solver; dense twin of st_cy.pyx:315-399.

    ``obstacles`` (B, T, S) bool, ``s_values`` (B, S), ``t_values`` (T,),
    start speed and acceleration (B,), ``distances`` (B, T, S).  Returns the
    planned s sequences (B, T), zero-filled past the furthest reachable
    layer when no complete path exists.
    """
    dtype = s_values.dtype
    delta_t = t_values[1] - t_values[0]
    start_s = s_values[:, 0]

    est_prev = start_s - ego_start_speed * delta_t
    est_second = est_prev - delta_t * (
        ego_start_speed - ego_start_acceleration * delta_t)

    init_v = torch.full_like(s_values, float("inf"))
    init_v[:, 0] = 0.0
    init_prev = est_prev[:, None].expand_as(s_values).to(dtype)
    init_second = est_second[:, None].expand_as(s_values).to(dtype)
    return _dp_sweep(obstacles, s_values, t_values, distances, w, max_offset,
                     init_v, init_prev, init_second, with_jerk=True)


def solve_st_no_jerk_fast(obstacles, s_values, t_values, ego_start_speed,
                          distances, w: STWeights, max_offset: int):
    """No-jerk 2-D solver; dense twin of st_cy.pyx:209-312.

    The heap version seeds layer 1 directly from the virtual start context
    (st_cy.pyx:236-243); seeding layer 0 at index 0 with context
    prev = start_s - v0*dt makes the first sweep generate the identical
    layer-1 frontier.
    """
    dtype = s_values.dtype
    delta_t = t_values[1] - t_values[0]
    est_prev = s_values[:, 0] - ego_start_speed * delta_t

    init_v = torch.full_like(s_values, float("inf"))
    init_v[:, 0] = 0.0
    init_prev = est_prev[:, None].expand_as(s_values).to(dtype)
    init_second = torch.zeros_like(s_values)
    return _dp_sweep(obstacles, s_values, t_values, distances, w, max_offset,
                     init_v, init_prev, init_second, with_jerk=False)
