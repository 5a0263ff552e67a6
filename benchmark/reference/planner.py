"""The MPC planner: obstacle grid, dense jerk-limited DP, trim, ADMM
smoother, first-step command, safety certificate.

The paper's st.py:25-70 (grid), st_cy.pyx:34-93 and :315-399 (the
jerk-limited solver, as a dense layered minimum: every edge advances one
time layer, so settling layer t+1 over all of layer t gives the heap's
settle values, ties to the smallest predecessor), st.py:584-723 (the cvxopt
smoother, here the same QP by a fixed number of ADMM iterations) and
st.py:757-802 (command and certificate).  Matrix products must run in true
fp32: the caller sets ``torch.backends.cuda.matmul.allow_tf32``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .forecast import (State, const, ego_s, matmul, obstacle_s,
                       predict_without_ego)

__all__ = ["build_grid", "solve_dp", "plan", "st_control", "certificate",
           "max_offset"]


# --- grid (st.py:25-70) ---------------------------------------------------

def _mark_slice(state: State, s_values, start_s, delta_s, reach_cells: int,
                reach, p, dtype):
    num_s = s_values.shape[1]
    obs = obstacle_s(state.other_x).to(dtype)                      # (B, K)
    active = state.other_present \
        & (obs >= p.CRASH_MIN_S - p.MIN_ALLOWED_DISTANCE) \
        & (obs <= s_values[:, -1:] + p.CAR_LENGTH)
    y = torch.abs(s_values[:, None, :] - obs[:, :, None])          # (B, K, S)
    per_car = torch.where(active[:, :, None], torch.abs(y - reach), 1e10)
    dist = torch.clamp_max(per_car.amin(dim=1), 1e10)
    # blocked: [start - reach, start + reach) around the car's cell index,
    # the index truncated toward zero (st.py:20-22)
    rel = torch.where(active, obs, start_s[:, None]) - start_s[:, None]
    start_idx = (rel / delta_s).to(torch.int32)
    iota = torch.arange(num_s, dtype=torch.int32, device=s_values.device)
    off = iota[None, None, :] - start_idx[:, :, None] + reach_cells
    blocked = (active[:, :, None] & (off >= 0)
               & (off < 2 * reach_cells)).any(dim=1)
    return blocked, torch.where(blocked, 0.0, dist)


def build_grid(state: State, p, dtype=torch.float32):
    """(obstacles (B, T, S) bool, s_values (B, S), distances (B, T, S))."""
    num_t, num_s = p.num_t, p.num_s
    ds_host, dt_host = float(p.S_DISCRETIZATION), float(p.T_DISCRETIZATION)
    device = state.ego_x.device
    start_s = ego_s(state.ego_x, state.ego_y).to(dtype)
    ds = torch.tensor(ds_host, dtype=dtype, device=device)
    s_values = start_s[:, None] \
        + torch.arange(num_s, dtype=dtype, device=device) * ds
    t_host = np.arange(num_t, dtype=np.float64) * dt_host
    unc = float(p.START_UNCERTAINTY) + float(p.UNCERTAINTY_PER_SECOND) * t_host
    car_cells = int(p.CAR_LENGTH / ds_host)
    reach_cells = [car_cells + int(u / ds_host) for u in unc]
    obst, dist = [], []
    o, d = _mark_slice(state, s_values, start_s, ds, reach_cells[0],
                       p.CAR_LENGTH + float(unc[0]), p, dtype)
    obst.append(o)
    dist.append(d)
    rolled = state
    for t in range(1, num_t):
        rolled, _ = predict_without_ego(rolled, dt_host, p)
        reach = const(float(unc[t]), ds) + p.CAR_LENGTH
        o, d = _mark_slice(rolled, s_values, start_s, ds, reach_cells[t],
                           reach, p, dtype)
        obst.append(o)
        dist.append(d)
    return torch.stack(obst, dim=1), s_values, torch.stack(dist, dim=1)


# --- dense jerk-limited DP (st_cy.pyx:34-93, 315-399) ----------------------

def max_offset(p) -> int:
    """Bound on the cells one step can advance at top speed."""
    return int(p.MAX_SPEED * p.T_DISCRETIZATION / p.S_DISCRETIZATION) + 2


def _penalty(d, p):
    near = 1000000.0 / torch.clamp_min(d, 1.0)
    return torch.where(d < p.MIN_ALLOWED_DISTANCE, near, 1.0 / d)


def _edge_cost(s, s_1, s_2, s_3, dt, d, p):
    v = (s - s_1) / dt
    a = (s - 2.0 * s_1 + s_2) / (dt * dt)
    j = (s - 3.0 * s_1 + 3.0 * s_2 - s_3) / (dt * dt * dt)
    dv = v - p.DESIRED_SPEED
    return (p.V_WEIGHT * (dv * dv) + p.A_WEIGHT * (a * a)
            + p.J_WEIGHT * (j * j) + p.D_WEIGHT * _penalty(d, p))


def _feasible(s, s_1, s_2, dt, p):
    prev_v = (s_1 - s_2) / dt
    v = (s - s_1) / dt
    a = (v - prev_v) / dt
    min_a = torch.clamp_min(a + p.MINIMUM_NEGATIVE_JERK * dt,
                            p.MAX_NEGATIVE_ACCELERATION)
    max_a = torch.clamp_max(a + p.MAXIMUM_POSITIVE_JERK * dt,
                            p.MAX_POSITIVE_ACCELERATION)
    min_v = torch.clamp_min(v + min_a * dt, 0.0)
    max_v = torch.clamp_max(v + max_a * dt, p.MAX_SPEED)
    return s + min_v * dt, s + max_v * dt


def _index_range(start_s, delta_s, lo_s, hi_s):
    """[ceil, trunc] cell indices of [lo_s, hi_s] (st_cy.pyx:78-93)."""
    lo_exact = (lo_s - start_s) / delta_s
    lo = lo_exact.to(torch.int32)
    lo = lo + (lo.to(lo_exact.dtype) < lo_exact).to(torch.int32)
    hi = ((hi_s - start_s) / delta_s).to(torch.int32)
    return lo, hi


def _backtrace(values, back, s_values):
    batch, num_t, _ = values.shape
    reach = torch.isfinite(values).any(dim=2)
    best_t = num_t - 1 - torch.argmax(torch.flip(reach, dims=(1,)).to(
        torch.uint8), dim=1)
    rows = torch.arange(batch, device=values.device)
    idx = torch.argmin(values[rows, best_t], dim=1)
    seq = torch.zeros((batch, num_t), dtype=s_values.dtype,
                      device=s_values.device)
    for t in range(num_t - 1, 0, -1):
        on = t <= best_t
        seq[:, t] = torch.where(on, s_values[rows, idx], 0.0)
        idx = torch.where(on, back[rows, t, idx], idx)
    seq[:, 0] = s_values[rows, idx]
    return seq


def solve_dp(obstacles, s_values, v0, a0, distances, p):
    """Jerk-limited lattice DP: (B, T) s sequences, zero past the last
    reachable layer."""
    batch, num_s = s_values.shape
    device, dtype = s_values.device, s_values.dtype
    t_values = torch.arange(p.num_t, dtype=dtype, device=device) \
        * const(float(p.T_DISCRETIZATION), s_values)
    dt = t_values[1] - t_values[0]
    delta_s = (s_values[:, 1] - s_values[:, 0])[:, None]
    start = s_values[:, :1]
    prev0 = s_values[:, 0] - v0 * dt
    second0 = prev0 - dt * (v0 - a0 * dt)
    v = torch.full_like(s_values, float("inf"))
    v[:, 0] = 0.0
    prev = prev0[:, None].expand_as(s_values).to(dtype)
    second = second0[:, None].expand_as(s_values).to(dtype)

    width = max_offset(p)
    offs = torch.arange(width - 1, -1, -1, dtype=torch.int64, device=device)
    j_idx = torch.arange(num_s, dtype=torch.int64, device=device)
    src = j_idx[None, :] - offs[:, None]                            # (D, S)
    src_ok = src >= 0
    src_c = torch.clamp_min(src, 0)
    rows = torch.arange(batch, device=device)[:, None]
    values, backs = [v], [torch.zeros_like(v, dtype=torch.int64)]
    for t in range(1, obstacles.shape[1]):
        lo_s, hi_s = _feasible(s_values, prev, second, dt, p)
        lo, hi = _index_range(start, delta_s, lo_s, hi_s)
        ok = src_ok & (j_idx >= lo[:, src_c]) & (j_idx <= hi[:, src_c]) \
            & ~obstacles[:, t, None, :]                             # (B, D, S)
        bi, di, ji = ok.nonzero(as_tuple=True)
        si = src_c[di, ji]
        cost = _edge_cost(s_values[bi, ji], s_values[bi, si], prev[bi, si],
                          second[bi, si], dt, distances[bi, t, ji], p)
        cand = torch.full(ok.shape, float("inf"), dtype=dtype, device=device)
        cand[bi, di, ji] = v[bi, si] + cost
        new_v = cand.amin(dim=1)
        i_star = j_idx - offs[torch.argmin(cand, dim=1)]
        settled = torch.isfinite(new_v)
        i_safe = torch.where(settled, i_star, 0)
        prev, second = (torch.where(settled, s_values[rows, i_safe], 0.0),
                        torch.where(settled, prev[rows, i_safe], 0.0))
        v = new_v
        values.append(new_v)
        backs.append(i_safe)
    return _backtrace(torch.stack(values, dim=1), torch.stack(backs, dim=1),
                      s_values)


def plan(state: State, p, dtype=torch.float32):
    """Grid, DP and trailing-zero trim (st.py:726-768): (seq (B, T),
    valid (B,) int32, obstacles, s_values, distances)."""
    obstacles, s_values, distances = build_grid(state, p, dtype)
    seq = solve_dp(obstacles, s_values, state.ego_speed.to(dtype),
                   state.ego_accel.to(dtype), distances, p).to(dtype)
    num_t = seq.shape[1]
    nonzero = torch.flip(seq, dims=(1,)) != 0.0
    trailing = torch.argmax(nonzero.to(torch.uint8), dim=1)
    valid = torch.where(~nonzero.any(dim=1), 1, num_t - trailing).to(
        torch.int32)
    return seq, valid, obstacles, s_values, distances


# --- ADMM smoother (st.py:584-723) ----------------------------------------

_BIG = 1e8


@functools.lru_cache(maxsize=4)
def _operator(n: int, dt: float, rho: float = 20.0):
    """Row-normalised velocity, acceleration and jerk rows, the start pin
    and the (inert) position rows; (2I + rho A^T A)^-1; row scales."""
    dt2, dt3 = dt * dt, dt * dt * dt
    rows = []
    for i in range(n - 1):
        r = np.zeros(n)
        r[i], r[i + 1] = -1.0 / dt, 1.0 / dt
        rows.append(r)
    for i in range(n - 1):
        r = np.zeros(n)
        if i == 0:
            r[0], r[1] = -1.0 / dt2, 1.0 / dt2
        else:
            r[i - 1], r[i], r[i + 1] = 1.0 / dt2, -2.0 / dt2, 1.0 / dt2
        rows.append(r)
    for i in range(n - 1):
        r = np.zeros(n)
        if i == 0:
            r[0], r[1] = -1.0 / dt3, 1.0 / dt3
        elif i == 1:
            r[0], r[1], r[2] = 2.0 / dt3, -3.0 / dt3, 1.0 / dt3
        else:
            r[i - 2], r[i - 1] = -1.0 / dt3, 3.0 / dt3
            r[i], r[i + 1] = -3.0 / dt3, 1.0 / dt3
        rows.append(r)
    r = np.zeros(n)
    r[0] = 1.0
    rows.append(r)
    rows.extend(np.eye(n))
    raw = np.stack(rows)
    scale = 1.0 / np.linalg.norm(raw, axis=1)
    a = raw * scale[:, None]
    solve = np.linalg.inv(2.0 * np.eye(n) + rho * (a.T @ a))
    return a, solve, scale, a.sum(axis=1), rho


def _interp(seq, valid, n, dt, coarse_dt):
    dtype = seq.dtype
    t_fine = torch.arange(n, dtype=dtype, device=seq.device) * dt
    pos = torch.minimum((t_fine / const(coarse_dt, t_fine))[None, :],
                        (valid - 1).to(dtype)[:, None])
    i0 = pos.to(torch.int32).to(torch.int64)
    i0 = torch.minimum(torch.clamp_min(i0, 0),
                       torch.clamp_min(valid - 2, 0)[:, None].to(torch.int64))
    w = pos - i0.to(dtype)
    return torch.gather(seq, 1, i0) * (1.0 - w) \
        + torch.gather(seq, 1, i0 + 1) * w


def smooth(seq, valid, v0, a0, p, tf32: bool = False):
    """The smoother QP on the tick grid: ((B, n) path, (B,) fine length).
    ``tf32``: its products in TF32 (the control)."""
    n, dt = p.fine_horizon, float(p.TICK_LENGTH)
    coarse_dt = float(p.T_DISCRETIZATION)
    dtype, batch, device = seq.dtype, seq.shape[0], seq.device
    dtc, dt2c = const(dt, seq), const(dt * dt, seq)
    b = _interp(seq, valid, n, dt, coarse_dt)
    nm1 = n - 1
    idx = torch.arange(nm1, dtype=dtype, device=device)
    v0_dt = v0 / dtc
    v0_dt2 = v0 / dt2c
    shift0 = a0 / dtc + v0_dt2

    def rows(value, row0=None, row1=None):
        r = torch.full((batch, nm1), value, dtype=dtype, device=device)
        if row0 is not None:
            r[:, 0] = r[:, 0] + row0
        if row1 is not None:
            r[:, 1] = r[:, 1] + row1
        return r

    v_lo, v_hi = rows(0.0), rows(p.MAX_SPEED)
    a_lo = rows(p.MAX_NEGATIVE_ACCELERATION, v0_dt)
    a_hi = rows(p.MAX_POSITIVE_ACCELERATION, v0_dt)
    j_lo = rows(p.MINIMUM_NEGATIVE_JERK, shift0, -v0_dt2)
    j_hi = rows(p.MAXIMUM_POSITIVE_JERK, shift0, -v0_dt2)
    t_last = (valid - 1).to(dtype) * coarse_dt
    fine_len = torch.round(t_last / dtc + 1.0).to(torch.int32)
    fine_len = fine_len - ((fine_len - 1).to(dtype) * dt > t_last).to(
        torch.int32)
    live = idx[None, :] + 1 <= (fine_len - 1).to(dtype)[:, None]
    v_lo, a_lo, j_lo = (torch.where(live, x, -_BIG) for x in (v_lo, a_lo,
                                                               j_lo))
    v_hi, a_hi, j_hi = (torch.where(live, x, _BIG) for x in (v_hi, a_hi,
                                                              j_hi))
    s0 = seq[:, :1]
    free = torch.full((batch, n), _BIG, dtype=dtype, device=device)
    lo = torch.cat([v_lo, a_lo, j_lo, s0, -free], dim=1)
    hi = torch.cat([v_hi, a_hi, j_hi, s0, free], dim=1)

    a_np, solve_np, scale_np, sums_np, rho_f = _operator(n, dt)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                           dtype=dtype)
    a_mat, a_t, solve, scale, sums = (put(a_np), put(a_np.T), put(solve_np),
                                      put(scale_np), put(sums_np))
    lo = lo * scale
    hi = hi * scale
    rho = const(rho_f, seq)
    alpha = const(1.6, seq)
    one_m_alpha = 1.0 - alpha
    shift = sums[None, :] * s0
    b_c = (b - s0).T.contiguous()
    lo_c = (lo - shift).T.contiguous()
    hi_c = (hi - shift).T.contiguous()
    x = b_c
    z = torch.minimum(torch.maximum(matmul(a_mat, x, tf32), lo_c), hi_c)
    u = torch.zeros_like(z)
    for _ in range(p.QP_ITERATIONS):
        x = matmul(solve, 2.0 * b_c + rho * matmul(a_t, z - u, tf32), tf32)
        ax = alpha * matmul(a_mat, x, tf32) + one_m_alpha * z
        z = torch.minimum(torch.maximum(ax + u, lo_c), hi_c)
        u = u + ax - z
    return (x.T + s0).contiguous(), fine_len


def st_control(state: State, p, dtype=torch.float32, tf32: bool = False):
    """do_st_control (st.py:757-783): the first step of the smoothed plan
    as a speed command, the current speed where the plan has <= 1 point.
    Returns (speed (B,), fine (B, n), fine_len (B,))."""
    seq, valid = plan(state, p, dtype)[:2]
    v0 = state.ego_speed.to(dtype)
    a0 = state.ego_accel.to(dtype)
    fine, fine_len = smooth(seq, valid, v0, a0, p, tf32)
    speed = (fine[:, 1] - fine[:, 0]) / const(float(p.TICK_LENGTH), fine)
    return torch.where(fine_len <= 1, v0, speed), fine, fine_len


def certificate(state: State, p, dtype=torch.float32):
    """test_guaranteed_crash (st.py:790-802): True where no complete
    horizon path exists or the path passes closer than
    COMBINATION_MIN_DISTANCE - CAR_LENGTH to an obstacle."""
    seq, valid, _, s_values, distances = plan(state, p, dtype)
    num_t = seq.shape[1]
    delta_s = s_values[:, 1] - s_values[:, 0]
    idx = ((seq - s_values[:, :1]) / delta_s[:, None]).to(torch.int32)
    idx = idx.clamp(0, s_values.shape[1] - 1).to(torch.int64)
    d = torch.gather(distances, 2, idx[:, :, None])[..., 0]
    t_iota = torch.arange(num_t, device=seq.device)
    close = ((t_iota[None, :] < valid[:, None])
             & (d < p.COMBINATION_MIN_DISTANCE - p.CAR_LENGTH)).any(dim=1)
    return (valid < num_t) | close
