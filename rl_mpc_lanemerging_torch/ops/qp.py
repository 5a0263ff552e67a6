"""Batched trajectory-smoothing QP via ADMM.

Port of ``rl_mpc_lanemerging_tpu/ops/qp.py`` (the reference's cvxopt
``finer_fit`` smoother, st.py:584-723).  Per scenario:

    min ||x - b||^2   s.t.   lo <= A x <= hi

with ``x`` the fine-grid s trajectory (n = cfg.fine_horizon), ``b`` the
linear interpolation of the coarse DP path, and ``A`` the row-normalized
velocity / acceleration / jerk difference operators plus the start-point pin
and the position rows (the lead/trail corridor, inert unless bounds are
given).  The operator is static: it and its ADMM
normal-matrix inverse are built once per configuration on the host in
numpy, then moved to the device once.  The batched solve is plain
(B, m) x (m, n) products, which go to ``torch.matmul``; they must run in
true fp32 (the controller turns TF32 off).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import const

__all__ = ["QPOperator", "build_operator", "finer_fit_qp"]

_BIG = 1e8


class QPOperator(NamedTuple):
    """Static, host-precomputed pieces of the smoothing QP."""

    a: np.ndarray          # (m, n) row-scaled constraint operator
    solve: np.ndarray      # (n, n) = (2I + rho * A^T A)^{-1}
    row_scale: np.ndarray  # (m,) applied to bounds
    a_row_sums: np.ndarray  # (m,) A @ 1, for recentering the solve at s0
    rho: float
    n: int
    delta_t: float


@functools.lru_cache(maxsize=16)
def build_operator(n: int, delta_t: float, rho: float = 20.0) -> QPOperator:
    """Assemble the constraint operator for an n-point fine grid.

    Row layout (interior rows mirror reference st.py:608-668):
      [0, n-1):        velocity rows  (x[i+1]-x[i])/dt
      [n-1, 2n-2):     acceleration rows; row 0 is the boundary form
      [2n-2, 3n-3):    jerk rows; rows 0 and 1 are the boundary forms
      [3n-3]:          start equality e_0
      [3n-2, 4n-2):    position rows (the corridor; inert at +-_BIG
                       unless ``finer_fit_qp`` is given bounds)
    """
    dt = float(delta_t)
    dt2, dt3 = dt * dt, dt * dt * dt
    rows = []
    for i in range(n - 1):          # velocity
        r = np.zeros(n)
        r[i], r[i + 1] = -1.0 / dt, 1.0 / dt
        rows.append(r)
    for i in range(n - 1):          # acceleration
        r = np.zeros(n)
        if i == 0:
            r[0], r[1] = -1.0 / dt2, 1.0 / dt2
        else:
            r[i - 1], r[i], r[i + 1] = 1.0 / dt2, -2.0 / dt2, 1.0 / dt2
        rows.append(r)
    for i in range(n - 1):          # jerk
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
    r[0] = 1.0                      # start pin
    rows.append(r)
    for i in range(n):              # position rows
        r = np.zeros(n)
        r[i] = 1.0
        rows.append(r)
    a_raw = np.stack(rows)

    row_scale = 1.0 / np.linalg.norm(a_raw, axis=1)
    a = a_raw * row_scale[:, None]
    solve = np.linalg.inv(2.0 * np.eye(n) + rho * (a.T @ a))
    return QPOperator(a=a, solve=solve, row_scale=row_scale,
                      a_row_sums=a.sum(axis=1), rho=rho, n=n, delta_t=dt)


_DEVICE_OPS: dict = {}


def _device_operator(op: QPOperator, device, dtype):
    """(A, A^T, solve^T, row_scale, a_row_sums) on the device, moved once
    per (operator, device, dtype)."""
    key = (op.n, op.delta_t, op.rho, str(device), dtype)
    if key not in _DEVICE_OPS:
        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x)).to(
                device=device, dtype=dtype)
        _DEVICE_OPS[key] = (put(op.a), put(op.a.T), put(op.solve.T),
                            put(op.row_scale), put(op.a_row_sums))
    return _DEVICE_OPS[key]


def _interp_coarse(coarse_seq, valid_len, n, delta_t, coarse_delta_t):
    """Linear interpolation of the (possibly trimmed) coarse paths (B, T)
    onto the fine grid, clamped at the last valid coarse point (reference
    st.py:596-598 via scipy.interp1d on the trimmed sequence)."""
    dtype = coarse_seq.dtype
    t_fine = torch.arange(n, dtype=dtype, device=coarse_seq.device) * delta_t
    pos = t_fine / const(coarse_delta_t, t_fine)                   # (n,)
    last = (valid_len - 1).to(dtype)[:, None]
    pos = torch.minimum(pos[None, :], last)                        # (B, n)
    i0 = pos.to(torch.int32).to(torch.int64)
    i0 = torch.minimum(torch.clamp_min(i0, 0),
                       torch.clamp_min(valid_len - 2, 0)[:, None].to(
                           torch.int64))
    w = pos - i0.to(dtype)
    c0 = torch.gather(coarse_seq, 1, i0)
    c1 = torch.gather(coarse_seq, 1, i0 + 1)
    return c0 * (1.0 - w) + c1 * w


def finer_fit_qp(coarse_seq, valid_len, start_speed, start_acceleration,
                 op: QPOperator, coarse_delta_t: float,
                 max_speed: float, pos_accel: float, neg_accel: float,
                 pos_jerk: float, neg_jerk: float, iterations: int = 100,
                 pos_lo=None, pos_hi=None):
    """Smooth a batch of coarse DP paths onto the fine tick grid.

    Args:
      coarse_seq: (B, T) DP paths, trailing zeros allowed past ``valid_len``.
      valid_len: (B,) int, number of valid coarse points (>= 1).
      start_speed/start_acceleration: (B,) measured ego state entering the
        boundary-row bounds (reference st.py:628, 638, 648, 653, 664, 666).
      op: static operator from :func:`build_operator`.
      iterations: fixed ADMM iteration count.
      pos_lo/pos_hi: optional (B, n) position corridor (reference
        st.py:672-705), +-inf allowed; the start row and the rows past the
        fine length are relaxed.

    Returns ((B, n) smoothed trajectories, (B,) fine lengths).
    """
    n = op.n
    dtype = coarse_seq.dtype
    batch = coarse_seq.shape[0]
    dt = op.delta_t
    dt2 = dt * dt
    dtc = const(dt, coarse_seq)
    dt2c = const(dt2, coarse_seq)

    b = _interp_coarse(coarse_seq, valid_len, n, dt, coarse_delta_t)

    nm1 = n - 1
    idx = torch.arange(nm1, dtype=dtype, device=coarse_seq.device)
    v0_dt = start_speed / dtc
    v0_dt2 = start_speed / dt2c
    shift0 = start_acceleration / dtc + v0_dt2

    def bound_rows(value, row0=None, row1=None):
        rows = torch.full((batch, nm1), value, dtype=dtype,
                          device=coarse_seq.device)
        if row0 is not None:
            rows[:, 0] = rows[:, 0] + row0
        if row1 is not None:
            rows[:, 1] = rows[:, 1] + row1
        return rows

    v_lo, v_hi = bound_rows(0.0), bound_rows(max_speed)
    a_lo, a_hi = bound_rows(neg_accel, v0_dt), bound_rows(pos_accel, v0_dt)
    j_lo = bound_rows(neg_jerk, shift0, -v0_dt2)
    j_hi = bound_rows(pos_jerk, shift0, -v0_dt2)

    # deactivate rows whose stencil reaches past the valid fine horizon;
    # fine length mirrors reference st.py:590-594 (round half to even, then
    # trimmed back if it overshoots the coarse horizon)
    t_last = (valid_len - 1).to(dtype) * coarse_delta_t
    fine_len = torch.round(t_last / dtc + 1.0).to(torch.int32)
    fine_len = fine_len - ((fine_len - 1).to(dtype) * dt
                           > t_last).to(torch.int32)
    live = idx[None, :] + 1 <= (fine_len - 1).to(dtype)[:, None]
    v_lo = torch.where(live, v_lo, -_BIG)
    v_hi = torch.where(live, v_hi, _BIG)
    a_lo = torch.where(live, a_lo, -_BIG)
    a_hi = torch.where(live, a_hi, _BIG)
    j_lo = torch.where(live, j_lo, -_BIG)
    j_hi = torch.where(live, j_hi, _BIG)

    # corridor rows: per-step position box (reference st.py:672-705); the
    # start point is pinned anyway, so its corridor row is relaxed
    s0 = coarse_seq[:, :1]
    live_pos = torch.arange(n, device=coarse_seq.device)[None, :] \
        <= (fine_len - 1)[:, None]
    live_pos[:, 0] = False

    def corridor(bound, big):
        if bound is None:
            return torch.full((batch, n), big, dtype=dtype,
                              device=coarse_seq.device)
        return torch.where(live_pos, bound.to(dtype), big)

    lo = torch.cat([v_lo, a_lo, j_lo, s0, corridor(pos_lo, -_BIG)], dim=1)
    hi = torch.cat([v_hi, a_hi, j_hi, s0, corridor(pos_hi, _BIG)], dim=1)

    a_mat, a_t, solve_t, scale, row_sums = _device_operator(
        op, coarse_seq.device, dtype)
    lo = lo * scale
    hi = hi * scale
    rho = const(op.rho, coarse_seq)
    alpha = const(1.6, coarse_seq)        # over-relaxation
    one_m_alpha = 1.0 - alpha

    # Recenter on the start point: the iterates carry |x| ~ 1e-1..1e1
    # instead of the absolute s coordinate (~1e2).  Reduced-precision
    # products (bf16 on the TPU, TF32 on the GPU) make this ADMM converge
    # to garbage; the controller pins fp32 matmuls.
    shift_rows = row_sums[None, :] * s0                       # A @ (s0 * 1)
    b_c = b - s0
    lo_c = lo - shift_rows
    hi_c = hi - shift_rows

    x = b_c
    z = torch.minimum(torch.maximum(x @ a_t, lo_c), hi_c)
    u = torch.zeros_like(z)
    for _ in range(iterations):
        rhs = 2.0 * b_c + rho * ((z - u) @ a_mat)
        x = rhs @ solve_t
        ax = alpha * (x @ a_t) + one_m_alpha * z
        z = torch.minimum(torch.maximum(ax + u, lo_c), hi_c)
        u = u + ax - z
    return x + s0, fine_len
