"""Peaks of the chip and the work of the lattice DP kernel (K1).

The least time K1 could take on a launch is the larger of the bytes its
inputs make it move over the HBM bandwidth and its float operations over
the f32 peak.  Both are counted for the launch's own inputs, as the
repository's chip_smoke.py counts them: the kernel visits, per layer and
scenario, only the window of cells its reachable sources can step to, and
only the (source, offset) pairs inside each source's jerk-limited band.
:func:`k1_work` counts those by running the kernel's algorithm in plain
torch (a frozen copy of ``_wavefront_tables_banded``, the counting kept,
the backpointers dropped).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "OPS_PER_PAIR",
           "OPS_PER_CELL", "k1_bytes", "k1_ops", "k1_least_s", "k1_work"]

# H100 SXM, NVIDIA's data sheet, dense rates, 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations per (source, offset) pair: subtract, multiply, add,
# compare; per reachable cell and layer: the band and moments (38), the
# penalty (6), the penalty add and the sentinel compare
OPS_PER_PAIR = 4
OPS_PER_CELL = 46

_BIG = 3e30
_NO_KEY = torch.iinfo(torch.int64).max


def k1_bytes(window_cells: int, batch: int, num_t: int) -> int:
    """Obstacles (1 B) and distances (4 B) of the window cells, s_values at
    the T cells of each path, the start state (8 B) and the (B, T) f32
    sequences written."""
    return window_cells * 5 + batch * num_t * 4 + batch * 8 \
        + batch * num_t * 4


def k1_ops(pairs: int, cells: int) -> int:
    return pairs * OPS_PER_PAIR + cells * OPS_PER_CELL


def k1_least_s(window_cells: int, pairs: int, cells: int, batch: int,
               num_t: int) -> float:
    return max(k1_bytes(window_cells, batch, num_t) / HBM_BYTES_PER_S,
               k1_ops(pairs, cells) / F32_OPS_PER_S)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _constants(p, device):
    dt, ds = float(p.T_DISCRETIZATION), float(p.S_DISCRETIZATION)
    c_a = p.A_WEIGHT / dt ** 4
    c_j = p.J_WEIGHT / dt ** 6
    c_v = p.V_WEIGHT / dt ** 2
    big_d = p.DESIRED_SPEED * dt
    c_tot = c_a + c_j + c_v
    sq_tot = c_tot ** 0.5
    vals = dict(dt=dt, inv_ds=1.0 / ds, ds=ds, c_a=c_a, c_j=c_j, c_v=c_v,
                cvd=c_v * big_d, big_d=big_d, inv_c_tot=1.0 / c_tot,
                sq_tot=sq_tot, ds_sq_tot=ds * sq_tot,
                njl_dt=p.MINIMUM_NEGATIVE_JERK * dt,
                pjl_dt=p.MAXIMUM_POSITIVE_JERK * dt,
                nal=p.MAX_NEGATIVE_ACCELERATION,
                pal=p.MAX_POSITIVE_ACCELERATION, max_speed=p.MAX_SPEED)
    return {k: torch.tensor(float(np.float32(v)), dtype=torch.float32,
                            device=device) for k, v in vals.items()}


def _band_and_moments(k, vcur, u, beta):
    wv = 2.0 * u - beta
    v = u / k["dt"]
    prev_v = wv / k["dt"]
    a = (v - prev_v) / k["dt"]
    min_a = torch.maximum(a + k["njl_dt"], k["nal"])
    max_a = torch.minimum(a + k["pjl_dt"], k["pal"])
    min_v = torch.clamp_min(v + min_a * k["dt"], 0.0)
    max_v = torch.minimum(v + max_a * k["dt"], k["max_speed"])
    xlo = min_v * k["dt"] * k["inv_ds"]
    xhi = max_v * k["dt"] * k["inv_ds"]
    m = (k["c_a"] * u + k["c_j"] * beta + k["cvd"]) * k["inv_c_tot"]
    eu, eb, ed = u - m, beta - m, k["big_d"] - m
    kk = k["c_a"] * (eu * eu) + k["c_j"] * (eb * eb) + k["c_v"] * (ed * ed)
    return m * k["sq_tot"], kk + vcur, xlo, xhi


def _integer_band(xlo, xhi, d_pad: int):
    lo = torch.clamp(torch.ceil(xlo), 0.0, float(d_pad))
    hi = torch.clamp(torch.floor(xhi), -1.0, float(d_pad - 1))
    ok = (xlo <= xhi) & (lo <= hi)
    return (torch.where(ok, lo, 1.0).to(torch.int64),
            torch.where(ok, hi, 0.0).to(torch.int64))


def _order_key(x):
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)


def _unpack(key):
    bits = (key >> 32).to(torch.int32)
    cost = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).view(
        torch.float32)
    return cost, key & 0xFFFFFFFF


def _penalty(obstacles, distances, p, s_pad: int):
    d = distances.to(torch.float32)
    pen = torch.where(d < p.MIN_ALLOWED_DISTANCE,
                      torch.reciprocal(torch.clamp_min(d, 1.0)) * 1e6,
                      torch.reciprocal(d))
    pen = torch.where(obstacles, _BIG, p.D_WEIGHT * pen)
    return torch.nn.functional.pad(pen, (0, s_pad - pen.shape[-1]),
                                   value=_BIG)


def _work_block(obstacles, distances, v0, a0, p):
    batch, num_t, num_s = obstacles.shape
    device = obstacles.device
    max_offset = int(p.MAX_SPEED * p.T_DISCRETIZATION
                     / p.S_DISCRETIZATION) + 2
    s_pad, d_pad = _round_up(num_s, 64), _round_up(max_offset, 8)
    pen = _penalty(obstacles, distances, p, s_pad)
    k = _constants(p, device)
    cells = torch.arange(s_pad, device=device)
    d_iota = torch.arange(d_pad, device=device)
    xt = d_iota.to(torch.float32) * k["ds_sq_tot"]
    u0 = v0 * k["dt"]
    w0 = k["dt"] * (v0 - a0 * k["dt"])
    b0 = 2.0 * v0 * k["dt"] - w0
    mt0, k20, xlo0, xhi0 = _band_and_moments(k, torch.zeros_like(v0), u0, b0)
    lo0, hi0 = _integer_band(xlo0, xhi0, d_pad)
    mt = torch.zeros((batch, s_pad), dtype=torch.float32, device=device)
    k2, u = mt.clone(), mt.clone()
    dlo = torch.ones((batch, s_pad), dtype=torch.int64, device=device)
    dhi = torch.zeros_like(dlo)
    mt[:, 0], k2[:, 0], u[:, 0], dlo[:, 0], dhi[:, 0] = mt0, k20, u0, lo0, hi0
    pairs = reach_cells = window = 0
    for t in range(1, num_t):
        n_src = min((d_pad - 1) * (t - 1) + 1, num_s)
        dest = cells[:n_src, None] + d_iota[None, :]
        live = (d_iota >= dlo[:, :n_src, None]) \
            & (d_iota <= dhi[:, :n_src, None]) & (dest < num_s)
        diff = xt - mt[:, :n_src, None]
        cand = diff * diff + k2[:, :n_src, None]
        key = torch.where(live & (cand < _BIG),
                          (_order_key(cand) << 32) + (d_pad - 1 - d_iota),
                          _NO_KEY)
        settled = torch.full((batch, s_pad), _NO_KEY, device=device)
        settled.scatter_reduce_(
            1, dest.clamp_max(s_pad - 1).expand(batch, -1, -1).reshape(
                batch, -1), key.reshape(batch, -1), "amin")
        found = settled != _NO_KEY
        least, low = _unpack(settled)
        best = torch.where(found, least, _BIG)
        bestd = torch.where(found, d_pad - 1 - low, -1)
        usel = torch.where(
            found, torch.gather(u, 1, cells - bestd.clamp_min(0)), 0.0)
        new_v = torch.where(best < _BIG, best + pen[:, t], _BIG)
        new_v = torch.where(cells < num_s, new_v, _BIG)
        reach = new_v < _BIG
        first = torch.where(live, dest, s_pad).amin(dim=(1, 2))
        last = torch.where(live, dest, -1).amax(dim=(1, 2))
        pairs += int(live.sum())
        reach_cells += int(reach.sum())
        window += int((last - first + 1).clamp_min(0).sum())
        u_new = bestd.to(torch.float32) * k["ds"]
        mt, k2, xlo, xhi = _band_and_moments(k, new_v, u_new,
                                             2.0 * u_new - usel)
        u = u_new
        lo_n, hi_n = _integer_band(xlo, xhi, d_pad)
        dlo = torch.where(reach, lo_n, 1)
        dhi = torch.where(reach, hi_n, 0)
    return pairs, reach_cells, window


def k1_work(obstacles, distances, ego_speed, ego_accel, p, block: int = 128):
    """(pairs, reachable cells, window cells) of one launch on these inputs,
    summed over its layers and scenarios, in blocks of ``block`` rows."""
    total = [0, 0, 0]
    for i in range(0, obstacles.shape[0], block):
        sl = slice(i, i + block)
        part = _work_block(obstacles[sl], distances[sl],
                           ego_speed[sl].to(torch.float32).contiguous(),
                           ego_accel[sl].to(torch.float32).contiguous(), p)
        total = [a + b for a, b in zip(total, part)]
    return tuple(total)
