"""The ST lattice wavefront DP: CUDA kernel wrapper and its plain versions.

Port of ``rl_mpc_lanemerging_tpu/ops/st_pallas.py`` (``make_pallas_solver``
and its Pallas ``_kernel``, the one TPU kernel of the repository).  The
kernel is ``csrc/st_wavefront.cu``; its header holds the design.  On the
card one launch maps obstacles, distances, s values and the start state to
the s sequences: the penalty fold, the layered sweep and the backtrace all
run inside the kernel, so no penalty tensor and no backpointer table reach
device memory.  What bounds it there is latency (17 dependent layers of two
barriers each), not bytes or operations: the sweep visits only the offsets
inside each reachable source's band, and each layer touches only the window
of cells its predecessor can reach.

* :func:`st_wavefront` is the wrapper.  On a CUDA tensor it launches the
  kernel (or raises); on a CPU tensor it takes the plain version.  Each
  launch adds one to the module-level ``launches``.
* :func:`st_wavefront_reference` is the plain PyTorch yardstick of the
  kernel's arithmetic: the penalty fold (:func:`fold_penalty`), the f32
  weighted-variance cost form, the float feasibility band scanned over every
  offset, the (cost, -d) tie rule, the ``_BIG`` sentinel and the backtrace
  (``_backtrace``).  Every float operation is a separate elementwise op
  (``x * x``, no fused forms), so that on the card it matches the
  ``-fmad=false`` kernel op for op.  The tests use it, and ``chip_smoke.py``
  holds the kernel against it; the controller never calls it on the card.
* ``st_wavefront_reference(..., banded=True)`` runs the kernel's own
  algorithm in plain torch (``_wavefront_tables_banded``): integer bands,
  reachable sources only, a packed-key scatter minimum.  It exists so that
  the algorithm is tested against the scan on the CPU; nothing on the card
  path calls it.

All return the same contract as ``st_dp.solve_st_fast``: s sequences (B, T),
zero-filled past the last reachable layer.  The kernel path differs from the
dense twin (which follows the reference's f64 expression order) on a small
fraction of f32 near-ties.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .st_dp import STWeights

__all__ = ["st_wavefront", "st_wavefront_reference", "prepare_launch",
           "fold_penalty", "launches", "kernel_shapes", "BIG"]

BIG = 3e30               # the JAX kernel's _BIG sentinel
_KERNEL = "st_wavefront"
_MAX_SMEM = 232448       # bytes of shared memory one block may use (H100)
_MAX_D_PAD = 256         # offsets are stored as bytes
_THREADS = 1024          # threads per block: a thread per cell and candidate
_NO_KEY = torch.iinfo(torch.int64).max     # no candidate reached the cell

launches = 0             # kernel launches since import (or last reset)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_shapes(num_s: int, max_offset: int):
    """(s_pad, d_pad): the padded cell and offset counts of the wavefront,
    as in the JAX kernel (3008 and 184 at st_default)."""
    return _round_up(num_s, 64), _round_up(max_offset, 8)


def _kernel_constants(delta_t: float, delta_s: float, w: STWeights):
    """Scalar constants in double on the host, as st_pallas.py:76-83 computes
    them in Python, each rounded once to f32 (the csrc Consts order)."""
    dt, ds = float(delta_t), float(delta_s)
    c_a = w.a_weight / (dt ** 4)
    c_j = w.j_weight / (dt ** 6)
    c_v = w.v_weight / (dt ** 2)
    big_d = w.desired_speed * dt
    c_tot = c_a + c_j + c_v
    sq_tot = c_tot ** 0.5
    return np.asarray([
        dt, 1.0 / ds, ds, c_a, c_j, c_v, c_v * big_d, big_d, 1.0 / c_tot,
        sq_tot, ds * sq_tot, w.negative_jerk_limit * dt,
        w.positive_jerk_limit * dt, w.negative_acceleration_limit,
        w.positive_acceleration_limit, w.max_speed, w.d_weight,
        w.min_allowed_distance], np.float32)


def fold_penalty(obstacles, distances, w: STWeights, s_pad: int):
    """Obstacle mask and distance penalty folded into one (B, T, s_pad) f32
    tensor (st_pallas.py:275-282): _BIG on obstacles and padding.  A scalar
    over a tensor is torch's reciprocal times the scalar; it is written out
    because the kernel repeats these operations one for one."""
    dist = distances.to(torch.float32)
    pen = torch.where(dist < w.min_allowed_distance,
                      torch.reciprocal(torch.clamp_min(dist, 1.0)) * 1e6,
                      torch.reciprocal(dist))
    pen = w.d_weight * pen
    pen = torch.where(obstacles, BIG, pen)
    return torch.nn.functional.pad(pen, (0, s_pad - pen.shape[-1]),
                                   value=BIG).contiguous()


def _backtrace(bp, vmin, amin, s_values):
    """Backpointer walk (st_pallas.py:335-359): from the argmin of the last
    layer with a finite minimum back to layer 0; zeros past that layer."""
    batch, num_t = vmin.shape
    finite = vmin < BIG
    finite[:, 0] = True
    t_iota = torch.arange(num_t, device=vmin.device)
    best_t = torch.where(finite, t_iota, 0).amax(dim=1)            # (B,)
    amin = amin.to(torch.int64)
    amin[:, 0] = 0
    idx = torch.gather(amin, 1, best_t[:, None])[:, 0]
    rows = torch.arange(batch, device=vmin.device)
    s_idx = torch.empty((batch, num_t), dtype=torch.int64,
                        device=vmin.device)
    for t in range(num_t - 1, 0, -1):
        active = t <= best_t
        nxt = bp[rows, t, idx].to(torch.int64)
        s_idx[:, t] = torch.where(active, idx, -1)
        idx = torch.where(active, nxt, idx)
    s_idx[:, 0] = idx
    vals = torch.gather(s_values, 1, s_idx.clamp_min(0))
    return torch.where(s_idx >= 0, vals, 0.0)


def _band_and_moments(k, vcur, u, beta):
    """st_pallas.py:92-125, one elementwise op at a time; ``k`` holds the
    f32 constants (0-dim tensors) and the divisor ``dt``."""
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
    eu = u - m
    eb = beta - m
    ed = k["big_d"] - m
    kk = k["c_a"] * (eu * eu) + k["c_j"] * (eb * eb) + k["c_v"] * (ed * ed)
    return m * k["sq_tot"], kk + vcur, xlo, xhi


_CONST_NAMES = ("dt", "inv_ds", "ds", "c_a", "c_j", "c_v", "cvd", "big_d",
                "inv_c_tot", "sq_tot", "ds_sq_tot", "njl_dt", "pjl_dt",
                "nal", "pal", "max_speed", "d_weight", "min_allowed")


def _wavefront_tables_reference(pen, v0, a0, consts, num_s: int, d_pad: int,
                                work=None):
    """The kernel's DP in plain torch: (bp, vmin, amin) as the kernel writes
    them, for pen (B, T, s_pad) and f32 start speed/acceleration (B,).

    ``work``, when a list, receives per layer the (source, offset) pairs
    from reachable sources inside their band, and the reachable cells: the
    work this input needs, for a measured bound."""
    batch, num_t, s_pad = pen.shape
    device = pen.device
    k = {name: torch.tensor(float(val), dtype=torch.float32, device=device)
         for name, val in zip(_CONST_NAMES, consts)}
    rows = d_pad + s_pad
    r_iota = torch.arange(rows, device=device)

    # layer 0: only the origin row d_pad is reachable
    u0 = (v0 * k["dt"])[:, None].expand(batch, rows)
    w0 = k["dt"] * (v0 - a0 * k["dt"])
    b0 = (2.0 * v0 * k["dt"] - w0)[:, None].expand(batch, rows)
    vcur = torch.where(r_iota == d_pad, 0.0, BIG).to(torch.float32)
    mt, k2, xlo, xhi = _band_and_moments(k, vcur[None, :], u0, b0)
    pad_rows = r_iota < d_pad          # sources with s < 0: never feasible
    xlo = torch.where(pad_rows, 1.0, xlo)
    xhi = torch.where(pad_rows, -1.0, xhi)
    u = u0.clone()

    bp = torch.zeros((batch, num_t, s_pad), dtype=torch.int32, device=device)
    vmin = torch.zeros((batch, num_t), dtype=torch.float32, device=device)
    amin = torch.zeros((batch, num_t), dtype=torch.int32, device=device)
    d_iota = torch.arange(d_pad, device=device)
    d_f = d_iota.to(torch.float32)
    xt = d_f * k["ds_sq_tot"]                                      # (D,)
    j_all = torch.arange(s_pad, device=device)
    for t in range(1, num_t):
        hi = min(d_pad * t + 1, num_s)     # layer t reaches indices < hi
        src = torch.arange(hi, device=device)[None, :] - d_iota[:, None] \
            + d_pad                                                # (D, hi)
        feas = (d_f[None, :, None] >= xlo[:, src]) \
            & (d_f[None, :, None] <= xhi[:, src])                  # (B, D, hi)
        diff = xt[None, :, None] - mt[:, src]
        cand = diff * diff + k2[:, src]
        # the kernel's ascending-d scan from (BIG, -1) with the (cost, -d)
        # rule: the least candidate <= BIG, the largest d among its ties
        ok = feas & (cand <= BIG)
        least = torch.where(ok, cand, float("inf")).amin(dim=1)    # (B, hi)
        tied = ok & (cand == least[:, None, :])
        bestd = torch.where(tied, d_iota[None, :, None], -1).amax(dim=1)
        found = bestd >= 0
        best = torch.where(found, least, BIG)
        usel = torch.where(
            found,
            torch.gather(u, 1, torch.arange(hi, device=device)[None, :]
                         - bestd.clamp_min(0) + d_pad),
            0.0)
        fill = s_pad - hi
        best = torch.nn.functional.pad(best, (0, fill), value=BIG)
        bestd = torch.nn.functional.pad(bestd, (0, fill), value=-1)
        usel = torch.nn.functional.pad(usel, (0, fill), value=0.0)

        new_v = torch.where(best < BIG, best + pen[:, t], BIG)
        new_v = torch.where(j_all < num_s, new_v, BIG)
        if work is not None:
            work.append((int((feas & (k2[:, src] < BIG)).sum()),
                         int((new_v < BIG).sum())))
        u_new = bestd.to(torch.float32) * k["ds"]
        b_new = 2.0 * u_new - usel
        mt_n, k2_n, xlo_n, xhi_n = _band_and_moments(k, new_v, u_new, b_new)
        mt = torch.cat([mt[:, :d_pad], mt_n], dim=1)
        k2 = torch.cat([k2[:, :d_pad], k2_n], dim=1)
        u = torch.cat([u[:, :d_pad], u_new], dim=1)
        xlo = torch.cat([xlo[:, :d_pad], xlo_n], dim=1)
        xhi = torch.cat([xhi[:, :d_pad], xhi_n], dim=1)
        bp[:, t] = (j_all - bestd).to(torch.int32)
        vmin[:, t] = new_v.amin(dim=1)
        amin[:, t] = torch.argmin(new_v, dim=1).to(torch.int32)
    return bp, vmin, amin


def _order_key(x):
    """f32 -> int64 whose integer order is the float order: the bits of a
    non-negative float as they are, the low 31 bits of a negative one
    flipped.  (The kernel uses the same map shifted into unsigned order.)"""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)


def _from_order_key(key):
    bits = key.to(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).view(torch.float32)


def _pack_key(cost, low):
    """(cost, low) as one int64 whose minimum is the lexicographic minimum:
    the cost's order key in the high word, ``low`` (0 <= low < 2**32) in the
    low word.  The sweep packs ``d_pad - 1 - d`` so that among equal costs
    the largest offset wins; the layer minimum packs the cell index."""
    return (_order_key(cost) << 32) + low


def _unpack_key(key):
    return _from_order_key(key >> 32), key & 0xFFFFFFFF


def _integer_band(xlo, xhi, d_pad: int):
    """The integer offsets of the float band: {d : d >= xlo and d <= xhi}
    over d in [0, d_pad) is [ceil(xlo), floor(xhi)] clamped, the clamp taken
    on the floats before the conversion.  (1, 0) stands for every empty
    band: xlo > xhi, a NaN threshold, a band wholly outside [0, d_pad)."""
    lo = torch.clamp(torch.ceil(xlo), 0.0, float(d_pad))
    hi = torch.clamp(torch.floor(xhi), -1.0, float(d_pad - 1))
    ok = (xlo <= xhi) & (lo <= hi)
    return (torch.where(ok, lo, 1.0).to(torch.int64),
            torch.where(ok, hi, 0.0).to(torch.int64))


def _wavefront_tables_banded(pen, v0, a0, consts, num_s: int, d_pad: int,
                             work=None):
    """The kernel's algorithm in plain torch, same arguments and tables as
    :func:`_wavefront_tables_reference`: every reachable source pushes the
    candidates of its integer band to destinations src + d, and a scatter
    minimum over packed (cost, d_pad-1-d) keys settles each destination.
    The tables agree with the scan's on every reachable cell (an unreachable
    cell has bp = j + 1 and the layer's amin is 0 when nothing is reachable).

    ``work``, when a list, receives per layer the (source, offset) pairs
    pushed, the reachable cells, and the cells of the layer's windows (per
    scenario from the least to the greatest destination pushed to): what the
    kernel visits and reads."""
    batch, num_t, s_pad = pen.shape
    device = pen.device
    k = {name: torch.tensor(float(val), dtype=torch.float32, device=device)
         for name, val in zip(_CONST_NAMES, consts)}
    cells = torch.arange(s_pad, device=device)
    d_iota = torch.arange(d_pad, device=device)
    xt = d_iota.to(torch.float32) * k["ds_sq_tot"]                 # (D,)

    # layer 0: only the origin cell is reachable
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

    bp = torch.zeros((batch, num_t, s_pad), dtype=torch.int32, device=device)
    vmin = torch.zeros((batch, num_t), dtype=torch.float32, device=device)
    amin = torch.zeros((batch, num_t), dtype=torch.int32, device=device)
    for t in range(1, num_t):
        n_src = min((d_pad - 1) * (t - 1) + 1, num_s)  # layer t-1's reach
        dest = cells[:n_src, None] + d_iota[None, :]               # (n, D)
        live = (d_iota >= dlo[:, :n_src, None]) \
            & (d_iota <= dhi[:, :n_src, None]) & (dest < num_s)   # (B, n, D)
        diff = xt - mt[:, :n_src, None]
        cand = diff * diff + k2[:, :n_src, None]
        key = torch.where(live & (cand < BIG),
                          _pack_key(cand, d_pad - 1 - d_iota), _NO_KEY)
        settled = torch.full((batch, s_pad), _NO_KEY, device=device)
        settled.scatter_reduce_(
            1, dest.clamp_max(s_pad - 1).expand(batch, -1, -1).reshape(
                batch, -1), key.reshape(batch, -1), "amin")

        found = settled != _NO_KEY
        least, low = _unpack_key(settled)
        best = torch.where(found, least, BIG)
        bestd = torch.where(found, d_pad - 1 - low, -1)
        usel = torch.where(
            found, torch.gather(u, 1, cells - bestd.clamp_min(0)), 0.0)
        new_v = torch.where(best < BIG, best + pen[:, t], BIG)
        new_v = torch.where(cells < num_s, new_v, BIG)
        reach = new_v < BIG
        if work is not None:
            first = torch.where(live, dest, s_pad).amin(dim=(1, 2))
            last = torch.where(live, dest, -1).amax(dim=(1, 2))
            work.append((int(live.sum()), int(reach.sum()),
                         int((last - first + 1).clamp_min(0).sum())))
        u_new = bestd.to(torch.float32) * k["ds"]
        b_new = 2.0 * u_new - usel
        mt, k2, xlo, xhi = _band_and_moments(k, new_v, u_new, b_new)
        u = u_new
        lo_n, hi_n = _integer_band(xlo, xhi, d_pad)
        dlo = torch.where(reach, lo_n, 1)
        dhi = torch.where(reach, hi_n, 0)
        bp[:, t] = (cells - bestd).to(torch.int32)
        layer = torch.where(reach, _pack_key(new_v, cells), _NO_KEY).amin(
            dim=1)
        some = layer != _NO_KEY
        least, low = _unpack_key(layer)
        vmin[:, t] = torch.where(some, least, BIG)
        amin[:, t] = torch.where(some, low, 0).to(torch.int32)
    return bp, vmin, amin


def _shapes_and_start(obstacles, ego_speed, ego_accel, max_offset):
    s_pad, d_pad = kernel_shapes(obstacles.shape[2], max_offset)
    v0 = ego_speed.to(torch.float32).contiguous()
    a0 = ego_accel.to(torch.float32).contiguous()
    return v0, a0, s_pad, d_pad


def st_wavefront_reference(obstacles, s_values, ego_speed, ego_accel,
                           distances, delta_t: float, delta_s: float,
                           w: STWeights, max_offset: int,
                           banded: bool = False):
    """Plain PyTorch version of the kernel (see the module docstring):
    the scan over every offset, or with ``banded`` the kernel's own
    algorithm.  Shapes as :func:`st_wavefront`; runs on any device."""
    v0, a0, s_pad, d_pad = _shapes_and_start(obstacles, ego_speed, ego_accel,
                                             max_offset)
    pen = fold_penalty(obstacles, distances, w, s_pad)
    consts = _kernel_constants(delta_t, delta_s, w)
    tables = _wavefront_tables_banded if banded \
        else _wavefront_tables_reference
    bp, vmin, amin = tables(pen, v0, a0, consts, obstacles.shape[2], d_pad)
    return _backtrace(bp, vmin, amin, s_values.to(torch.float32))


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.st_wavefront_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp, vp]
    lib.st_wavefront_launch.restype = ci
    lib.st_wavefront_num_consts.argtypes = []
    lib.st_wavefront_num_consts.restype = ci
    lib.st_wavefront_smem_bytes.argtypes = [ci, ci]
    lib.st_wavefront_smem_bytes.restype = ctypes.c_size_t


def load_kernel():
    """Build (if needed) and load the kernel library."""
    return _build.load(_KERNEL, _declare)


def prepare_launch(obstacles, s_values, ego_speed, ego_accel, distances,
                   delta_t: float, delta_s: float, w: STWeights,
                   max_offset: int, visited=None, threads: int = _THREADS):
    """Check the inputs, load the kernel, allocate the output and return
    ``(launch, out)``: ``launch()`` enqueues the kernel once on the current
    stream, writing the (B, T) sequences into ``out``.  :func:`st_wavefront`
    is ``launch()`` once; a timing loop calls it repeatedly.

    ``visited``, when given, is a one-element int64 CUDA tensor to which
    every launch adds the (source, offset) pairs its sweep visited."""
    device = obstacles.device
    if device.type != "cuda":
        raise ValueError(f"st_wavefront: unsupported device {device}")
    if obstacles.dim() != 3 or obstacles.dtype != torch.bool:
        raise ValueError("st_wavefront: obstacles must be (B, T, S) bool")
    batch, num_t, num_s = obstacles.shape
    if batch < 1 or num_t < 2:
        raise ValueError("st_wavefront: bad grid shape "
                         f"{tuple(obstacles.shape)}")
    for name, x, shape in (("s_values", s_values, (batch, num_s)),
                           ("ego_speed", ego_speed, (batch,)),
                           ("ego_accel", ego_accel, (batch,)),
                           ("distances", distances, (batch, num_t, num_s))):
        if x.device != device:
            raise ValueError(f"st_wavefront: {name} on {x.device}, "
                             f"obstacles on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"st_wavefront: {name} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if not x.is_floating_point():
            raise ValueError(f"st_wavefront: {name} must be floating point")
    if visited is not None and (
            visited.device != device or visited.dtype != torch.int64
            or visited.numel() != 1):
        raise ValueError("st_wavefront: visited must be one int64 on "
                         f"{device}")

    v0, a0, s_pad, d_pad = _shapes_and_start(obstacles, ego_speed, ego_accel,
                                             max_offset)
    if d_pad > _MAX_D_PAD:
        raise ValueError(f"st_wavefront: max_offset {max_offset} exceeds "
                         f"{_MAX_D_PAD}")
    lib = load_kernel()
    smem = lib.st_wavefront_smem_bytes(num_t, s_pad)
    if smem > _MAX_SMEM:
        raise ValueError(f"st_wavefront: T={num_t}, S={num_s} need {smem} B "
                         f"of shared memory, more than {_MAX_SMEM}")
    consts = _kernel_constants(delta_t, delta_s, w)
    if lib.st_wavefront_num_consts() != consts.size:
        raise RuntimeError("st_wavefront: constant layout mismatch")
    obs = obstacles.contiguous()
    dist = distances.to(torch.float32).contiguous()
    s_val = s_values.to(torch.float32).contiguous()
    out = torch.empty((batch, num_t), dtype=torch.float32, device=device)
    pointers = [x.data_ptr() for x in (obs, dist, s_val, v0, a0, out)]
    pointers.append(None if visited is None else visited.data_ptr())

    def launch(_alive=(obs, dist, s_val, v0, a0, visited)):
        global launches
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.st_wavefront_launch(
            *pointers, batch, num_t, num_s, s_pad, d_pad, threads,
            consts.ctypes.data, stream)
        if rc != 0:
            raise RuntimeError("st_wavefront: kernel launch failed with "
                               f"CUDA error {rc}")
        launches += 1

    return launch, out


def st_wavefront(obstacles, s_values, ego_speed, ego_accel, distances,
                 delta_t: float, delta_s: float, w: STWeights,
                 max_offset: int, visited=None):
    """Jerk-limited ST DP for a batch: obstacles (B, T, S) bool, s_values
    (B, S), ego_speed and ego_accel (B,), distances (B, T, S) -> f32 s
    sequences (B, T).  Any B >= 1; no lane tiling or batch padding.

    A CUDA tensor launches the kernel, once; a CPU tensor takes
    :func:`st_wavefront_reference`; any other device raises.
    """
    if obstacles.device.type == "cpu":
        return st_wavefront_reference(obstacles, s_values, ego_speed,
                                      ego_accel, distances, delta_t, delta_s,
                                      w, max_offset)
    launch, out = prepare_launch(obstacles, s_values, ego_speed, ego_accel,
                                 distances, delta_t, delta_s, w, max_offset,
                                 visited=visited)
    launch()
    return out
