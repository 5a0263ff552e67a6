"""The obstacle grid in one CUDA launch: wrapper of ``csrc/obstacle_grid.cu``.

The kernel builds what ``planner.grid.build_st_grid_plain`` builds (the
forecast roll of ``prediction.predict_step_without_ego`` over the T-1
steps and the marking of every slice by ``grid._mark_slice``) for a batch
of sensed float32 states on the card, bit for bit, in one launch; its
header holds the design.  ``planner.grid.build_st_grid`` takes it for
every state on the card but a float64 one (:func:`supports`), and the
plain path on the CPU; the plain path is the kernel's plain version, which
the card tests and ``chip_smoke.py`` hold it to.  A state on the card that
the kernel cannot take raises.  Each launch adds one to the module-level
``launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import geometry, prediction
from ..config import Settings
from ..prediction import HighwayState
from . import _build

__all__ = ["supports", "prepare_launch", "build", "launches"]

_KERNEL = "obstacle_grid"

launches = 0             # kernel launches since import (or last reset)


def supports(state: HighwayState, dtype) -> bool:
    """Whether the kernel builds this grid: the state lies on a CUDA device
    and neither it nor the grid asked for is float64.  The CPU and float64
    (forensics' replay) take the plain path; :func:`prepare_launch` raises
    for anything else on the card that the kernel cannot take."""
    return state.other_x.device.type == "cuda" \
        and torch.float64 not in (dtype, state.other_x.dtype)


def _constants(cfg: Settings) -> np.ndarray:
    """Settings and geometry in the kernel's Consts order, each a Python
    double rounded once to f32, as PyTorch rounds a scalar operand."""
    return np.asarray([
        cfg.T_DISCRETIZATION, cfg.S_DISCRETIZATION, cfg.CAR_LENGTH,
        cfg.CRASH_MIN_S - cfg.MIN_ALLOWED_DISTANCE,
        cfg.MAX_PREDICTED_DECELERATION,
        prediction.EGO_REACTION_THRESHOLD, prediction.REACTION_GAP,
        *geometry.MERGE_POINT, *geometry.MERGE_POINT2,
        geometry.MERGE_POINT3[0], geometry.COMMON_S, geometry.HIGHWAY_Y,
    ], np.float32)


def _declare(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.obstacle_grid_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp] * 4
    lib.obstacle_grid_launch.restype = ci
    lib.obstacle_grid_check.argtypes = [ci] * 4
    lib.obstacle_grid_check.restype = ci
    lib.obstacle_grid_num_consts.argtypes = []
    lib.obstacle_grid_num_consts.restype = ci
    if lib.obstacle_grid_num_consts() != _constants(Settings()).size:
        raise RuntimeError("obstacle_grid: constant layout mismatch")


def load_kernel():
    """Build (if needed) and load the kernel library; its layout is checked
    against the wrapper's once, as it loads."""
    return _build.load(_KERNEL, _declare)


def prepare_launch(state: HighwayState, cfg: Settings, reach, reach_cells,
                   dtype=torch.float32):
    """Check the inputs, load the kernel, allocate the outputs and return
    ``(launch, (obstacles, distances, s_values, t_values))``: ``launch()``
    enqueues the kernel once on the current stream.  ``reach`` (T,) are the
    slices' bumper offsets in metres as f32, ``reach_cells`` (T,) their
    blocked half widths in cells.  :func:`build` is ``launch()`` once; a
    timing loop calls it repeatedly.  Raises ValueError for what the kernel
    cannot take: the layout, the dtypes, the device, and (as the kernel's
    ``obstacle_grid_check`` says) a T, K or S beyond one block."""
    device = state.other_x.device
    if state.other_x.dim() != 2:
        raise ValueError("obstacle_grid: other_x must be (B, K), not "
                         f"{tuple(state.other_x.shape)}")
    batch, num_k = state.other_x.shape
    num_t, num_s = cfg.num_t, cfg.num_s
    fields = (("ego_x", state.ego_x), ("ego_y", state.ego_y),
              ("other_x", state.other_x),
              ("other_speed", state.other_speed),
              ("other_present", state.other_present))
    for (name, x), shape, kind in zip(
            fields, ((batch,), (batch,)) + ((batch, num_k),) * 3,
            (torch.float32,) * 4 + (torch.bool,)):
        if x.device != device or tuple(x.shape) != shape \
                or x.dtype != kind:
            raise ValueError(f"obstacle_grid: {name} is {x.dtype} of shape "
                             f"{tuple(x.shape)} on {x.device}, expected "
                             f"{kind} of shape {shape} on {device}")
    if dtype != torch.float32:
        raise ValueError(f"obstacle_grid: builds float32 grids, not {dtype}")
    reach = np.ascontiguousarray(reach, np.float32)
    reach_cells = np.ascontiguousarray(reach_cells, np.int32)
    if reach.shape != (num_t,) or reach_cells.shape != (num_t,):
        raise ValueError(f"obstacle_grid: reach arrays must be ({num_t},)")
    if device.type != "cuda":
        raise ValueError(f"obstacle_grid: unsupported device {device}")
    inputs = [x.contiguous() for _, x in fields]
    lib = load_kernel()
    if lib.obstacle_grid_check(batch, num_k, num_t, num_s) != 0:
        raise ValueError(f"obstacle_grid: a grid of B={batch}, K={num_k}, "
                         f"T={num_t}, S={num_s} exceeds one block")
    consts = _constants(cfg)
    obstacles = torch.empty((batch, num_t, num_s), dtype=torch.bool,
                            device=device)
    distances = torch.empty((batch, num_t, num_s), dtype=torch.float32,
                            device=device)
    s_values = torch.empty((batch, num_s), dtype=torch.float32,
                           device=device)
    t_values = torch.empty((num_t,), dtype=torch.float32, device=device)
    outputs = (obstacles, distances, s_values, t_values)
    pointers = [x.data_ptr() for x in (*inputs, *outputs)]

    def launch(_alive=(inputs, consts, reach, reach_cells)):
        global launches
        # the library launches onto the current device: make it the inputs'
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.obstacle_grid_launch(
                *pointers, batch, num_k, num_t, num_s, consts.ctypes.data,
                reach.ctypes.data, reach_cells.ctypes.data, stream)
        if rc != 0:
            raise RuntimeError("obstacle_grid: kernel launch failed with "
                               f"CUDA error {rc}")
        launches += 1

    return launch, outputs


def build(state: HighwayState, cfg: Settings, reach, reach_cells,
          dtype=torch.float32):
    """The grid of ``state`` in one launch: (obstacles (B, T, S) bool,
    distances (B, T, S), s_values (B, S), t_values (T,)), f32."""
    launch, outputs = prepare_launch(state, cfg, reach, reach_cells, dtype)
    launch()
    return outputs
