"""The sensor snapshot of a world (the paper's prediction.py:111-142 with
control.py:366-389): the ego placed on its route, the traffic cars within
SENSOR_RADIUS of it sorted front to back, and their accelerations from the
last tick's speeds.  An ego that is not on the road is reported at
(-200, 0) with zero speed and acceleration.

The world is the program's, read field by field (the traffic cars' x,
speed, last speed and whether each is on the road; the ego's route
position, speed and last speed); the snapshot is worked out here again.
"""

from __future__ import annotations

import torch

from . import route
from .forecast import HIGHWAY_Y, State, const

__all__ = ["ego_xy", "sense"]

ABSENT_X = -200.0


def ego_xy(arc):
    """(x, y) of route positions ``arc`` (B,): linear between the net
    shape's points, past its ends along its first or last segment."""
    tab_arc = torch.tensor(route.ROUTE_ARC, dtype=arc.dtype,
                           device=arc.device)
    tab_x = torch.tensor(route.ROUTE_X, dtype=arc.dtype, device=arc.device)
    tab_y = torch.tensor(route.ROUTE_Y, dtype=arc.dtype, device=arc.device)
    i = (torch.searchsorted(tab_arc, arc.contiguous(), right=True) - 1) \
        .clamp(0, tab_arc.shape[0] - 2)
    w = (arc - tab_arc[i]) / torch.clamp_min(tab_arc[i + 1] - tab_arc[i],
                                             1e-9)
    x = tab_x[i] + (tab_x[i + 1] - tab_x[i]) * w
    y = tab_y[i] + (tab_y[i + 1] - tab_y[i]) * w
    return x, y


def sense(cars_x, cars_v, cars_prev_v, cars_on, ego_on, ego_arc, ego_v,
          ego_prev_v, p, slots: int) -> State:
    """The snapshot, padded to ``slots`` cars a scenario (absent slots at
    x = -inf); every car in sensor range, front first, ties in slot
    order."""
    dt = const(p.TICK_LENGTH, cars_x)
    x, y = ego_xy(ego_arc)
    x = torch.where(ego_on, x, ABSENT_X)
    y = torch.where(ego_on, y, 0.0)
    v = torch.where(ego_on, ego_v, 0.0)
    a = torch.where(ego_on, (ego_v - ego_prev_v) / dt, 0.0)
    dx = cars_x - x[:, None]
    dy = HIGHWAY_Y - y[:, None]
    seen = cars_on & (torch.sqrt(dx * dx + dy * dy) < p.SENSOR_RADIUS)
    key = torch.where(seen, cars_x, float("-inf"))
    order = torch.argsort(-key, dim=1, stable=True)
    pad = max(slots - order.shape[1], 0)
    seen = torch.gather(seen, 1, order)
    ox = torch.gather(cars_x, 1, order)
    ov = torch.gather(cars_v, 1, order)
    opv = torch.gather(cars_prev_v, 1, order)
    if pad:
        seen = torch.nn.functional.pad(seen, (0, pad))
        ox, ov, opv = (torch.nn.functional.pad(t, (0, pad))
                       for t in (ox, ov, opv))
    return State(x, y, v, a,
                 torch.where(seen, ox, float("-inf")),
                 torch.where(seen, ov, 0.0),
                 torch.where(seen, (ov - opv) / dt, 0.0), seen)
