"""Merge-area geometry: Frenet-style s-coordinate maps and the ego route.

Port of ``rl_mpc_lanemerging_tpu/geometry.py`` (reference control.py:366-389).
Every function broadcasts over arbitrary leading batch dimensions.

* ``merge_point``  = (-50.9, 1.72): where the ramp meets the junction
* ``merge_point2`` = (1.5, -1.5):  end of the junction's internal merge lane
* ``merge_point3`` = (-51, -1.5):  the highway point abreast of the merge

The ego s coordinate is negative distance-to-merge-point before the merge,
positive distance past it, and linear in x after the junction.  Obstacle s is
simply x + 51.
"""

from __future__ import annotations

import torch

from ._route_data import ROUTE_ARC, ROUTE_XY

__all__ = [
    "MERGE_POINT", "MERGE_POINT2", "MERGE_POINT3",
    "COMMON_S", "HIGHWAY_Y", "EGO_DEPART_ARC", "EGO_ARRIVAL_ARC",
    "EGO_JUNCTION_ARC", "TRAFFIC_SPAWN_X", "TRAFFIC_EXIT_X",
    "get_ego_s", "get_obstacle_s_from_x", "route_xy",
]

MERGE_POINT = (-50.9, 1.72)
MERGE_POINT2 = (1.5, -1.5)
MERGE_POINT3 = (-51.0, -1.5)
# s value shared by the ego map and the obstacle map at the junction exit
COMMON_S = MERGE_POINT2[0] - MERGE_POINT3[0]

HIGHWAY_Y = -1.6  # the single highway lane's y (merge.net.xml highwayahead_0)

# Ego departs at ramp lane position 40 and arrives at position 50 on
# highwayahead (reference control.py:42).
EGO_DEPART_ARC = 40.0
_RAMP_LEN = 201.90961137044434          # ramp_0 lane length (merge.net.xml)
_INTERNAL_LEN = 52.18                   # :mergenode_1_0 length
EGO_ARRIVAL_ARC = _RAMP_LEN + _INTERNAL_LEN + 50.0
# arc at which the ego enters the junction's internal merge lane
EGO_JUNCTION_ARC = _RAMP_LEN

# Traffic cars enter at x=-245 (front bumper) and leave at x=100.
TRAFFIC_SPAWN_X = -245.0
TRAFFIC_EXIT_X = 100.0

_TABLES: dict = {}


def _route_tables(device, dtype):
    key = (str(device), dtype)
    if key not in _TABLES:
        _TABLES[key] = (torch.as_tensor(ROUTE_ARC).to(device=device,
                                                      dtype=dtype),
                        torch.as_tensor(ROUTE_XY).to(device=device,
                                                     dtype=dtype))
    return _TABLES[key]


def route_xy(arc: torch.Tensor) -> torch.Tensor:
    """Map ego route arc-length -> (..., 2) (x, y), piecewise-linear on the
    net shape.  Arcs past the route end extrapolate along the final
    highway segment."""
    route_arc, route_tab = _route_tables(arc.device, arc.dtype)
    idx = torch.searchsorted(route_arc, arc.contiguous(), right=True) - 1
    idx = idx.clamp(0, route_arc.shape[0] - 2)
    a0 = route_arc[idx]
    a1 = route_arc[idx + 1]
    w = (arc - a0) / torch.clamp_min(a1 - a0, 1e-9)
    p0 = route_tab[idx]
    p1 = route_tab[idx + 1]
    return p0 + (p1 - p0) * w[..., None]


def _dist_to(pos_x, pos_y, point):
    dx = pos_x - point[0]
    dy = pos_y - point[1]
    return torch.sqrt(dx * dx + dy * dy)


def get_ego_s(pos_x: torch.Tensor, pos_y: torch.Tensor) -> torch.Tensor:
    """Ego s coordinate (reference control.py:373-380)."""
    d = _dist_to(pos_x, pos_y, MERGE_POINT)
    after = pos_x - MERGE_POINT2[0] + COMMON_S
    return torch.where(pos_x < MERGE_POINT[0], -d,
                       torch.where(pos_x < MERGE_POINT2[0], d, after))


def get_obstacle_s_from_x(x: torch.Tensor) -> torch.Tensor:
    """Obstacle s coordinate (reference control.py:388-389)."""
    return x - MERGE_POINT3[0]
