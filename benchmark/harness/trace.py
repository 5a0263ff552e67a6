"""Reduce a ``torch.profiler`` trace of the profiled ticks to numbers.

* device operations: every event on the device timeline but the
  ``record_function`` ranges' own device-side spans;
* busy seconds: the union of their intervals;
* K1's launches: the operations whose name holds ``st_wavefront``;
* idle gaps: the stretches of the traced window in which no device
  operation ran, each named by what the host was doing then: the
  innermost ``bench/<span>`` range around the gap's midpoint, or ``loop``
  (the episode loop, world, sense and tick metrics) outside every span.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

__all__ = ["TraceSummary", "summarize", "short_name"]

K1_NAME = "st_wavefront"
_RANGE = "bench/"


class TraceSummary(dict):
    """busy_s, device_ops [(name, s)], idle_gaps [(name, s)], k1_s [s per
    launch, in launch order], ops (count)."""


def short_name(name: str) -> str:
    """A kernel's template name cut to what tells it apart: the functor
    (``CUDAFunctor_add<float>``) or the kernel's own name."""
    functor = re.search(r"(\w*Functor\w*(?:<[\w:, ]*>)?)", name)
    head = re.sub(r"^void ", "", name).split("(")[0].split("<")[0]
    head = head.split("::")[-1]
    if functor and functor.group(1) not in head:
        return f"{head}:{functor.group(1)}"[:120]
    return head[:120]


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(prof) -> TraceSummary:
    device, ranges = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(_RANGE):
                continue
            device.append(e)
        elif e.name.startswith(_RANGE):
            ranges.append(e)
    by_name: Dict[str, float] = {}
    intervals = []
    k1 = []
    for e in device:
        a, b = e.time_range.start, e.time_range.end
        intervals.append((a, b))
        key = short_name(e.name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        if K1_NAME in e.name:
            k1.append((a, (b - a) * 1e-6))
    merged = _union(intervals)
    busy = sum(b - a for a, b in merged) * 1e-6
    spans = [(r.time_range.start, r.time_range.end,
              r.name[len(_RANGE):]) for r in ranges]
    # the traced window on the trace's clock: from the first host range or
    # device operation to the last
    edges = [t for a, b, _ in spans for t in (a, b)] \
        + [t for a, b in merged for t in (a, b)]
    idle: Dict[str, float] = {}
    if edges:
        lo, hi = min(edges), max(edges)
        cuts = [lo] + [t for a, b in merged for t in (a, b)] + [hi]
        for a, b in zip(cuts[::2], cuts[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            label = min(inside, key=lambda s: s[1] - s[0])[2] if inside \
                else "loop"
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(busy_s=busy, device_ops=[list(x) for x in top],
                        idle_gaps=[list(x) for x in gaps],
                        k1_s=[s for _, s in sorted(k1)], ops=len(device))
