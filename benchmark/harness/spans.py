"""Per-layer numbers from the program's own tracer, and from a profiler
trace read against the program's ranges.

The tracer (``rl_mpc_lanemerging_torch/tracing.py``) keeps each span as
``(name, parent, round, tick, start_ns, end_ns)`` on the host clock and
each counter as ``(name, round, tick, t_ns, value)``; ``(round, tick)``
names the control tick of the lockstep batch (the tick is the window's
``tick_in_round``).  With a profiler running, every span is also a
``record_function`` range of the same name in the profiler's trace: the
names of the registry ``SPANS`` tell the program's ranges apart there.

* :func:`ms_per_tick`: a span's time a tick (summed over the tick, or its
  self time: its duration less its children's), the median over the ticks
  whose ``episode.tick`` span closed;
* :func:`active_pct`: the counter ``episode.active`` over the batch;
* :func:`tick_launches`: CUDA kernel launches (the runtime's
  ``cudaLaunchKernel`` and its variants) inside each program range of the
  last profiled tick whose world step closed;
* :func:`idle_gaps`: the card's idle gaps of ``trace.summarize``, the same
  cuts, named by the innermost program range around each gap's midpoint,
  else the innermost ``bench/`` range, else ``loop``.

Every function returns None (or nothing) where the run holds none of what
it reads, as a run of a program without the tracer does.
"""

from __future__ import annotations

import bisect
import re
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from .trace import _RANGE, _union

__all__ = ["TICK", "complete_ticks", "self_ns", "ms_per_tick", "active_pct",
           "tick_launches", "idle_gaps", "is_launch"]

TICK = "episode.tick"
STEP = "world.step"          # the last span of a tick
ACTIVE = "episode.active"
_LAUNCH = re.compile(r"^(cudaLaunchKernel|cudaLaunchKernelExC|"
                     r"cudaLaunchCooperativeKernel|cuLaunchKernel|"
                     r"cuLaunchKernelEx)(_v\d+)?$")

Key = Tuple[int, int]        # (round, tick)


def is_launch(name: str) -> bool:
    """A CUDA runtime or driver call that launches a kernel."""
    return bool(_LAUNCH.match(name))


def complete_ticks(spans: Sequence[tuple], skip: Iterable[Key] = ()
                   ) -> Dict[Key, List[tuple]]:
    """The spans of each tick whose ``episode.tick`` span closed, by
    (round, tick), less the ticks ``skip`` (the profiled ones)."""
    skip = set(skip)
    done = {(s[2], s[3]) for s in spans if s[0] == TICK} - skip
    out: Dict[Key, List[tuple]] = {k: [] for k in done}
    for s in spans:
        if (s[2], s[3]) in out:
            out[(s[2], s[3])].append(s)
    return out


def self_ns(span: tuple, tick_spans: Sequence[tuple]) -> int:
    """``span``'s duration less its children's: the spans of its tick
    whose parent it names and that lie inside it (the tracer's spans nest,
    so children do not overlap)."""
    name, _, _, _, a, b = span
    inner = sum(c[5] - c[4] for c in tick_spans
                if c is not span and c[1] == name and a <= c[4]
                and c[5] <= b)
    return b - a - inner


def ms_per_tick(spans: Sequence[tuple], name: str, own: bool = False,
                skip: Iterable[Key] = ()) -> Optional[float]:
    """Milliseconds a tick in the spans ``name``, summed over the tick
    (``own``: their self times), the median over the complete ticks; None
    where no tick holds such a span."""
    ticks = complete_ticks(spans, skip)
    if not any(s[0] == name for tick in ticks.values() for s in tick):
        return None
    per_tick = []
    for tick in ticks.values():
        of = [s for s in tick if s[0] == name]
        ns = sum(self_ns(s, tick) if own else s[5] - s[4] for s in of)
        per_tick.append(ns * 1e-6)
    return statistics.median(per_tick)


def active_pct(counts: Sequence[tuple], batch: int,
               ticks: Optional[Iterable[Key]] = None) -> Optional[float]:
    """The mean over the ticks (all, or those of ``ticks``) of the
    scenarios still running as a tick starts, in % of the batch."""
    keep = None if ticks is None else set(ticks)
    values = [c[4] for c in counts if c[0] == ACTIVE
              and (keep is None or (c[1], c[2]) in keep)]
    if not values or batch <= 0:
        return None
    return 100.0 * statistics.fmean(values) / batch


def _host_ranges(events, names) -> List[Tuple[str, float, float]]:
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA
            and e.name in names]


def tick_launches(events, program_names: Sequence[str]
                  ) -> Optional[Dict[str, int]]:
    """Kernel launches inside each program range of the last profiled tick
    whose ``world.step`` closed inside it (the profiler stops inside the
    next tick), summed by range name; ``episode.tick`` holds them all.
    None where the trace holds no such tick."""
    names = set(program_names)
    ranges = _host_ranges(events, names)
    steps = [r for r in ranges if r[0] == STEP]
    ticks = [r for r in ranges if r[0] == TICK and any(
        r[1] <= s[1] and s[2] <= r[2] for s in steps)]
    if not ticks:
        return None
    _, lo, hi = max(ticks, key=lambda r: r[1])
    launches = sorted(e.time_range.start for e in events
                      if e.device_type != torch.autograd.DeviceType.CUDA
                      and is_launch(e.name))
    out: Dict[str, int] = {}
    for name, a, b in ranges:
        if lo <= a and b <= hi:
            n = bisect.bisect_right(launches, b) \
                - bisect.bisect_left(launches, a)
            out[name] = out.get(name, 0) + n
    return out


def idle_gaps(events, program_names: Sequence[str]
              ) -> List[List[object]]:
    """[name, seconds] of the card's idle time, largest first: the gaps
    between device operations that ``trace.summarize`` cuts (its device
    operations and window edges: the ``bench/`` ranges and the
    operations), each named by the innermost program range around its
    midpoint, else by the innermost ``bench/`` range, else ``loop``.  The
    program ranges' own device-side annotations are not operations."""
    names = set(program_names)
    device, bench = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(_RANGE) or e.name in names:
                continue
            device.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith(_RANGE):
            bench.append((e.time_range.start, e.time_range.end,
                          e.name[len(_RANGE):]))
    program = [(a, b, n) for n, a, b in _host_ranges(events, names)]
    merged = _union(device)
    edges = [t for a, b, _ in bench for t in (a, b)] \
        + [t for a, b in merged for t in (a, b)]
    idle: Dict[str, float] = {}
    if edges:
        lo, hi = min(edges), max(edges)
        cuts = [lo] + [t for a, b in merged for t in (a, b)] + [hi]
        for a, b in zip(cuts[::2], cuts[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            label = "loop"
            for around in (program, bench):
                inside = [s for s in around if s[0] <= mid <= s[1]]
                if inside:
                    label = min(inside, key=lambda s: s[1] - s[0])[2]
                    break
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])]
