"""Arithmetic of the window's numbers, kept with the benchmark so that no
change to the program moves the yardstick.

The rate is the lockstep form of the paper's ``clock_time_per_step``
(stats.py:103-107, wall time over scenario-ticks): scenario-ticks done
over the whole window.  A tail is a nearest-rank percentile, reported only
where at least ten samples lie beyond it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

__all__ = ["rate", "percentile", "tail_percentile", "tick_intervals",
           "plain_intervals", "unprofiled"]


def rate(batch: int, ticks: int, window_s: float) -> float:
    """Scenario-ticks per second: every tick of every scenario over all
    the time of the window."""
    if window_s <= 0:
        raise ValueError("empty window")
    return batch * ticks / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank q-th percentile (0 < q < 100): the smallest value with
    at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def tail_percentile(n: int, beyond: int = 10) -> Optional[int]:
    """The highest whole percentile of n samples that leaves at least
    ``beyond`` of them above it by the nearest rank; None when n is too
    small for any."""
    best = None
    for q in range(1, 100):
        if n - max(1, math.ceil(q / 100.0 * n)) >= beyond:
            best = q
    return best


def tick_intervals(entries: Sequence[float], rounds: Sequence[int]
                   ) -> List[float]:
    """Seconds from one controller entry to the next within one round."""
    return [b - a for a, b, ra, rb in zip(entries, entries[1:], rounds,
                                          rounds[1:]) if ra == rb]


def plain_intervals(entries: Sequence[float], rounds: Sequence[int],
                    profiled) -> List[float]:
    """:func:`tick_intervals` less the ticks ``profiled`` = (first, last)
    entries (a traced run's profiler, or its spans and every tick after
    them), the tick before them and the one after (the profiler's start,
    its stop and the K1 inputs' copy fall there)."""
    first, last = profiled
    return [b - a for i, (a, b, ra, rb) in enumerate(zip(
        entries, entries[1:], rounds, rounds[1:]))
        if ra == rb and not first - 1 <= i <= last]


def unprofiled(per_entry: Dict[int, float], profiled) -> List[float]:
    """The values of ``per_entry`` (a tick's entry index -> value) outside
    the profiled ticks ``profiled`` = (first, last) entries and the tick
    before them: the profiler's own host cost stretches those."""
    first, last = profiled
    return [v for i, v in sorted(per_entry.items())
            if last <= first or not first - 1 <= i <= last]
