"""loop_ms_per_tick (ms, program span): the median, over the ticks of a
traced run that hold spans (the profiled ones left out), of the tick's
interval less its controller span: the episode loop's own work (world
step, sense, tick metrics, history writes)."""

import statistics

from harness.stats import unprofiled


def read(run):
    w = run.window
    rest = {i: 1e3 * (w.entries[i + 1] - w.entries[i] - c)
            for i, c in w.spans.get("controller", {}).items()
            if i + 1 < len(w.entries) and w.rounds[i] == w.rounds[i + 1]}
    rest = unprofiled(rest, w.profiled)
    return statistics.median(rest) if rest else None
