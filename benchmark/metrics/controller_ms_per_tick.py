"""controller_ms_per_tick (ms, program span): the median, over the ticks
of a traced run that hold spans (the profiled ones left out), of the time
inside the controller call (planner/mpc.py; in the arbiter
agents/combined.py with its two plans), synchronised at both ends."""

import statistics

from harness.stats import unprofiled


def read(run):
    ticks = unprofiled(run.window.spans.get("controller", {}),
                       run.window.profiled)
    return 1e3 * statistics.median(ticks) if ticks else None
