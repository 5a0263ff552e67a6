"""device_idle_pct (%, device trace): the share of a control tick in
which no operation runs on the card: 1 - the device's busy seconds a
profiled tick (the union of the device operations' intervals in the
profiler trace, over the profiled ticks) over the median tick before the
first span, which run as in an untraced run.  The profiler's and the
spans' own host cost stretches the ticks that carry them and those after,
so their length is not the denominator; the result line's busy_s and
window_s are the profiled window's own."""

import statistics

from harness.stats import plain_intervals


def read(run):
    w = run.window
    first, last = w.profiled
    plain = plain_intervals(w.entries, w.rounds, w.disturbed)
    if run.trace is None or last <= first or not plain:
        return None
    busy = run.trace["busy_s"] / (last - first)
    return 100.0 * (1.0 - busy / statistics.median(plain))
