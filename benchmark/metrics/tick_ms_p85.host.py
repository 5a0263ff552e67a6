"""tick_ms_p85.host (ms, host clock): the 85th percentile, nearest rank,
of a traced run's control ticks, each from one controller entry to the
next within its round, read on the ticks before the first span
(``trace_from`` of the cell: 68 intervals in st), which run as in an
untraced run.  The card is idle over half of a tick (device_idle_pct), so
the tail is paced by the host.  The 85th leaves at least ten ticks beyond
it down to 67 ticks; where fewer remain the reader gives nothing."""

from harness.stats import percentile, plain_intervals, tail_percentile


def read(run):
    w = run.window
    ticks = plain_intervals(w.entries, w.rounds, w.disturbed)
    q = tail_percentile(len(ticks))
    if q is None or q < 85:
        return None
    return 1e3 * percentile(ticks, 85)
