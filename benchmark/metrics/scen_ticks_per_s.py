"""scen_ticks_per_s (ticks/s, host clock): B scenarios times the control
ticks completed in the window, over the whole window, the round's traffic
warm-up included: the lockstep form of the paper's clock_time_per_step."""

from harness.stats import rate


def read(run):
    w = run.window
    if not w.entries:
        return None
    return rate(run.batch, len(w.entries), w.window_s)
