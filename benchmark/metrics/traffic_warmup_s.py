"""traffic_warmup_s (s, host clock): from the window's start to its first
control tick: the round's fresh worlds, its traffic warm-up of
wait_before_start / TICK_LENGTH world steps and the ego's insertion
(sim/episode.py, sim/world.py).  A traced run adds nothing before its
first control tick, so this reads as in an untraced run."""


def read(run):
    w = run.window
    if not w.entries:
        return None
    return w.entries[0] - w.t0
