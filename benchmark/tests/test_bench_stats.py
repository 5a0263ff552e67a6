"""The window's arithmetic: the rate over all work and all time, the tail's
percentile rule, the clock on the controller."""

import pytest

from harness import stats
from harness.window import Window, WindowClosed


def test_rate_is_all_work_over_all_time():
    assert stats.rate(4096, 100, 50.0) == pytest.approx(8192.0)
    with pytest.raises(ValueError):
        stats.rate(4096, 1, 0.0)


def test_percentile_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 90) == 90
    assert stats.percentile(values, 50) == 50
    assert stats.percentile([5.0], 90) == 5.0


@pytest.mark.parametrize("n,q", [(100, 90), (101, 90), (120, 91),
                                 (50, 80), (20, 50), (10, None)])
def test_tail_leaves_ten_beyond(n, q):
    got = stats.tail_percentile(n)
    assert got == q
    if got is not None:
        values = list(range(n))
        beyond = [v for v in values if v > stats.percentile(values, got)]
        assert len(beyond) >= 10


def test_intervals_stay_within_a_round():
    entries = [0.0, 1.0, 2.5, 10.0, 11.0]
    rounds = [0, 0, 0, 1, 1]
    assert stats.tick_intervals(entries, rounds) == [1.0, 1.5, 1.0]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_counts_ticks_and_closes_at_the_deadline():
    clock = FakeClock()
    w = Window(10.0, capture_tick=2, clock=clock)
    w.start()
    w.new_round()
    calls = []
    ctrl = w.wrap_controller(lambda s: calls.append(s) or s[2])
    import torch
    state = tuple(torch.zeros(3) for _ in range(8))
    for t in (2.0, 4.0, 6.0, 9.5):
        clock.t = t
        ctrl(state)
    clock.t = 10.5
    with pytest.raises(WindowClosed):
        ctrl(state)
    w.close()
    assert w.entries == [2.0, 4.0, 6.0, 9.5]
    assert w.window_s == 10.5
    assert len(calls) == 4
    ticks = [s["tick"] for s in w.final_samples()]
    assert ticks == [2, 4]
    assert all(s["next"] is not None for s in w.final_samples())
    assert stats.rate(3, len(w.entries), w.window_s) == pytest.approx(
        12 / 10.5)


def test_a_number_with_nothing_behind_it_fails():
    from harness import check
    ok, rows = check.verdict({"cmd_mismatch_pct": None, "ego_step_err": 0.0},
                             {"cmd_mismatch_pct": 5.0, "ego_step_err": 0.0})
    assert not ok
    assert rows[0] == ("cmd_mismatch_pct", None, 5.0)
    assert check.verdict({"ego_step_err": 0.0}, {"ego_step_err": 0.0})[0]


def test_plain_intervals_leave_the_profiled_ticks_out():
    entries = [0.0, 1.0, 2.0, 9.0, 16.0, 18.0, 19.0, 20.0]
    rounds = [0] * 8
    # ticks at entries 3 and 4 profiled: intervals 2..5 out
    assert stats.plain_intervals(entries, rounds, (3, 5)) == [1.0, 1.0, 1.0]
    assert stats.plain_intervals(entries, rounds, (0, 0)) == \
        stats.tick_intervals(entries, rounds)[1:]


def test_traced_window_spans_late_and_reads_the_tail_before():
    """Spans (and their synchronisations) sit on SPAN_TICKS ticks from
    ``trace_from``; the tail and the idle share read the ticks before."""
    from harness.window import SPAN_TICKS
    clock = FakeClock()
    w = Window(100.0, trace=True, capture_tick=2, trace_from=6,
               profile_ticks=0, clock=clock)
    w.start()
    w.new_round()
    ctrl = w.wrap_controller(lambda s: s[2])
    import torch
    state = tuple(torch.zeros(3) for _ in range(8))
    for i in range(SPAN_TICKS + 8):
        clock.t = float(i)
        ctrl(state)
    assert w.spanned == (5, 5 + SPAN_TICKS - 1)
    assert sorted(w.spans["controller"]) == list(range(5, 5 + SPAN_TICKS))
    assert w.disturbed == (5, SPAN_TICKS + 8)
    plain = stats.plain_intervals(w.entries, w.rounds, w.disturbed)
    assert len(plain) == 4


def test_unprofiled_leaves_the_profiled_ticks_out():
    per_entry = dict(enumerate([5.0, 1.0, 9.0, 9.0, 1.0, 1.0]))
    assert stats.unprofiled(per_entry, (2, 3)) == [5.0, 1.0, 1.0]
    assert stats.unprofiled({0: 1.0, 7: 2.0}, (0, 0)) == [1.0, 2.0]
