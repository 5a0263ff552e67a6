"""The readers of the program's spans and counters (``harness/spans.py``)
on synthetic tracer records and synthetic profiler events: idle gaps
named by the innermost program range, with the same sum and window edges
as ``trace.summarize`` gives; kernel launches counted per range; times a
tick, self times and the active share; and None where the spans are
absent."""

from types import SimpleNamespace

import pytest
import torch

from harness import spans, trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
PROGRAM = ("episode.tick", "world.step", "controller.plan", "grid.build",
           "grid.forecast", "qp.admm", "combined.rollout", "combined.actor",
           "episode.history_write")


def ev(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


# one tick (us): the program's ranges, the benchmark's controller range,
# six device operations and the launches before them
PROGRAM_RANGES = [ev("episode.tick", 50, 1000),
                  ev("controller.plan", 100, 900), ev("grid.build", 120, 500),
                  ev("grid.forecast", 150, 250), ev("qp.admm", 600, 800),
                  ev("world.step", 960, 999)]
BENCH = [ev("bench/controller", 100, 900)]
DEVICE = [ev("add_kernel", a, b, CUDA) for a, b in
          ((60, 80), (260, 300), (520, 560), (610, 620), (850, 880),
           (990, 995))]
LAUNCHES = [ev("cudaLaunchKernel", t, t + 2) for t in
            (55, 255, 515, 605, 700, 845, 985)]
ANNOTATIONS = [ev(e.name, e.time_range.start, e.time_range.end, CUDA, True)
               for e in PROGRAM_RANGES]


def test_idle_gaps_named_by_the_innermost_program_range():
    events = PROGRAM_RANGES + BENCH + DEVICE + LAUNCHES + ANNOTATIONS
    gaps = dict(spans.idle_gaps(events, PROGRAM))
    assert gaps == pytest.approx({"grid.forecast": 180e-6,
                                  "grid.build": 220e-6,
                                  "controller.plan": 50e-6,
                                  "qp.admm": 230e-6,
                                  "episode.tick": 110e-6})
    # the same cuts as the summary, whose names are the bench ranges'
    plain = trace.summarize(Prof(BENCH + DEVICE + LAUNCHES))
    full = trace.summarize(Prof(events))
    assert dict(plain["idle_gaps"]) == pytest.approx(
        {"controller": 680e-6, "loop": 110e-6})
    assert sum(gaps.values()) == pytest.approx(
        sum(v for _, v in plain["idle_gaps"]))
    for key in ("busy_s", "ops", "k1_s", "device_ops"):
        assert full[key] == plain[key]


def test_program_ranges_are_not_device_operations():
    """Where the profiler leaves no annotation flag on a range's device
    side, its name still keeps it out of the operations."""
    bare = [ev(e.name, e.time_range.start, e.time_range.end, CUDA)
            for e in PROGRAM_RANGES]
    with_flag = spans.idle_gaps(PROGRAM_RANGES + BENCH + DEVICE
                                + ANNOTATIONS, PROGRAM)
    assert spans.idle_gaps(PROGRAM_RANGES + BENCH + DEVICE + bare,
                           PROGRAM) == with_flag


def test_gaps_fall_back_to_the_bench_range_then_loop():
    events = BENCH + DEVICE + [ev("qp.admm", 600, 800)]
    gaps = dict(spans.idle_gaps(events, PROGRAM))
    assert gaps == pytest.approx({"controller": 450e-6, "qp.admm": 230e-6,
                                  "loop": 110e-6})
    # no program range at all: exactly the summary's gaps
    assert spans.idle_gaps(BENCH + DEVICE, PROGRAM) == [
        list(x) for x in trace.summarize(Prof(BENCH + DEVICE))["idle_gaps"]]


def test_launches_counted_per_range_of_the_last_complete_tick():
    first = PROGRAM_RANGES + [ev("grid.build", 510, 590)] + LAUNCHES
    # a second tick cut by the profiler's stop: no world step closed in it
    cut = [ev("episode.tick", 2000, 3000), ev("grid.build", 2100, 2200),
           ev("cudaLaunchKernel", 2150, 2151)]
    other = [ev("cudaMemcpyAsync", 300, 301),
             ev("cudaLaunchKernelExC", 130, 131),
             ev("cuLaunchKernel", 160, 161)]
    got = spans.tick_launches(first + cut + other + DEVICE, PROGRAM)
    assert got == {"episode.tick": 9, "controller.plan": 7,
                   "grid.build": 4, "grid.forecast": 1, "qp.admm": 2,
                   "world.step": 1}
    assert spans.is_launch("cudaLaunchKernel_v7000")
    assert not spans.is_launch("cudaMemcpyAsync")
    assert not spans.is_launch("cudaLaunchHostFunc")


def _span(name, parent, tick, a, b, rnd=0):
    return (name, parent, rnd, tick, a, b)


def _combined_ticks():
    """Two complete ticks and one that never closed: the rollout holds
    actor calls, the arbiter's first actor call lies outside it."""
    out = []
    for tick, base in ((1, 0), (2, 10_000_000)):
        out += [_span("combined.actor", "combined.arbitrate", tick, base,
                      base + 1_000_000),
                _span("combined.actor", "combined.rollout", tick,
                      base + 2_000_000, base + 2_500_000),
                _span("combined.actor", "combined.rollout", tick,
                      base + 3_000_000, base + 3_500_000 * tick),
                _span("combined.rollout", "combined.arbitrate", tick,
                      base + 1_500_000, base + 4_000_000 * tick),
                _span("world.step", "episode.tick", tick, base + 8_000_000,
                      base + 9_000_000),
                _span("episode.tick", None, tick, base, base + 9_500_000)]
    out.append(_span("combined.actor", "combined.arbitrate", 3, 20_000_000,
                     21_000_000))
    return out


def test_times_a_tick_and_self_times():
    s = _combined_ticks()
    # actor: 1 + 0.5 + 0.5 ms (tick 1), 1 + 0.5 + 4 ms (tick 2)
    assert spans.ms_per_tick(s, "combined.actor") == pytest.approx(
        (2.0 + 5.5) / 2)
    # rollout less its actor calls: 2.5 - 1 (tick 1), 6.5 - 4.5 (tick 2)
    assert spans.ms_per_tick(s, "combined.rollout", own=True) \
        == pytest.approx((1.5 + 2.0) / 2)
    assert spans.ms_per_tick(s, "combined.rollout", skip=[(0, 2)]) \
        == pytest.approx(2.5)
    assert spans.ms_per_tick(s, "world.step") == pytest.approx(1.0)
    assert sorted(spans.complete_ticks(s)) == [(0, 1), (0, 2)]
    tick = spans.complete_ticks(s)[(0, 1)]
    own = {x[0]: spans.self_ns(x, tick) for x in tick}
    assert own["episode.tick"] == 9_500_000 - 1_000_000
    assert own["combined.rollout"] == 2_500_000 - 1_000_000


def test_active_share():
    counts = [("episode.active", 0, 1, 0, 4096),
              ("episode.active", 0, 2, 0, 2048)]
    assert spans.active_pct(counts, 4096) == pytest.approx(75.0)
    assert spans.active_pct(counts, 4096, ticks=[(0, 2)]) \
        == pytest.approx(50.0)


def test_readers_return_none_where_their_spans_are_absent():
    s = _combined_ticks()
    assert spans.ms_per_tick(s, "episode.history_write") is None
    assert spans.ms_per_tick([], "world.step") is None
    # spans without a closed tick
    assert spans.ms_per_tick(s[-1:], "combined.actor") is None
    assert spans.active_pct([], 4096) is None
    assert spans.tick_launches(BENCH + DEVICE + LAUNCHES, PROGRAM) is None
    assert spans.tick_launches([], PROGRAM) is None
    assert spans.idle_gaps([], PROGRAM) == []
