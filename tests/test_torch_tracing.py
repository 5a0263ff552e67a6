"""The port's tracer (``rl_mpc_lanemerging_torch/tracing.py``) on the CPU:
off it records nothing and enters no profiler range; on it leaves the
episode loop's outputs bitwise as they are, for the ST controller and the
combined arbiter, and its spans close in the tick that owns them, nest as
the program's layers do, tile each tick by their self times and match the
profiler's ranges one for one; enabling or disabling it inside a span is
harmless; every name the program uses is registered; and the tracer reads
nothing on the host."""

import ast
import functools
import inspect
import json
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rl_mpc_lanemerging_torch import checkpoint, convert
from rl_mpc_lanemerging_torch import main as tmain
from rl_mpc_lanemerging_torch import tasks, tracing
from rl_mpc_lanemerging_torch.agents import ddpg
from rl_mpc_lanemerging_torch.agents.combined import combined_controller
from rl_mpc_lanemerging_torch.planner import mpc
from rl_mpc_lanemerging_torch.sim import CounterRandom, episode, init_world

PACKAGE = os.path.dirname(tracing.__file__)
# combined_default_1 on a narrowed planner (a 5 m, 2 s grid, 10 ADMM
# iterations), 3 scenarios, short episodes in dense traffic
CFG = convert.settings_from_json("configs/combined_default_1.json").replace(
    MAX_SENSED_CARS=12, FUTURE_S=5.0, FUTURE_T=2.0, QP_ITERATIONS=10,
    SEED=4)
EPISODE = dict(max_episode_length=2.4, wait_before_start=2.0)
BATCH = 3

# each span's parent; a span may sit under any of those listed
PARENTS = {
    "episode.tick": {None},
    "episode.sense": {"episode.tick"},
    "episode.history_write": {"episode.tick"},
    "episode.tick_metrics": {"episode.tick"},
    "world.step": {"episode.tick"},
    "controller.plan": {"episode.tick", "combined.arbitrate"},
    "combined.arbitrate": {"episode.tick"},
    "combined.actor": {"combined.arbitrate", "combined.rollout"},
    "combined.rollout": {"combined.arbitrate"},
    "controller.certificate": {"combined.arbitrate"},
    "grid.build": {"controller.plan", "controller.certificate"},
    "grid.forecast": {"grid.build"},
    "dp.solve": {"controller.plan", "controller.certificate"},
    "qp.admm": {"controller.plan"},
}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _controller(kind):
    """(controller, carry) of the ST task or the combined arbiter."""
    if kind == "st":
        return mpc.make_batched_controller(CFG), None
    actor = checkpoint.load_actor("runs/ddpg_default1_extended", "cpu",
                                  CFG.MINIMUM_NEGATIVE_JERK,
                                  CFG.MAXIMUM_POSITIVE_JERK, committed=True)
    control, init_carry, _ = combined_controller(
        ddpg.actor_jerk(actor, CFG), CFG)
    return control, (init_carry(BATCH) if init_carry else None)


def _round(kind):
    control, carry = _controller(kind)
    world = init_world(CFG, BATCH, torch.float32, "cpu")
    return episode.run_episode_batch(
        world, CFG, control, CounterRandom(CFG.SEED),
        record_history=kind == "st", controller_carry=carry, **EPISODE)


@functools.lru_cache(maxsize=None)
def _traced(kind):
    """The round with the tracer off, and with it on under a CPU profiler:
    (outputs off, outputs on, spans, counters, the profiler's ranges)."""
    off = _round(kind)
    tracing.set_round(0)
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = _round(kind)
    finally:
        tracing.disable()
    spans, counts = tracing.records(), tracing.counts()
    tracing.clear()
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name in tracing.SPANS]
    return off, on, spans, counts, ranges


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)


def _ticks(spans):
    return {(s.round, s.tick): s for s in spans if s.name == "episode.tick"}


def test_off_records_nothing_and_enters_no_range():
    assert not tracing.enabled()
    assert tracing.span("episode.tick") is tracing.span("grid.build")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("episode.tick"):
            with tracing.span("grid.build"):
                torch.ones(3).sum()
        tracing.count("episode.active", 3)
    assert tracing.records() == [] and tracing.counts() == []
    assert not [e for e in prof.events() if e.name in tracing.SPANS]


@pytest.mark.parametrize("kind", ["st", "combined"])
def test_outputs_bitwise_equal_with_tracing_on(kind):
    """Stats, worlds and (ST) the crash history, or (combined) the carry:
    the same with the tracer on as off."""
    off, on, spans, _, _ = _traced(kind)
    _equal_trees(off, on)
    assert spans


@pytest.mark.parametrize("kind", ["st", "combined"])
def test_spans_nest_in_their_tick(kind):
    _, (world, stats, *_), spans, counts, _ = _traced(kind)
    ticks = _ticks(spans)
    n = len(ticks)
    assert sorted(ticks) == [(0, t) for t in range(1, n + 1)]
    # the loop ran until every scenario finished or the budget ran out
    assert n == int(stats.ticks.max()) + (
        1 if n < int(EPISODE["max_episode_length"] / CFG.TICK_LENGTH)
        else 0)
    for s in spans:
        assert s.parent in PARENTS[s.name], s
        assert s.start_ns <= s.end_ns
        owner = ticks[(s.round, s.tick)]
        assert owner.start_ns <= s.start_ns <= s.end_ns <= owner.end_ns, s
    names = {s.name for s in spans}
    want = {"episode.tick", "episode.sense", "episode.tick_metrics",
            "world.step", "controller.plan", "grid.build", "grid.forecast",
            "dp.solve", "qp.admm"}
    if kind == "st":
        want |= {"episode.history_write"}
    else:
        want |= {"combined.arbitrate", "combined.rollout", "combined.actor",
                 "controller.certificate"}
    assert names == want
    per_tick = {}
    for s in spans:
        per_tick.setdefault(s.tick, []).append(s.name)
    for names_of_tick in per_tick.values():
        assert names_of_tick.count("grid.forecast") \
            == (CFG.num_t - 1) * names_of_tick.count("grid.build")
        if kind == "combined":
            assert names_of_tick.count("combined.actor") \
                == max(CFG.ROLLOUT_LENGTH, 1)
            assert names_of_tick.count("grid.build") == 2
    # one counter a tick: the scenarios still running as it starts; and
    # one a grid build: its path, 0 (plain) on the CPU
    active = [c for c in counts if c.name == "episode.active"]
    assert [(c.name, c.round, c.tick) for c in active] \
        == [("episode.active", 0, t) for t in range(1, n + 1)]
    paths = [c for c in counts if c.name == "grid.path"]
    assert len(paths) + len(active) == len(counts)
    assert sorted((c.round, c.tick) for c in paths) == sorted(
        (s.round, s.tick) for s in spans if s.name == "grid.build")
    assert all(c.value == 0 for c in paths)
    values = [c.value for c in active]
    assert values[0] == BATCH and values == sorted(values, reverse=True)
    assert all(isinstance(v, int) and v > 0 for v in values)


@pytest.mark.parametrize("kind", ["st", "combined"])
def test_every_span_is_a_profiler_range(kind):
    _, _, spans, _, ranges = _traced(kind)
    assert sorted(s.name for s in spans) == sorted(r[0] for r in ranges)
    # the ranges in order of their start: the spans' nesting order
    by_start = [r[0] for r in sorted(ranges, key=lambda r: (r[1], -r[2]))]
    assert by_start == [s.name for s in sorted(
        spans, key=lambda s: (s.start_ns, -s.end_ns))]


def _self_ns(spans):
    """Each span's duration less its children's: the spans of its tick
    whose parent it is and that lie inside it."""
    out = []
    for s in spans:
        inner = sum(c.end_ns - c.start_ns for c in spans
                    if c is not s and c.parent == s.name
                    and (c.round, c.tick) == (s.round, s.tick)
                    and s.start_ns <= c.start_ns and c.end_ns <= s.end_ns)
        out.append(s.end_ns - s.start_ns - inner)
    return out


@pytest.mark.parametrize("kind", ["st", "combined"])
def test_self_times_tile_each_tick(kind):
    """Children of one span do not overlap, so the self times of a tick's
    spans sum to the tick's duration, and none is negative."""
    _, _, spans, _, _ = _traced(kind)
    for key, tick in _ticks(spans).items():
        own = [s for s in spans if (s.round, s.tick) == key]
        selfs = _self_ns(own)
        assert min(selfs) >= 0
        assert sum(selfs) == tick.end_ns - tick.start_ns
        kids = sorted((c.start_ns, c.end_ns) for c in own
                      if c.parent == "episode.tick")
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))


def test_enabling_or_disabling_inside_a_span_is_harmless():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.enable()
        with tracing.span("episode.tick"):
            tracing.disable()
        with tracing.span("episode.tick"):
            tracing.enable()
        with tracing.span("episode.tick"):
            with tracing.span("grid.build"):
                tracing.disable()
                tracing.enable()
        assert tracing.records() == []
        with tracing.span("episode.tick"):
            with tracing.span("grid.build"):
                pass
    assert [(s.name, s.parent) for s in tracing.records()] \
        == [("grid.build", "episode.tick"), ("episode.tick", None)]


def test_rounds_and_ticks_from_the_task_runner():
    """``evaluate_controller`` numbers the rounds, the loop the ticks."""
    cfg = CFG.replace(OTHER_CAR_SPEED=15.0, BATCH_SCENARIOS=2)
    tracing.enable()
    tasks.evaluate_controller(
        cfg, lambda s: torch.full_like(s.ego_speed, 8.0), num_episodes=4,
        device="cpu", max_episode_length=1.0, wait_before_start=0.4,
        verbose=False)
    tracing.disable()
    got = sorted({(s.round, s.tick) for s in tracing.records()})
    assert got == [(r, t) for r in (0, 1) for t in range(1, 6)]


def _names_at_call_sites(kind):
    pattern = re.compile(r"tracing\.%s\(\s*\"([^\"]+)\"" % kind)
    found = set()
    for folder, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py") and f != "tracing.py":
                with open(os.path.join(folder, f)) as fh:
                    found |= set(pattern.findall(fh.read()))
    return found


def test_every_name_used_is_registered():
    assert _names_at_call_sites("span") == set(tracing.SPANS)
    assert _names_at_call_sites("count") == set(tracing.COUNTERS)
    assert set(ddpg.UPDATE_STAGES) <= set(tracing.SPANS)
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)


def test_the_tracer_reads_nothing_on_the_host():
    """No synchronise, no host read of a tensor, in the tracer's source."""
    tree = ast.parse(inspect.getsource(tracing))
    calls = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            calls.add(f.attr if isinstance(f, ast.Attribute)
                      else getattr(f, "id", None))
    banned = {"item", "cpu", "numpy", "tolist", "synchronize", "bool",
              "int", "float", "to", "nonzero", "any", "all"}
    assert not calls & banned, calls & banned


def test_chrome_trace_and_the_cli_flag(tmp_path, monkeypatch):
    """``--trace-out`` traces the task and writes its spans once, at the
    end, as Chrome-trace JSON; the tracer is off again afterwards."""
    seen = []

    def task(cfg, **kwargs):
        seen.append(tracing.enabled())
        tracing.set_tick(7)
        tracing.count("episode.active", 2)
        with tracing.span("episode.tick"):
            with tracing.span("world.step"):
                pass
    monkeypatch.setattr(tmain, "do_task", task)
    path = tmp_path / "trace.json"
    tmain.main(["configs/st_default.json", "--device", "cpu",
                "--trace-out", str(path)])
    assert seen == [True] and not tracing.enabled()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert [(e["name"], e["args"]["parent"], e["args"]["tick"])
            for e in spans] == [("world.step", "episode.tick", 7),
                                ("episode.tick", None, 7)]
    assert spans[1]["ts"] <= spans[0]["ts"] \
        and spans[0]["ts"] + spans[0]["dur"] \
        <= spans[1]["ts"] + spans[1]["dur"]
    assert [(e["name"], e["args"]["value"]) for e in events
            if e["ph"] == "C"] == [("episode.active", 2)]
