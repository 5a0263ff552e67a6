"""The port's one tracer: spans at the layer boundaries of a control tick,
and counters beside them.

Off (the default), :func:`span` returns one shared no-op context after a
single flag check and :func:`count` returns at once: nothing is allocated
or recorded and no profiler range is entered.

On (:func:`enable`), every span is kept in memory as a :class:`Span`
``(name, parent, round, tick, start_ns, end_ns)`` on one host clock
(``time.perf_counter_ns``); ``parent`` is the name of the enclosing span.
``round`` and ``tick`` name the control tick of the lockstep batch: the
task runner sets the round (:func:`set_round`) and the episode loop the
tick (:func:`set_tick`), so every span of one tick shares them.  Each span
also enters ``torch.profiler.record_function(name)``: while a profiler
runs, the spans are ranges in its trace, on one clock with the device's
operations.  Counters are kept as :class:`Count` ``(name, round, tick,
t_ns, value)``.  Nothing is written out until :func:`write_chrome_trace`.

The tracer never synchronises and never reads a tensor: a span's times are
the host's, so a span measures the host's time in a layer (launches, and
any wait for the device that the layer's own code makes).  A span that the
tracer was enabled or disabled inside records nothing.

Every span name the program uses is in :data:`SPANS`, and every counter
name in :data:`COUNTERS`.
"""

from __future__ import annotations

import json
import time
from typing import List, NamedTuple, Optional

import torch

__all__ = ["SPANS", "COUNTERS", "Span", "Count", "span", "count",
           "set_round", "set_tick", "enable", "disable", "enabled",
           "records", "counts", "clear", "write_chrome_trace"]

SPANS = (
    # the episode loop and the world (sim/episode.py)
    "episode.tick",             # one control tick: the parent of the rest
    "episode.sense",
    "episode.history_write",    # record_tick (crash capture)
    "episode.tick_metrics",     # _tick_metrics and the aux-bin scatter
    "world.step",               # world_step and _select_world
    # the controller (planner/mpc.py, agents/combined.py)
    "controller.plan",          # mpc.batched_st_control
    "controller.certificate",   # mpc.batched_test_guaranteed_crash
    "combined.arbitrate",       # arbitrate; its self time is the gates
    "combined.rollout",         # _rl_rollout
    "combined.actor",           # every policy call
    # the planner's layers
    "grid.build",               # build_st_grid; its self time is the
                                # kernel's launch, or the plain marking
    "grid.forecast",            # one predict_step_without_ego of a slice
                                # (the plain path only)
    "dp.solve",                 # the lattice DP (K1 or its dense twin)
    "qp.admm",                  # qp.finer_fit_qp
    # one DDPG update (agents/ddpg.py UPDATE_STAGES)
    "ddpg.replay_draw", "ddpg.target", "ddpg.critic_step",
    "ddpg.actor_step", "ddpg.polyak",
)

COUNTERS = (
    "episode.active",           # scenarios still running as a tick starts
    "grid.path",                # a grid build: 1 by the kernel, 0 plain
)


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    round: int
    tick: int
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    name: str
    round: int
    tick: int
    t_ns: int
    value: float


class _Off:
    """The shared context of a span while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """One span while the tracer is on."""

    __slots__ = ("tracer", "name", "parent", "round", "tick", "start",
                 "stack", "range")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        t = self.tracer
        self.stack = t.stack
        self.parent = self.stack[-1].name if self.stack else None
        self.round, self.tick = t.round, t.tick
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.stack.append(self)
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        if self.stack and self.stack[-1] is self:
            self.stack.pop()
        t = self.tracer
        # recorded only where the tracer stayed on from enter to exit: each
        # enable and disable gives it a new stack
        if t.on and self.stack is t.stack:
            t.spans.append(Span(self.name, self.parent, self.round,
                                self.tick, self.start, end))
        return False


class Tracer:
    """The tracer's state: whether it is on, the open spans, the round and
    tick, and what was recorded."""

    def __init__(self):
        self.on = False
        self.stack: List[_Open] = []
        self.round = 0
        self.tick = 0
        self.spans: List[Span] = []
        self.counts: List[Count] = []


_tracer = Tracer()


def span(name: str):
    """A context manager: the span ``name`` (one of :data:`SPANS`)."""
    if not _tracer.on:
        return _OFF
    return _Open(_tracer, name)


def count(name: str, value) -> None:
    """Record the counter ``name`` (one of :data:`COUNTERS`) at ``value``,
    a number the caller already holds on the host."""
    if not _tracer.on:
        return
    t = _tracer
    t.counts.append(Count(name, t.round, t.tick, time.perf_counter_ns(),
                          value))


def set_round(r: int) -> None:
    """The task runner's round that the next spans belong to."""
    _tracer.round = r
    _tracer.tick = 0


def set_tick(tick: int) -> None:
    """The episode loop's control tick that the next spans belong to."""
    _tracer.tick = tick


def enable() -> None:
    _tracer.on = True
    _tracer.stack = []


def disable() -> None:
    _tracer.on = False
    _tracer.stack = []


def enabled() -> bool:
    return _tracer.on


def records() -> List[Span]:
    """The spans recorded since the last :func:`clear`, in the order they
    closed."""
    return list(_tracer.spans)


def counts() -> List[Count]:
    """The counters recorded since the last :func:`clear`."""
    return list(_tracer.counts)


def clear() -> None:
    _tracer.spans = []
    _tracer.counts = []


def write_chrome_trace(path: str) -> None:
    """Write the recorded spans and counters to ``path`` as Chrome-trace
    JSON (chrome://tracing, Perfetto): a span is a complete event with its
    round, tick and parent among its arguments, a counter a counter event;
    times in microseconds of the host clock."""
    events = [{"name": s.name, "cat": "span", "ph": "X", "pid": 0,
               "tid": 0, "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"round": s.round, "tick": s.tick,
                        "parent": s.parent}}
              for s in _tracer.spans]
    events += [{"name": c.name, "cat": "counter", "ph": "C", "pid": 0,
                "tid": 0, "ts": c.t_ns / 1e3, "args": {"value": c.value}}
               for c in _tracer.counts]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
