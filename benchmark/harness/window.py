"""The measured window: a clock on the controller's entries, the spans of
a traced run, and the samples the correctness check compares.

The program calls its controller once a control tick and synchronises once
a tick (``bool(done.all())`` in its episode loop), so the controller's
entries on the host clock are tick boundaries.  :class:`Window` wraps the
controller; at the first entry past the deadline it raises
:class:`WindowClosed`, which the harness catches.  Rounds are told apart by
a wrapper on the episode loop's traffic warm-up.

In a traced run (``trace=True``) the window also synchronises around the
controller and around the calls it wraps into the grid build, the QP and
the lattice DP kernel (K1), each under a ``record_function`` range named
``bench/<span>``, on ``SPAN_TICKS`` control ticks of the first round from
tick ``trace_from``, and runs ``torch.profiler`` over ``profile_ticks`` of
them from the second.  The ticks before ``trace_from`` run as in an
untraced run: the host-clock tail and the tick that the idle share divides
by are read there (the ticks after a profile run slower).

For the correctness check the window keeps, of the seed-drawn tick and of
the last one, the sensed state, the controller's answer and what the
program noted inside the tick (:meth:`Window.note`: the arbiter's plan and
certificate), and of the seed-drawn tick also the world it was sensed
from.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["WindowClosed", "Window", "clone_tree", "SPAN_TICKS"]

SPAN_TICKS = 16         # ticks with spans, the profiled ones among them


class WindowClosed(Exception):
    """Raised at the first controller entry past the window's deadline."""


def clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, tuple):
        return tuple(clone_tree(y) for y in x)
    return x


class Window:
    def __init__(self, seconds: float, trace: bool = False,
                 capture_tick: int = 0, trace_from: int = 1,
                 profile_ticks: int = 3, clock: Callable = time.perf_counter):
        self.seconds = seconds
        self.trace = trace
        self.capture_tick = capture_tick
        self.trace_from = trace_from
        self.profile_ticks = profile_ticks
        self.clock = clock
        self.t0 = self.t_end = self.deadline = None
        self.entries: List[float] = []     # controller entries
        self.rounds: List[int] = []        # their round
        self.round = -1
        self.round_starts: List[float] = []
        self.tick_in_round = 0
        # traced: per span, seconds inside it by the tick's entry index
        self.spans: Dict[str, Dict[int, float]] = {}
        self.spanned = None                # entries (first, last) spanned
        # correctness samples
        self.start_state = None            # first tick of the first round
        self.samples: List[dict] = []      # {"tick", "round", "state",
        self._last: Optional[dict] = None  # "out", "next", "noted", "world"}
        self._noted: Dict[str, torch.Tensor] = {}
        self._sensed = None                # (state, world) of the sample
        # profiler
        self.profiler = None
        self.profile_window_s = None
        self.profiled = (0, 0)              # entries [first, last) profiled
        self.k1_inputs: List[tuple] = []   # last profiled tick's launches
        self._k1_tick: List[tuple] = []

    # --- clock ---------------------------------------------------------
    def start(self) -> None:
        self.t0 = self.clock()
        self.deadline = self.t0 + self.seconds

    def past_deadline(self) -> bool:
        return self.clock() >= self.deadline

    def close(self) -> None:
        if self.t_end is None:
            self.t_end = self.clock()

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def new_round(self) -> None:
        self.round += 1
        self.tick_in_round = 0
        self.round_starts.append(self.clock())

    # --- spans ---------------------------------------------------------
    def _sync(self) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def spanning(self) -> bool:
        """Whether this tick holds spans: a traced run's first round, its
        SPAN_TICKS ticks from ``trace_from``."""
        return (self.trace and bool(self.entries) and self.round == 0
                and 0 <= self.tick_in_round - self.trace_from < SPAN_TICKS)

    @property
    def disturbed(self):
        """Entries [first, last]: the first with spans and every one after
        it (the ticks after a profile run slower than untraced ones)."""
        if self.spanned is None:
            return self.profiled
        return (self.spanned[0], len(self.entries))

    def _add_span(self, name: str, seconds: float) -> None:
        ticks = self.spans.setdefault(name, {})
        i = len(self.entries) - 1
        ticks[i] = ticks.get(i, 0.0) + seconds

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a call into a layer, synchronised, in a tick that holds
        spans."""
        if not self.spanning():
            yield
            return
        self._sync()
        t = self.clock()
        with torch.profiler.record_function("bench/" + name):
            yield
            self._sync()
        self._add_span(name, self.clock() - t)

    def wrap_span(self, name: str, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def wrap_k1(self, fn: Callable) -> Callable:
        """The K1 entry, timed as a span; its inputs kept on the profiled
        ticks for the kernel's work count."""
        def wrapped(obstacles, s_values, ego_speed, ego_accel, distances,
                    *args, **kwargs):
            if self.profiling():
                self._k1_tick.append((obstacles, distances, ego_speed,
                                      ego_accel))
            with self.span("k1"):
                return fn(obstacles, s_values, ego_speed, ego_accel,
                          distances, *args, **kwargs)
        return wrapped

    # --- profiler ------------------------------------------------------
    def profiling(self) -> bool:
        return self.profiler is not None and self.profile_window_s is None

    def stop_profiler(self) -> None:
        """Stop the profiler (at the tick after the profiled ones, or where
        the window closes first) and move the last profiled tick's K1
        inputs off the card, so that they hold no device memory through
        the rest of the window."""
        if not self.profiling():
            return
        self._sync()
        self.profile_window_s = self.clock() - self._profile_t0
        self.profiler.stop()
        self.profiled = (self.profiled[0], len(self.entries) - 1)
        self.k1_inputs = [tuple(x.detach().cpu() for x in launch)
                          for launch in self._k1_tick]
        self._k1_tick = []

    def _profile_step(self, tick: int) -> None:
        if self.profiling():
            if self.round != 0 \
                    or tick > self.trace_from + self.profile_ticks:
                self.stop_profiler()
            else:
                self._k1_tick = []
        elif (self.profiler is None and self.round == 0
              and tick == self.trace_from + 1 and self.profile_ticks > 0):
            from torch.profiler import ProfilerActivity, profile
            self._sync()
            self.profiler = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            self.profiler.start()
            self._profile_t0 = self.clock()
            self.profiled = (len(self.entries) - 1, len(self.entries) - 1)

    # --- what the program notes inside a tick --------------------------
    def note(self, name: str, value: torch.Tensor) -> None:
        """Keep ``value``, an answer the program worked out inside this
        tick's controller call, with the tick's sample."""
        self._noted[name] = value.detach().clone()

    def note_sense(self, state, world: Callable) -> None:
        """The sensed ``state`` and ``world()``, the fields it was sensed
        from, kept (copied) only where the next tick is the seed-drawn
        one."""
        if self.round == 0 and self.tick_in_round + 1 == self.capture_tick:
            self._sensed = (state, clone_tree(tuple(world())))

    # --- the controller ------------------------------------------------
    def wrap_controller(self, controller: Callable) -> Callable:
        def wrapped(state, *carry):
            now = self.clock()
            if now >= self.deadline:
                self.t_end = now
                if self._last is not None and self._last["round"] == \
                        self.round:
                    self._last["next"] = clone_tree(tuple(state))
                raise WindowClosed
            self.entries.append(now)
            self.rounds.append(self.round)
            self.tick_in_round += 1
            tick = self.tick_in_round
            if self._last is not None:
                if self._last["round"] == self.round:
                    self._last["next"] = clone_tree(tuple(state))
                if self._last["tick"] == self.capture_tick \
                        and self._last["round"] == 0:
                    self.samples.append(self._last)
            if self.round == 0 and tick == 1:
                self.start_state = clone_tree(tuple(state))
            if self.trace:
                self._profile_step(tick)
                if self.spanning():
                    i = len(self.entries) - 1
                    self.spanned = (i if self.spanned is None
                                    else self.spanned[0], i)
            world = None
            if self._sensed is not None and self._sensed[0] is state:
                world = self._sensed[1]
            self._sensed = None
            self._noted = {}
            with self.span("controller"):
                out = controller(state, *carry)
            first = out[0] if carry else out
            self._last = {"tick": tick, "round": self.round,
                          "state": clone_tree(tuple(state)),
                          "out": clone_tree(first), "next": None,
                          "noted": self._noted, "world": world}
            self._noted = {}
            return out
        return wrapped

    def final_samples(self) -> List[dict]:
        """The seed-drawn tick and the window's last completed tick."""
        out = list(self.samples)
        if self._last is not None and all(
                s is not self._last for s in out):
            out.append(self._last)
        return out
