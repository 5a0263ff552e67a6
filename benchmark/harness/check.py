"""Decide ``correct``: the window's answers against the plain reference.

The reference follows the program from the sensed states the window's
controller was given (it does not simulate the traffic again); what it
checks:

* ``start_speed_err``: the first round's first sensed ego speeds against
  the start-speed draw of the run's seed (exact);
* ``sense_err``, ``sense_slots_differ``: the seed-drawn tick's sensed
  state against the reference's own snapshot of the world it was sensed
  from: the largest gap of a value, and the car slots whose presence
  differs (exact);
* ``ego_step_err``: each sampled command against the ego speed the world
  shows at the next tick, by the speedMode-22 update (exact);
* ``cmd_mismatch_pct``: the share of sampled commands of scenarios whose
  ego is on the road that differ from the reference's by more than
  ``speed_tol`` m/s;
* in the arbiter, over the same scenarios: ``plan_mismatch_pct``, the share
  of the plan's speed commands (worked out every tick, whoever takes over)
  off by more than ``PLAN_TOL`` m/s; ``cert_mismatch_pct``, the share of
  certificates (gate c) that differ; ``take_mismatch_pct``, the share of
  takeover flags that differ.

A sample is a tick: the one drawn from the seed and the window's last
completed one, every scenario of each.  The reference runs on the card in
blocks of ``CHECK_BLOCK`` rows after the window, in float32 with TF32 off;
with ``tf32=True`` it stands in for the program as the control, and with
``fault`` one of ``FAULTS`` the reference's decision with that gate
dropped stands in for a program with the fault planted.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from reference import arbiter, planner
from reference import world as ref_world
from reference.forecast import State
from reference.sense import sense
from reference.settings import params

__all__ = ["CHECK_BLOCK", "PLAN_TOL", "FAULTS", "reference_answers",
           "compare", "verdict", "ABSENT_X"]

ABSENT_X = -200.0       # where a sensed state puts an ego that has left
CHECK_BLOCK = 512       # rows of the reference worked out at once
PLAN_TOL = 1e-3         # m/s: a plan's command apart from the reference's
FAULTS = ("gate_a", "gate_c")


def _present(state: State):
    return ~((state.ego_x == ABSENT_X) & (state.ego_y == 0.0))


def _rows(state: State, idx) -> State:
    return State(*(x[idx] for x in state))


def _dropped(d: arbiter.Decision, gate: str) -> arbiter.Decision:
    """``d`` with ``gate`` never raised: the fault a program would have
    that leaves out that gate."""
    d = d._replace(**{gate: torch.zeros_like(d.take)})
    take = d.gate_a | d.gate_b | d.gate_c | d.gate_d
    return d._replace(take=take,
                      speed=torch.where(take, d.plan, d.rl_speed)
                      .to(d.speed.dtype))


def reference_answers(task: str, p, state: State, tf32: bool,
                      actor: Optional[arbiter.Actor] = None,
                      fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The reference's answers for ``state``, each (B,): ``speed``; in the
    arbiter also ``take``, ``plan`` and ``cert``."""
    parts: Dict[str, list] = {}
    n = state.ego_x.shape[0]
    for i in range(0, n, CHECK_BLOCK):
        part = _rows(state, slice(i, i + CHECK_BLOCK))
        if task == "ST":
            got = {"speed": planner.st_control(part, p, tf32=tf32)[0]}
        else:
            d = arbiter.decide(actor, part, p, tf32=tf32)
            if fault is not None:
                d = _dropped(d, fault)
            got = {"speed": d.speed, "take": d.take, "plan": d.plan,
                   "cert": d.gate_c}
        for k, v in got.items():
            parts.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in parts.items()}


def load_actor(config: dict, p, device, root: str) -> arbiter.Actor:
    """The trained actor from its raw weight file (``actor_weights`` of the
    configuration, relative to the checkout), which the program reads too."""
    return arbiter.Actor(os.path.join(root, config["actor_weights"]),
                         p.MINIMUM_NEGATIVE_JERK, p.MAXIMUM_POSITIVE_JERK,
                         device)


def _sense_gaps(state: State, world, p):
    """(largest gap of a value, car slots whose presence differs) between
    the program's sensed ``state`` and the reference's snapshot of
    ``world``."""
    ref = sense(*world, p, slots=state.other_x.shape[1])
    k = state.other_x.shape[1]
    gap = max(float((a - b).abs().max()) for a, b in
              zip(state[:4], ref[:4]))
    both = state.other_present & ref.other_present[:, :k]
    for a, b in zip(state[4:7], ref[4:7]):
        gap = max(gap, float(torch.where(both, (a - b[:, :k]).abs(), 0.0)
                             .max()))
    slots = int((state.other_present != ref.other_present[:, :k]).sum()) \
        + int(ref.other_present[:, k:].sum())
    return gap, slots


def compare(config: dict, workload: dict, samples: List[dict],
            start_state, seed: int, warm_steps: int, device, root: str,
            tf32: bool = False, fault: Optional[str] = None
            ) -> Dict[str, float]:
    """The check's numbers for one run's samples; ``workload`` gives the
    commands' tolerance ``speed_tol``."""
    task = config["settings"]["TASK"]
    p = params(config["settings"])
    actor = load_actor(config, p, device, root) if task != "ST" else None
    out: Dict[str, float] = {}

    if start_state is not None:
        s = State(*(x.to(device) for x in start_state))
        want = ref_world.start_speeds(
            seed, torch.full_like(s.ego_x, warm_steps, dtype=torch.int64), p,
            s.ego_speed.dtype)
        on = _present(s)
        out["start_speed_err"] = float(
            torch.where(on, (s.ego_speed - want).abs(), 0.0).max())

    step_err = sense_err = sense_slots = None
    count = {"cmd": 0, "plan": 0, "cert": 0, "take": 0}
    compared = 0
    gaps = []
    for sample in samples:
        s = State(*(x.to(device) for x in sample["state"]))
        if sample.get("world") is not None:
            sense_err, sense_slots = _sense_gaps(
                s, [x.to(device) for x in sample["world"]], p)
        got = sample["out"]
        got_speed = (got[0] if isinstance(got, tuple) else got).to(device)
        if sample.get("next") is not None:
            nxt = State(*(x.to(device) for x in sample["next"]))
            both = _present(s) & _present(nxt)
            want_v = ref_world.ego_speed_after(s.ego_speed, got_speed, p)
            err = float(torch.where(both, (nxt.ego_speed - want_v).abs(),
                                    0.0).max())
            step_err = err if step_err is None else max(step_err, err)
        idx = torch.nonzero(_present(s)).flatten()
        if idx.numel() == 0:
            continue
        ref = reference_answers(task, p, _rows(s, idx), tf32, actor, fault)
        gap = (got_speed[idx].to(ref["speed"].dtype) - ref["speed"]).abs()
        gaps.append(gap)
        count["cmd"] += int((gap > workload["speed_tol"]).sum())
        compared += idx.numel()
        if task == "ST":
            continue
        noted = sample.get("noted") or {}
        if "plan" in noted and count["plan"] is not None:
            plan = noted["plan"].to(device)[idx].to(ref["plan"].dtype)
            count["plan"] += int(((plan - ref["plan"]).abs()
                                  > PLAN_TOL).sum())
        else:
            count["plan"] = None
        if "cert" in noted and count["cert"] is not None:
            count["cert"] += int((noted["cert"].to(device)[idx].bool()
                                  != ref["cert"]).sum())
        else:
            count["cert"] = None
        count["take"] += int((got[1].to(device)[idx].bool()
                              != ref["take"]).sum())
    # a number with nothing behind it is None, and fails its limit
    out["sense_err"] = sense_err
    out["sense_slots_differ"] = sense_slots
    out["ego_step_err"] = step_err

    def pct(name):
        n = count[name]
        return None if n is None or not compared else 100.0 * n / compared
    out["cmd_mismatch_pct"] = pct("cmd")
    if task != "ST":
        for name in ("plan", "cert", "take"):
            out[f"{name}_mismatch_pct"] = pct(name)
    out["compared"] = compared
    if gaps:
        # not limited: how far the commands that differ lie
        gap = torch.cat(gaps).double()
        out["cmd_gap_max"] = float(gap.max())
        for tol in (1e-4, 1e-3, 1e-2, 1e-1, 1.0):
            out[f"pct_over_{tol:g}"] = 100.0 * float((gap > tol).double()
                                                     .mean())
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every limited number at or below
    its limit; a number that could not be read fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        rows.append((name, value, limit))
        if value is None or not value <= limit:
            ok = False
    return ok, rows
