"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the look for a chip
skipped), 4 scenarios, with one fault planted in the program: a world step
that leaves the state as it was, half of the batch left out, an answer
altered where it is produced (the command; the sensed state; in the
arbiter its plan, whoever takes over, and its certificate).  The limits
are the cells' own.  (The cells run on one chip: there is no exchange
between chips to leave out.)"""

import argparse
import time

import pytest
import torch

from harness import main, program

SECONDS = 10.0


def _run(cell, seed=3_000_000_019, control=False):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=SECONDS,
                              trace=0)
    out = main.run_cell(args, time.perf_counter(),
                        device=torch.device("cpu"), control=control)
    return out.result, out.rows, out.numbers


def _failed(rows):
    return [name for name, value, limit in rows
            if value is None or not value <= limit]


CELLS = ["st_default.row4096", "combined_default_1.row4096"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    result, rows, numbers = _run(cell)
    assert result["correct"], rows
    assert numbers["compared"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s", "scen_ticks_per_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(tiny_root, monkeypatch, cell):
    from rl_mpc_lanemerging_torch.sim import episode
    step = episode.world_step

    def stuck(world, cmd, cfg, rng):
        # traffic warms up; once the ego is on the road nothing moves
        return world if bool(world.ego_active.any()) else step(world, cmd,
                                                                cfg, rng)
    monkeypatch.setattr(episode, "world_step", stuck)
    result, rows, _ = _run(cell)
    assert not result["correct"]
    assert "ego_step_err" in _failed(rows)


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(tiny_root, monkeypatch, cell):
    build = program.build

    def half(cfg, device):
        parts = build(cfg, device)
        inner = parts.controller

        def controller(state, *carry):
            out = inner(state, *carry)
            first = out[0] if carry else out
            speed = first[0] if isinstance(first, tuple) else first
            n = speed.shape[0] // 2
            speed[n:] = state.ego_speed[n:]     # the rest coast
            return out
        return parts._replace(controller=controller)
    monkeypatch.setattr(program, "build", half)
    result, rows, _ = _run(cell)
    assert not result["correct"]
    assert "cmd_mismatch_pct" in _failed(rows)


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(tiny_root, monkeypatch, cell):
    from rl_mpc_lanemerging_torch.agents import combined
    from rl_mpc_lanemerging_torch.planner import mpc
    if cell.startswith("st"):
        control = mpc.batched_st_control

        def altered(*args, **kwargs):
            speed, *rest = control(*args, **kwargs)
            return (speed + torch.tensor([0.5, 0.0, 0.0, 0.0]), *rest)
        monkeypatch.setattr(mpc, "batched_st_control", altered)
    else:
        arbitrate = combined.arbitrate

        def altered(*args, **kwargs):
            d = arbitrate(*args, **kwargs)
            return d._replace(speed=d.speed
                              + torch.tensor([0.5, 0.0, 0.0, 0.0]))
        monkeypatch.setattr(combined, "arbitrate", altered)
    result, rows, _ = _run(cell)
    assert not result["correct"]
    assert "cmd_mismatch_pct" in _failed(rows)


@pytest.mark.parametrize("cell", CELLS)
def test_sensed_state_altered_where_produced(tiny_root, monkeypatch, cell):
    from rl_mpc_lanemerging_torch.sim import episode
    sense = episode.sense

    def altered(world, cfg):
        state = sense(world, cfg)
        return state._replace(other_speed=state.other_speed + 0.5)
    monkeypatch.setattr(episode, "sense", altered)
    result, rows, _ = _run(cell)
    assert not result["correct"]
    assert "sense_err" in _failed(rows)


def test_plan_altered_where_produced(tiny_root, monkeypatch):
    """In the arbiter the plan's command is the one sent only where the
    planner takes over; the plan is held to the reference's every tick."""
    from rl_mpc_lanemerging_torch.planner import mpc
    control = mpc.batched_st_control

    def altered(*args, **kwargs):
        speed, *rest = control(*args, **kwargs)
        return (speed + torch.tensor([0.5, 0.0, 0.0, 0.0]), *rest)
    monkeypatch.setattr(mpc, "batched_st_control", altered)
    result, rows, _ = _run("combined_default_1.row4096")
    assert not result["correct"]
    assert "plan_mismatch_pct" in _failed(rows)


def test_certificate_altered_where_produced(tiny_root, monkeypatch):
    from rl_mpc_lanemerging_torch.planner import mpc
    certify = mpc.batched_test_guaranteed_crash

    def altered(*args, **kwargs):
        return ~certify(*args, **kwargs)
    monkeypatch.setattr(mpc, "batched_test_guaranteed_crash", altered)
    result, rows, _ = _run("combined_default_1.row4096")
    assert not result["correct"]
    assert "cert_mismatch_pct" in _failed(rows)
