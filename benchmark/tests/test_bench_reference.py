"""The plain reference against the program's CPU path at a small size.

On the CPU the program's controller takes its dense DP, which runs the
reference solver's expressions, so the two agree to the bit on every
stage; on the card the program's K1 differs from the dense DP on a few f32
near-ties, which the check's limits allow for (PERF.md)."""

import pytest
import torch

from reference import arbiter, planner
from reference import sense as ref_sense
from reference import world as ref_world
from reference.forecast import State
from reference.settings import params

from harness import spec

BATCH = 6
TICKS = (1, 30, 45, 60)


def _config(name):
    import json
    import os
    with open(os.path.join(spec.BENCH_DIR, "configs", name + ".json")) as fh:
        return json.load(fh)


def _worlds():
    """A small batch's worlds at a few ticks after the traffic warm-up,
    the ego driven at 16 m/s: on the ramp, at the merge, past it."""
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world
    from rl_mpc_lanemerging_torch.sim.episode import warmup
    from rl_mpc_lanemerging_torch.sim.world import add_ego, world_step
    cfg = Settings.from_dict({**_config("st_default")["settings"],
                              "BATCH_SCENARIOS": BATCH, "SEED": 5})
    rng = CounterRandom(3_000_000_007)
    world = warmup(init_world(cfg, BATCH, device="cpu"), cfg, 250, rng)
    world = add_ego(world, torch.full((BATCH,), 12.0))
    for tick in range(1, max(TICKS) + 1):
        world = world_step(world, torch.full((BATCH,), 16.0), cfg, rng)
        if tick in TICKS:
            yield tick, world, cfg


@pytest.fixture(scope="module")
def states():
    """Sensed states of a small batch at a few ticks after the traffic
    warm-up, the ego driven at 16 m/s: on the ramp, at the merge, past it."""
    from rl_mpc_lanemerging_torch.sim.world import sense
    return {tick: sense(world, cfg) for tick, world, cfg in _worlds()}


def _port_cfg(name):
    from rl_mpc_lanemerging_torch.config import Settings
    return Settings.from_dict(_config(name)["settings"])


def test_grid_dp_and_command_equal_the_programs(states):
    from rl_mpc_lanemerging_torch.ops import st_dp
    from rl_mpc_lanemerging_torch.planner import mpc
    from rl_mpc_lanemerging_torch.planner.grid import build_st_grid
    cfg = _port_cfg("st_default")
    p = params(_config("st_default")["settings"])
    busy = 0
    for tick, hs in states.items():
        s = State(*hs)
        obst, s_val, dist = planner.build_grid(s, p)
        g = build_st_grid(hs, cfg)
        assert torch.equal(obst, g.obstacles)
        assert torch.equal(s_val, g.s_values)
        assert torch.equal(dist, g.distances)
        busy += int(obst.any())
        seq = planner.solve_dp(obst, s_val, s.ego_speed, s.ego_accel, dist,
                               p)
        want = st_dp.solve_st_fast(
            g.obstacles, g.s_values, g.t_values, g.ego_speed, hs.ego_accel,
            g.distances, mpc.weights_from_settings(cfg), mpc._max_offset(cfg))
        assert torch.equal(seq, want)
        speed = planner.st_control(s, p)[0]
        assert torch.equal(speed, mpc.batched_st_control(hs, cfg)[0])
        assert torch.equal(planner.certificate(s, p),
                           mpc.batched_test_guaranteed_crash(hs, cfg))
    assert busy >= 1          # some grid holds an obstacle


def test_control_moves_the_command(states):
    """The control's TF32 products move the smoothed command."""
    p = params(_config("st_default")["settings"])
    s = State(*states[45])
    gap = (planner.st_control(s, p)[0]
           - planner.st_control(s, p, tf32=True)[0]).abs()
    assert float(gap.max()) > 1e-4


def test_arbiter_equals_the_programs(states):
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.agents.combined import arbitrate
    config = _config("combined_default_1")
    cfg = _port_cfg("combined_default_1")
    p = params(config["settings"])
    import os
    actor = arbiter.Actor(os.path.join(spec.ROOT, config["actor_weights"]),
                          p.MINIMUM_NEGATIVE_JERK, p.MAXIMUM_POSITIVE_JERK,
                          "cpu")
    policy = ddpg.actor_jerk(ddpg._actor_on(cfg, None, torch.device("cpu")),
                             cfg)
    for hs in states.values():
        r = arbiter.decide(actor, State(*hs), p)
        d = arbitrate(policy, hs, cfg, None)
        for ours, theirs in (("take", "take"), ("gate_a", "crash_pred"),
                             ("gate_b", "over_speed"),
                             ("gate_c", "condemned"),
                             ("gate_d", "st_better")):
            assert torch.equal(getattr(r, ours), getattr(d, theirs)), ours
        assert torch.allclose(r.speed, d.speed, rtol=0, atol=1e-5)
        assert torch.allclose(r.plan, d.st_speed, rtol=0, atol=1e-5)


def test_sensing_equals_the_programs():
    from rl_mpc_lanemerging_torch.sim.world import sense
    p = params(_config("st_default")["settings"])
    for tick, world, cfg in _worlds():
        want = sense(world, cfg)
        got = ref_sense.sense(
            world.cars_x, world.cars_v, world.cars_prev_v, world.cars_active,
            world.ego_active, world.ego_arc, world.ego_v, world.ego_prev_v,
            p, slots=want.other_x.shape[1])
        k = want.other_x.shape[1]
        assert not bool(got.other_present[:, k:].any())
        assert bool(want.other_present.any()), tick
        for a, b in zip(want, got):
            assert torch.equal(a, b[:, :k] if a.dim() == 2 else b), tick


def test_world_rules_equal_the_programs():
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world
    from rl_mpc_lanemerging_torch.sim.episode import _sample_start_speed
    from rl_mpc_lanemerging_torch.sim.world import add_ego, world_step
    cfg = Settings().replace(BATCH_SCENARIOS=64)
    p = params({})
    seed = 2 ** 31 + 12345
    world = init_world(cfg, 64, device="cpu")._replace(
        steps=torch.full((64,), 250, dtype=torch.int64))
    want = _sample_start_speed(world, cfg, CounterRandom(seed))
    got = ref_world.start_speeds(seed, world.steps, p)
    assert torch.equal(got, want)
    world = add_ego(world, want)
    cmd = want + torch.linspace(-3.0, 3.0, 64)
    after = world_step(world, cmd, cfg, CounterRandom(seed))
    assert torch.equal(ref_world.ego_speed_after(world.ego_v, cmd, p),
                       after.ego_v)
