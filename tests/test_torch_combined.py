"""The port's combined RL+MPC arbiter against the JAX package, in float64 on
the CPU with the dense DP on both sides and the same trained actor:
``path_mean_abs_jerk``, the virtual rollout, ``combined_controller`` under
every gate setting (takeover flags identical, speeds to 1e-6), the episode
loop's flag bookkeeping and controller carry, and one episode round with the
JAX draws replayed."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxReplay, jax_state_to_torch, jax_world_to_torch,
                           random_states, to_np)
from rl_mpc_lanemerging_torch import checkpoint as tcheckpoint
from rl_mpc_lanemerging_torch import convert, main as tmain, tasks as ttasks
from rl_mpc_lanemerging_torch.agents import combined as tcomb
from rl_mpc_lanemerging_torch.agents import ddpg as tddpg
from rl_mpc_lanemerging_torch.sim import CounterRandom, episode as tep
from rl_mpc_lanemerging_torch.sim import world as tworld
from rl_mpc_lanemerging_tpu.agents import combined as jcomb
from rl_mpc_lanemerging_tpu.agents import ddpg as jddpg
from rl_mpc_lanemerging_tpu.checkpoint import load_params
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.prediction import HighwayState, make_state
from rl_mpc_lanemerging_tpu.sim import episode as jep
from rl_mpc_lanemerging_tpu.sim import world as jworld

RUN = "runs/ddpg_default1_extended"
# combined_default_1 on a narrowed planner: 12 sensed slots, a 15 m grid
# (301 cells) and 30 ADMM iterations keep the JAX compiles short
SMALL = dict(MAX_SENSED_CARS=12, FUTURE_S=15.0, QP_ITERATIONS=30)
CFG = Settings.load_from_file("configs/combined_default_1.json").replace(
    **SMALL)
TCFG = convert.settings_from_json("configs/combined_default_1.json").replace(
    **SMALL)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return load_params(RUN)["actor"]


@functools.lru_cache(maxsize=None)
def _torch_policy():
    actor = tcheckpoint.load_actor(RUN, "cpu", TCFG.MINIMUM_NEGATIVE_JERK,
                                   TCFG.MAXIMUM_POSITIVE_JERK,
                                   committed=True).double()
    return tddpg.actor_jerk(actor, TCFG)


def _states(seed=11, batch=10):
    """Random sensed states plus four built ones: a free road, a stopped
    car just ahead of a merged ego (the rollout crashes), an ego that passes
    STOP_X during the rollout (it freezes), and a slow ego that a faster car
    closes in on."""
    d = random_states(np.random.default_rng(seed), batch - 4, CFG)
    k = CFG.MAX_SENSED_CARS
    built = [make_state(-150.0, 10.0, 12.0, 0.0, [], [], [], num_slots=k),
             make_state(-10.0, -1.6, 12.0, 0.0, [-4.0], [0.0], [0.0],
                        num_slots=k),
             make_state(62.0, -1.6, 14.0, 0.5, [90.0, 30.0], [8.0, 7.0],
                        [0.0, 0.0], num_slots=k),
             make_state(5.0, -1.6, 3.0, 0.0, [-8.0], [15.0], [0.0],
                        num_slots=k)]
    out = {}
    for f in HighwayState._fields:
        rows = [np.asarray(getattr(s, f)) for s in built]
        out[f] = np.concatenate([d[f], np.stack(rows).astype(d[f].dtype)])
    return HighwayState(**{f: jnp.asarray(v) for f, v in out.items()})


def test_path_mean_abs_jerk_matches_jax():
    rng = np.random.default_rng(0)
    seq = np.cumsum(rng.uniform(0, 3, (6, 9)), axis=1)
    length = np.array([9, 5, 2, 1, 0, 7])
    v0, a0 = rng.uniform(0, 20, 6), rng.uniform(-3, 3, 6)
    want = jax.vmap(lambda s, n, v, a: jcomb.path_mean_abs_jerk(
        s, n, v, a, 0.2))(jnp.asarray(seq), jnp.asarray(length),
                          jnp.asarray(v0), jnp.asarray(a0))
    got = tcomb.path_mean_abs_jerk(
        torch.as_tensor(seq), torch.as_tensor(length), torch.as_tensor(v0),
        torch.as_tensor(a0), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9,
                               rtol=0)
    assert got[3] == 0.0 and got[4] == 0.0 and got[0] > 0.0


ROLLOUTS = {"as_shipped": {},
            "test_state_mid_rollout": dict(ST_TEST_ROLLOUTS=2),
            "test_step_past_rollout": dict(ROLLOUT_LENGTH=3,
                                           ST_TEST_ROLLOUTS=7),
            "test_step_zero": dict(ST_TEST_ROLLOUTS=0),
            "one_step": dict(ROLLOUT_LENGTH=1, ST_TEST_ROLLOUTS=1)}


@pytest.mark.parametrize("case", ROLLOUTS)
def test_rl_rollout_matches_jax(case):
    cfg, tcfg = CFG.replace(**ROLLOUTS[case]), TCFG.replace(**ROLLOUTS[case])
    js = _states()
    jpolicy = jddpg.actor_jerk(_jax_params(), cfg)
    want = jax.jit(lambda s: jcomb._rl_rollout(jpolicy, s, jpolicy(s), cfg))(
        js)
    ts = jax_state_to_torch(js)
    tpolicy = _torch_policy()
    got = tcomb._rl_rollout(tpolicy, ts, tpolicy(ts), tcfg)
    s_hist, rollout_len, crash, sel_speed, test_state = got
    np.testing.assert_array_equal(rollout_len.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(crash.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(s_hist.numpy(), np.asarray(want[0]),
                               atol=1e-9, rtol=0)
    np.testing.assert_allclose(sel_speed.numpy(), np.asarray(want[3]),
                               atol=1e-9, rtol=0)
    for f in HighwayState._fields:
        a, b = getattr(test_state, f).numpy(), np.asarray(getattr(want[4], f))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
    r = max(cfg.ROLLOUT_LENGTH, 1)
    assert s_hist.shape == (10, r + 1)
    if case == "as_shipped":
        # the doomed scenario crashes and freezes, the one near STOP_X
        # freezes without a crash, the free road records every point
        assert bool(crash[7]) and int(rollout_len[7]) < r + 1
        assert not bool(crash[8]) and int(rollout_len[8]) < r + 1
        assert int(rollout_len[6]) == r + 1
        assert float(s_hist[7, -1]) == 0.0


def _const_policies(jerk):
    return (lambda s: jnp.full_like(s.ego_speed, jerk),
            lambda s: torch.full_like(s.ego_speed, jerk))


ALL_OFF = dict(CHECK_ROLLOUT_CRASH=False, LIMIT_DQN_SPEED=False,
               TEST_ROLLOUT_STATE=False, TEST_ST_STRICTLY_BETTER=False)
# name -> (settings, constant policy jerk or None for the trained actor)
GATES = {
    "as_shipped": ({}, None),
    "none": (ALL_OFF, None),
    "rollout_crash_alone": ({**ALL_OFF, "CHECK_ROLLOUT_CRASH": True}, 0.5),
    "speed_limit_alone": ({**ALL_OFF, "LIMIT_DQN_SPEED": True,
                           "DESIRED_SPEED": 12.05}, 0.5),
    "certificate_alone": ({**ALL_OFF, "TEST_ROLLOUT_STATE": True}, None),
    "strictly_better_alone": ({**ALL_OFF, "TEST_ST_STRICTLY_BETTER": True},
                              None),
    "strictly_better_full_grid": ({**ALL_OFF, "FUTURE_S": 150.0,
                                   "TEST_ST_STRICTLY_BETTER": True}, 0.0),
    "all_gates": ({"LIMIT_DQN_SPEED": True, "DESIRED_SPEED": 12.05,
                   "TEST_ST_STRICTLY_BETTER": True}, None),
}
# cases whose states must show both outcomes
BOTH_OUTCOMES = ("as_shipped", "rollout_crash_alone", "speed_limit_alone",
                 "certificate_alone", "strictly_better_full_grid",
                 "all_gates")


@pytest.mark.parametrize("case", GATES)
def test_combined_controller_matches_jax(case):
    settings, jerk = GATES[case]
    cfg, tcfg = CFG.replace(**settings), TCFG.replace(**settings)
    if jerk is None:
        jpolicy = jddpg.actor_jerk(_jax_params(), cfg)
        tpolicy = _torch_policy()
    else:
        jpolicy, tpolicy = _const_policies(jerk)
    js = _states()
    if case == "strictly_better_full_grid":
        # rows where gate d fires (2) and where it does not (6, 7)
        js = jax.tree.map(lambda x: x[jnp.asarray([2, 6, 7])], js)
    jcontrol, jinit, _ = jcomb.combined_controller(
        jpolicy, cfg, dtype=jnp.float64, use_pallas=False)
    tcontrol, tinit, _ = tcomb.combined_controller(
        tpolicy, tcfg, dtype=torch.float64)
    assert jinit is None and tinit is None
    want_speed, want_take = jcontrol(js)
    got_speed, got_take = tcontrol(jax_state_to_torch(js))
    assert got_take.dtype == torch.float32 and got_speed.dtype == torch.float64
    np.testing.assert_array_equal(got_take.numpy(), np.asarray(want_take))
    np.testing.assert_allclose(got_speed.numpy(), np.asarray(want_speed),
                               atol=1e-6, rtol=0)
    if case in BOTH_OUTCOMES:
        assert 0.0 < float(got_take.mean()) < 1.0, got_take
    if case == "none":
        assert float(got_take.sum()) == 0.0


def test_combined_hysteresis_carry_matches_jax():
    """REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED over two calls: the
    second call reads the first call's takeover flags, and on the full-length
    grid a free road stays with the RL from a fresh carry and with the ST
    from a sticky one (tests/test_agents.py:145-155)."""
    settings = {**ALL_OFF, "TEST_ST_STRICTLY_BETTER": True, "FUTURE_S": 150.0,
                "REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED": True}
    cfg, tcfg = CFG.replace(**settings), TCFG.replace(**settings)
    jpolicy, tpolicy = _const_policies(0.0)
    js = jax.tree.map(lambda x: x[5:9], _states())
    ts = jax_state_to_torch(js)
    jcontrol, jinit, _ = jcomb.combined_controller(
        jpolicy, cfg, dtype=jnp.float64, use_pallas=False)
    tcontrol, tinit, _ = tcomb.combined_controller(
        tpolicy, tcfg, dtype=torch.float64)
    jcarry, tcarry = jinit(4), tinit(4)
    assert tcarry.dtype == torch.bool and not tcarry.any()
    for carry in (None, None, np.ones(4, bool)):
        if carry is not None:
            jcarry, tcarry = jnp.asarray(carry), torch.as_tensor(carry)
        (jspeed, jtake), jcarry = jcontrol(js, jcarry)
        (tspeed, ttake), tcarry = tcontrol(ts, tcarry)
        np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))
        np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
        np.testing.assert_allclose(tspeed.numpy(), np.asarray(jspeed),
                                   atol=1e-6, rtol=0)
        if carry is None:
            assert not bool(tcarry[1]), "fresh: the RL keeps the free road"
    assert bool(tcarry[1]), "sticky: the ST keeps the free road"


def test_arbitrate_reports_the_gate_that_fired():
    settings = {"LIMIT_DQN_SPEED": True, "DESIRED_SPEED": 12.05,
                "TEST_ST_STRICTLY_BETTER": True}
    tcfg = TCFG.replace(**settings)
    ts = jax_state_to_torch(_states())
    d = tcomb.arbitrate(_torch_policy(), ts, tcfg, dtype=torch.float64)
    any_gate = d.crash_pred | d.over_speed | d.condemned | d.st_better
    assert torch.equal(d.take, any_gate)
    assert torch.equal(d.speed, torch.where(d.take, d.st_speed, d.rl_speed))
    assert bool(d.crash_pred[7]) and bool(d.over_speed.any())
    off = tcomb.arbitrate(_torch_policy(), ts, TCFG.replace(**ALL_OFF),
                          dtype=torch.float64)
    assert not bool((off.crash_pred | off.over_speed | off.condemned
                     | off.st_better).any())
    assert torch.equal(off.speed, off.rl_speed)


# ---------------------------------------------------------------------------
# the episode loop's flag bookkeeping and carry, and the task runner's
# custom statistics
# ---------------------------------------------------------------------------

def _flagging(cfg):
    """A stateful controller with known flags: hold 8 m/s, flag every other
    tick per scenario; the carry counts the ticks a scenario was asked."""
    def control(state, carry):
        flag = (carry % 2 == 0).to(torch.float32)
        return (torch.full_like(state.ego_speed, 8.0), flag), carry + 1
    return control


def test_episode_loop_sums_the_flag_and_threads_the_carry():
    cfg = TCFG.replace(OTHER_CAR_SPEED=15.0)
    world = tworld.init_world(cfg, 3, torch.float64, "cpu")
    carry0 = torch.zeros(3, dtype=torch.int64)
    world, stats, carry = tep.run_episode_batch(
        world, cfg, _flagging(cfg), CounterRandom(5), max_episode_length=6.0,
        wait_before_start=4.0, controller_carry=carry0)
    ticks = stats.ticks.to(torch.int64)
    assert int(ticks.min()) > 0
    # active scenarios are flagged on ticks 0, 2, 4, ...
    np.testing.assert_array_equal(stats.aux_sum.numpy(),
                                  ((ticks + 1) // 2).numpy())
    np.testing.assert_array_equal(stats.bin_aux.sum(dim=1).numpy(),
                                  stats.aux_sum.numpy())
    assert bool((stats.bin_aux <= stats.bin_counts).all())
    assert int(carry.min()) >= int(ticks.max())
    # a bare-tensor controller leaves both untouched and returns no carry
    out = tep.run_episode_batch(
        tworld.init_world(cfg, 3, torch.float64, "cpu"), cfg,
        lambda s: torch.full_like(s.ego_speed, 8.0), CounterRandom(5),
        max_episode_length=6.0, wait_before_start=4.0)
    assert len(out) == 2
    assert float(out[1].aux_sum.sum()) == 0.0
    assert float(out[1].bin_aux.sum()) == 0.0
    np.testing.assert_array_equal(out[1].ticks.numpy(), stats.ticks.numpy())


def test_evaluate_controller_aggregates_custom_stats_across_rounds():
    cfg = TCFG.replace(OTHER_CAR_SPEED=15.0, BATCH_SCENARIOS=2)
    seen = []

    def control(state, carry):
        seen.append(int(carry[0]))
        return (torch.full_like(state.ego_speed, 8.0),
                torch.ones_like(state.ego_speed)), carry + 1

    agg = ttasks.evaluate_controller(
        cfg, control, num_episodes=4, dtype=torch.float64, device="cpu",
        max_episode_length=3.0, wait_before_start=2.0, verbose=False,
        custom_stats=lambda s: {"percent st solver":
                                (s.aux_sum / s.ticks.clamp_min(1)).numpy()},
        controller_carry=torch.zeros(2, dtype=torch.int64))
    assert agg.custom["percent st solver"] == [1.0] * 4
    assert agg.get_stat_averages()["percent st solver"] == 1.0
    # the carry runs on through the second round
    assert seen == list(range(len(seen))) and len(seen) > 15
    assert float(agg.bin_aux.sum()) == len(seen) * 2


# ---------------------------------------------------------------------------
# one episode round, JAX draws replayed
# ---------------------------------------------------------------------------

ROUND = {"TEST_ST_STRICTLY_BETTER": True,
         "REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED": True}
EPISODE = dict(max_episode_length=30.0, wait_before_start=20.0)


def test_episode_round_matches_jax():
    """combined_default_1b with the hysteresis carry, 4 scenarios: crash,
    merge, tick and takeover counts equal to the JAX package's, the other
    statistics to 1e-6, the carry returned last."""
    cfg, tcfg = CFG.replace(**ROUND), TCFG.replace(**ROUND)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jw0 = jax.vmap(lambda k: jworld.init_world(k, cfg, jnp.float64))(keys)
    jcontrol, jinit, jstats_fn = jcomb.combined_controller(
        jddpg.actor_jerk(_jax_params(), cfg), cfg, dtype=jnp.float64,
        use_pallas=False)
    jw, jstats, jcarry = jep.run_episode_batch(
        jw0, cfg, jcontrol, controller_carry=jinit(4), **EPISODE)

    tcontrol, tinit, tstats_fn = tcomb.combined_controller(
        _torch_policy(), tcfg, dtype=torch.float64)
    tw, tstats, tcarry = tep.run_episode_batch(
        jax_world_to_torch(jw0), tcfg, tcontrol, JaxReplay(jw0.rng),
        controller_carry=tinit(4), **EPISODE)
    t = to_np(tstats)
    for f in ("crashed", "merged", "ticks", "aux_sum", "bin_aux"):
        np.testing.assert_array_equal(getattr(t, f),
                                      np.asarray(getattr(jstats, f)),
                                      err_msg=f)
    for f in jep.EpisodeStats._fields:
        np.testing.assert_allclose(getattr(t, f),
                                   np.asarray(getattr(jstats, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
    np.testing.assert_allclose(
        tstats_fn(tstats)["percent st solver"],
        jstats_fn(jax.tree.map(np.asarray, jstats))["percent st solver"],
        atol=1e-12, rtol=0)
    assert t.ticks.min() > 0
    assert 0.0 < t.aux_sum.sum() < t.ticks.sum(), "both controllers drove"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["EVALUATE_COMBINED_DDPG",
                                  "EVALUATE_COMBINED_DQN", "EVALUATE_DDPG"])
def test_cli_runs_the_actor_tasks_on_the_cpu(task, tmp_path, monkeypatch,
                                             capsys):
    """``do_task`` on a narrowed config, 2 scenarios, one round: the report
    carries ``percent st solver`` for the combined tasks, and the CSV row is
    written where asked."""
    monkeypatch.chdir(tmp_path)
    cfg = TCFG.replace(TASK=task, NUM_EPISODES=2, BATCH_SCENARIOS=2,
                       LOG_DIR="cli_" + task.lower())
    calls = {}
    real = ttasks.evaluate_controller

    def short(*a, **kw):
        calls.update(kw)
        return real(*a, **{**kw, "max_episode_length": 4.0,
                           "wait_before_start": 10.0})

    monkeypatch.setattr(ttasks, "evaluate_controller", short)
    tmain.do_task(cfg, device="cpu", csv_path=str(tmp_path / "rows.csv"))
    out = capsys.readouterr().out
    assert "crashed: " in out and "[2/2]" in out
    assert ("percent st solver: " in out) == task.startswith(
        "EVALUATE_COMBINED")
    assert (calls.get("custom_stats") is not None) == task.startswith(
        "EVALUATE_COMBINED")
    assert (tmp_path / "rows.csv").read_text().count("\n") == 2
    assert (tmp_path / "runs_torch" / cfg.LOG_DIR).is_dir()


def test_grid_search_combined_prunes_as_the_reference(monkeypatch):
    seen = []
    monkeypatch.setattr(tmain, "do_task",
                        lambda c, **kw: seen.append(
                            (c.ROLLOUT_LENGTH, c.ST_TEST_ROLLOUTS,
                             c.TEST_ROLLOUT_STATE, kw["device"])))
    tmain.main(["configs/combined_default_1.json", "--grid-search",
                "combined", "--device", "cpu"])
    assert len(seen) == 13 and (3, 2, False, "cpu") in seen
    assert all(t <= r for r, t, _, _ in seen)
    assert all(t == 2 for _, t, on, _ in seen if not on)
    seen.clear()
    tmain.main(["configs/st_default.json", "--grid-search", "st",
                "--device", "cpu"])
    assert len(seen) == 2 * 2 * 3 * 4 * 2 * 3
