"""Crash capture, dumps and replay of the port against the JAX package on
the CPU, at the JAX forensics tests' own narrow settings: the recorded
history (rows equal the states sensed each tick, and equal JAX's to 1e-9 in
float64 with the JAX draws replayed), stats unchanged by the recording, the
dump / extract / load round trip under JAX's file names, the ST task's
dumps, ``replay_crash``'s doomed flags equal to JAX's on the same states,
and the rollout plots."""

import functools
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import JaxReplay, jax_world_to_torch, random_states, to_np
from rl_mpc_lanemerging_torch import forensics as tforensics
from rl_mpc_lanemerging_torch import tasks as ttasks
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.planner import mpc as tmpc
from rl_mpc_lanemerging_torch.prediction import HighwayState as THighway
from rl_mpc_lanemerging_torch.sim import CounterRandom
from rl_mpc_lanemerging_torch.sim import episode as tep
from rl_mpc_lanemerging_torch.sim import world as tworld
from rl_mpc_lanemerging_tpu import forensics as jforensics
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.prediction import HighwayState as JHighway
from rl_mpc_lanemerging_tpu.sim import episode as jep
from rl_mpc_lanemerging_tpu.sim import world as jworld

NARROW = dict(FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=16, MAX_SENSED_CARS=8,
              QP_ITERATIONS=5, BATCH_SCENARIOS=8, SEED=3,
              BASE_TRAFFIC_INTERVAL=1.2, OTHER_CAR_SPEED=7.0)
CFG = Settings().replace(**NARROW)
TCFG = TSettings().replace(**NARROW)
EPISODE = dict(max_episode_length=40.0, wait_before_start=30.0)


def _ram(states):
    """Floor it: collisions in dense traffic (the JAX test's controller)."""
    return torch.full_like(states.ego_speed, 30.0)


def _jax_ram(states):
    return jnp.full_like(states.ego_speed, 30.0)


def _port_round(record_history, dtype=torch.float32, seed=3, batch=8,
                controller=_ram):
    world = tworld.init_world(TCFG, batch, dtype, "cpu")
    return tep.run_episode_batch(world, TCFG, controller, CounterRandom(seed),
                                 record_history=record_history, **EPISODE)


@functools.lru_cache(maxsize=None)
def _jax_round_f64():
    keys = jax.random.split(jax.random.PRNGKey(CFG.SEED), 4)
    worlds = jax.vmap(lambda k: jworld.init_world(k, CFG, jnp.float64))(keys)
    return worlds, jep.run_episode_batch(worlds, CFG, _jax_ram,
                                         record_history=True, **EPISODE)


def test_history_rows_are_the_sensed_states():
    """Row t of scenario b is the state its controller saw at tick t, for
    every tick it ran; the round crashes and the stats are those of a round
    without the recording."""
    seen = []

    def recording(states):
        seen.append(states)
        return _ram(states)

    _, stats, history = _port_round(True, controller=recording)
    assert history.ego_x.shape == (8, int(40.0 / TCFG.TICK_LENGTH) + 1)
    assert bool(stats.crashed.any())
    for b in range(8):
        for t in range(int(stats.ticks[b])):
            for h, s in zip(history, seen[t]):
                assert torch.equal(h[b, t], s[b]), (b, t)
    _, plain = _port_round(False)
    for f in tep.EpisodeStats._fields:
        assert torch.equal(getattr(stats, f), getattr(plain, f)), f


def test_history_matches_jax_with_the_jax_draws():
    """Float64, the JAX world's draws replayed: identical crash flags and
    tick counts, and every recorded row within 1e-9 of JAX's."""
    jw0, (_, jstats, jhist) = _jax_round_f64()
    _, stats, history = tep.run_episode_batch(
        jax_world_to_torch(jw0), TCFG, _ram, JaxReplay(jw0.rng),
        record_history=True, **EPISODE)
    np.testing.assert_array_equal(stats.crashed.numpy(),
                                  np.asarray(jstats.crashed))
    np.testing.assert_array_equal(stats.ticks.numpy(),
                                  np.asarray(jstats.ticks))
    assert bool(stats.crashed.any())
    ticks = stats.ticks.numpy()
    for f in THighway._fields:
        got, want = to_np(getattr(history, f)), np.asarray(getattr(jhist, f))
        for b, n in enumerate(ticks):
            if got.dtype == bool:
                np.testing.assert_array_equal(got[b, :n], want[b, :n],
                                              err_msg=f)
            else:
                np.testing.assert_allclose(got[b, :n], want[b, :n],
                                           atol=1e-9, rtol=0, err_msg=f)


def test_dump_extract_load_round_trip(tmp_path):
    _, stats, history = _port_round(True)
    crashed = stats.crashed.numpy()
    histories = tforensics.extract_crash_histories(stats, history)
    assert len(histories) == int(crashed.sum()) > 0
    rows = np.flatnonzero(crashed)
    for states, b in zip(histories, rows):
        assert len(states) == int(stats.ticks[b])
        assert all(isinstance(s, THighway) for s in states)
        for t, s in enumerate(states):
            for leaf, h in zip(s, history):
                np.testing.assert_array_equal(leaf, h[b, t].numpy())
        xs = np.asarray([float(s.ego_x) for s in states])
        assert np.all(np.isfinite(xs)) and xs[-1] >= xs[0]
    paths = tforensics.dump_crashes(stats, history, run_dir=str(tmp_path),
                                    tag="r2_")
    assert [os.path.basename(p) for p in paths] == [
        f"crashed_state_history_r2_{i}.pkl" for i in range(len(histories))]
    for path, states in zip(paths, histories):
        loaded = tforensics.load_crash(path)
        assert len(loaded) == len(states)
        for a, b in zip(loaded, states):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_evaluate_controller_dumps_each_round(tmp_path):
    """Two rounds with the history on: one dump per crash under
    ``crashed_state_history_r<round>_<i>.pkl``, and the same aggregated
    stats as the same rounds without it."""
    kw = dict(num_episodes=8, batch=4, verbose=False, device="cpu",
              **EPISODE)
    agg = ttasks.evaluate_controller(TCFG, _ram, save_state_on_crash=True,
                                     run_dir=str(tmp_path), **kw)
    plain = ttasks.evaluate_controller(TCFG, _ram, **kw)
    for col in ("crashed", "merged", "time_taken", "mean_abs_jerk"):
        np.testing.assert_array_equal(agg.columns[col], plain.columns[col],
                                      err_msg=col)
    crashed = np.asarray(agg.columns["crashed"], bool)
    assert crashed.any()
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(str(tmp_path), "crashed_state_history_*.pkl")))
    want = sorted(f"crashed_state_history_r{r}_{i}.pkl" for r in range(2)
                  for i in range(int(crashed[4 * r:4 * r + 4].sum())))
    assert names == want


def test_st_task_dumps_its_crashes(tmp_path, monkeypatch):
    """TASK=ST records the history and dumps crashes to
    ``runs_torch/<LOG_DIR>`` (the ram controller stands in for the
    planner)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmpc, "make_batched_controller", lambda cfg: _ram)
    real = ttasks.evaluate_controller
    monkeypatch.setattr(ttasks, "evaluate_controller",
                        lambda *a, **kw: real(*a, **{**kw, **EPISODE}))
    cfg = TCFG.replace(LOG_DIR="st_dumps", BATCH_SCENARIOS=4)
    agg = ttasks.evaluate_st(cfg, num_episodes=4, device="cpu",
                             verbose=False)
    n = int(np.sum(agg.columns["crashed"]))
    dumps = glob.glob("runs_torch/st_dumps/crashed_state_history_r0_*.pkl")
    assert n > 0 and len(dumps) == n


def test_replay_crash_flags_match_jax(tmp_path, monkeypatch):
    """The same states on both sides: the last 2 of the shortest crash of
    the float64 JAX round and 4 sensed states of mixed traffic, in one
    dump.  Identical doomed flags (some of each), and one plot per state
    from the port (JAX's plots are passed over)."""
    _, (_, stats, history) = _jax_round_f64()
    crashes = jforensics.extract_crash_histories(stats, history)
    d = random_states(np.random.default_rng(10), 4,
                      CFG.replace(MAX_SENSED_CARS=12))
    k = CFG.MAX_SENSED_CARS
    mixed = [JHighway(*(np.asarray(d[f][i])[..., :k] if f.startswith("other")
                        else np.asarray(d[f][i]) for f in JHighway._fields))
             for i in range(4)]
    states = min(crashes, key=len)[-2:] + mixed
    jpath, tpath = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    for path, cls in ((jpath, JHighway), (tpath, THighway)):
        with open(path, "wb") as fh:
            pickle.dump([cls(*s) for s in states], fh)
    monkeypatch.setattr(jforensics, "plot_crash", lambda *a, **kw: [])
    want, _ = jforensics.replay_crash(str(jpath), CFG)
    doomed, plots = tforensics.replay_crash(str(tpath), TCFG,
                                           device="cpu")
    assert doomed == [bool(x) for x in want]
    assert 0 < sum(doomed) < len(doomed)
    assert len(plots) == len(states) == len(glob.glob(str(tmp_path
                                                          / "crash_*.png")))


def test_rollout_plots_and_their_plans(tmp_path):
    """JAX's file names; the plans are ``plan_st``'s of each history
    state."""
    cfg = TCFG.replace(ROLLOUT_LENGTH=2)

    def policy(states):
        return torch.full_like(states.ego_speed, 1.0)

    written = tforensics.plot_rollouts(policy, cfg, str(tmp_path),
                                       num_states=2, warm_ticks=5,
                                       device="cpu")
    names = [os.path.basename(p) for p in written]
    assert names == [n for j in range(2) for n in
                     [f"rollout_{j}.png", f"st_{j}.png"]
                     + [f"rollout_st_{j}_{i}.png" for i in (1, 2)]]
    history, crashed, plans = tforensics.rollout_plans(policy, cfg, 2, 5,
                                                       device="cpu")
    assert len(history) == len(plans) == 3 and crashed.shape == (4,)
    for h, plan in zip(history, plans):
        for j in range(2):
            one = tmpc.plan_st(THighway(*(x[j] for x in h)), cfg)
            assert torch.equal(plan.seq[j], one.s_sequence)
            assert int(plan.valid[j]) == int(one.valid_len)


def test_plots_pass_over_a_missing_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setattr(tforensics, "_pyplot", lambda: None)
    _, stats, history = _port_round(True)
    states = tforensics.extract_crash_histories(stats, history)[0]
    assert tforensics.plot_crash(states, TCFG, str(tmp_path),
                                 device="cpu") == []
    assert tforensics.plot_rollouts(lambda s: s.ego_speed * 0, TCFG,
                                    str(tmp_path), device="cpu") == []
    assert os.listdir(tmp_path) == []
