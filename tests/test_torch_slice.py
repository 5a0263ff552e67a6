"""The port's ST slice as a whole against the JAX package, in float64 on the
CPU: the world step and the sensor per step (with the JAX draws replayed),
the spawner's batch-size invariance, one controller tick at full st_default
width, and a short episode round."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxReplay, jax_state_to_torch, jax_world_to_torch,
                           random_states, to_np)
from rl_mpc_lanemerging_torch import convert, main as tmain
from rl_mpc_lanemerging_torch._device import resolve_device
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.planner import mpc as tmpc
from rl_mpc_lanemerging_torch.sim import CounterRandom, episode as tep
from rl_mpc_lanemerging_torch.sim import world as tworld
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.planner import mpc as jmpc
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.sim import episode as jep
from rl_mpc_lanemerging_tpu.sim import world as jworld

CFG = Settings.load_from_file("configs/st_default.json")
TCFG = convert.settings_from_json("configs/st_default.json")
ALT = dict(USE_ALTERNATE_TRAFFIC_DISTRIBUTION=True, TRAFFIC_DENSITY="medium")
ATOL = 1e-9


def _jax_worlds(cfg, batch, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    return jax.vmap(lambda k: jworld.init_world(k, cfg, jnp.float64))(keys)


def _assert_tree_close(got, ref, skip=()):
    for f in ref._fields:
        if f in skip:
            continue
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("alternate", [False, True])
def test_world_step_and_sense_match_per_step(alternate):
    cfg = CFG.replace(**ALT) if alternate else CFG
    tcfg = TCFG.replace(**ALT) if alternate else TCFG
    jw = _jax_worlds(cfg, 4, seed=1)
    replay = JaxReplay(jw.rng)
    tw = jax_world_to_torch(jw)
    j_step = jax.jit(jax.vmap(lambda w, c: jworld.world_step(w, c, cfg)))
    j_sense = jax.jit(jep.sense_batch, static_argnums=1)
    rng = np.random.default_rng(7)
    for i in range(160):
        if i == 100:    # insert the ego, then drive it with random commands
            v = rng.uniform(5, 25, 4)
            jw = jax.vmap(jworld.add_ego)(jw, jnp.asarray(v))
            tw = tworld.add_ego(tw, torch.as_tensor(v))
        cmd = rng.uniform(0, 30, 4) if i >= 100 else np.array(jw.ego_v)
        jw = j_step(jw, jnp.asarray(cmd))
        tw = tworld.world_step(tw, torch.as_tensor(cmd), tcfg, replay)
        _assert_tree_close(to_np(tw), jw, skip=("rng", "steps"))
        _assert_tree_close(to_np(tworld.sense(tw, tcfg)), j_sense(jw, cfg))
    assert np.asarray(jw.cars_active).sum() > 4


def test_spawner_is_batch_size_invariant():
    """Scenario i's draws depend on (seed, i, its own step) only, so a
    prefix of a batch evolves exactly as the whole batch's first rows
    (tests/test_sim.py:127)."""
    cfg = TCFG.replace(OTHER_CAR_SPEED=15.0, BASE_TRAFFIC_INTERVAL=1.2)
    big = tep.warmup(tworld.init_world(cfg, 16, torch.float64, "cpu"), cfg,
                     300, CounterRandom(3))
    small = tep.warmup(tworld.init_world(cfg, 4, torch.float64, "cpu"), cfg,
                       300, CounterRandom(3))
    for f in tworld.WorldState._fields:
        np.testing.assert_array_equal(getattr(small, f).numpy(),
                                      getattr(big, f)[:4].numpy(),
                                      err_msg=f)
    assert small.cars_active.sum() > 4 * 10


def test_counter_random_draws_are_well_formed():
    src = CounterRandom(11)
    steps = torch.arange(20000, dtype=torch.int64) % 977
    d = src.step_draws(steps, torch.float64)
    for u in (d.vary, d.depart):
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.02
    assert abs(float(d.speed_factor.mean())) < 0.03
    assert abs(float(d.speed_factor.std()) - 1.0) < 0.03
    freq = np.bincount(d.type_idx.numpy(), minlength=6) / 20000
    np.testing.assert_allclose(freq, jworld.IDM_TYPE_PROBS, atol=0.02)
    z = src.start_normal(steps, torch.float64)
    assert abs(float(z.mean())) < 0.03


def _jax_state(d):
    return HighwayState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_one_control_tick_full_width():
    """batched_st_control at st_default width (18 x 3001, 300 ADMM
    iterations), dense path: the speed command within 1e-6 of JAX's."""
    d = random_states(np.random.default_rng(5), 2, CFG)
    js = _jax_state(d)
    ref = jax.jit(lambda s: jmpc.batched_st_control(s, CFG, jnp.float64)[0])(
        js)
    speed, seq, valid, fine, fine_len, grids = tmpc.batched_st_control(
        jax_state_to_torch(js), TCFG, torch.float64)
    np.testing.assert_allclose(speed.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    assert seq.shape == (2, 18) and fine.shape == (2, 26)
    assert grids.obstacles.shape == (2, 18, 3001)


def test_controller_takes_dense_path_on_cpu():
    d = random_states(np.random.default_rng(6), 2, CFG)
    cfg = TCFG.replace(FUTURE_S=15.0)
    ts = jax_state_to_torch(_jax_state(d))
    ts = type(ts)(*(x.float() if x.is_floating_point() else x for x in ts))
    got = tmpc.make_batched_controller(cfg)(ts)
    want = tmpc.batched_st_control(ts, cfg, use_kernel=False)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


NARROW = CFG.replace(FUTURE_S=15.0)
TNARROW = TCFG.replace(FUTURE_S=15.0)
EPISODE = dict(max_episode_length=30.0, wait_before_start=20.0)


@functools.lru_cache(maxsize=None)
def _jax_episode():
    control = jax.jit(
        lambda s: jmpc.batched_st_control(s, NARROW, jnp.float64)[0])
    jw = _jax_worlds(NARROW, 4, seed=2)
    return jw, jep.run_episode_batch(jw, NARROW, control, **EPISODE)


def test_episode_round_matches_jax():
    jw0, (jw, jstats) = _jax_episode()
    replay = JaxReplay(jw0.rng)
    control = lambda s: tmpc.batched_st_control(  # noqa: E731
        s, TNARROW, torch.float64)[0]
    tw, tstats = tep.run_episode_batch(jax_world_to_torch(jw0), TNARROW,
                                       control, replay, **EPISODE)
    t, j = to_np(tstats), jstats
    for f in ("crashed", "merged", "ticks", "n_closest", "n_disruption",
              "n_disruption_nonzero"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f)
    for f in jep.EpisodeStats._fields:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f)
    _assert_tree_close(to_np(tw), jw, skip=("rng", "steps"))
    assert t.ticks.min() > 0


def test_cli_runs_only_the_st_task(tmp_path, monkeypatch):
    """Every TASK of the CLI dispatches, on the card unless asked otherwise:
    the runners are stubbed here (the ST task runs in
    ``test_cli_runs_the_st_task_on_the_cpu``, the actor and arbiter tasks in
    tests/test_torch_combined.py, the training tasks and EVALUATE_DQN in
    tests/test_torch_train.py).  An unknown TASK raises."""
    from rl_mpc_lanemerging_torch import tasks as ttasks
    from rl_mpc_lanemerging_torch.agents import ddpg as tddpg
    from rl_mpc_lanemerging_torch.agents import rainbow as trainbow
    monkeypatch.chdir(tmp_path)
    seen = []

    class Agg:
        def add_csv_data(self, path):
            seen.append(("csv", path))

    def stub(name):
        def run(cfg, **kw):
            seen.append((name, kw))
            return (None, Agg()) if name.endswith("train") else Agg()
        return run

    for mod, name in ((ttasks, "evaluate_st"), (tddpg, "train"),
                      (tddpg, "evaluate"), (tddpg, "evaluate_combined"),
                      (trainbow, "train"), (trainbow, "evaluate")):
        monkeypatch.setattr(mod, name, stub(f"{mod.__name__}.{name}"))
    want = {
        "ST": ("tasks.evaluate_st", {}),
        "TRAIN_DDPG": ("ddpg.train", dict(resume=False, num_frames=5.0)),
        "RESUME_DDPG": ("ddpg.train", dict(resume=True, num_frames=5.0)),
        "TRAIN_DQN": ("rainbow.train", dict(resume=False, num_frames=5.0)),
        "RESUME_DQN": ("rainbow.train", dict(resume=True, num_frames=5.0)),
        "EVALUATE_DQN": ("rainbow.evaluate", {}),
        "EVALUATE_DDPG": ("ddpg.evaluate", {}),
        "EVALUATE_COMBINED_DQN": ("ddpg.evaluate_combined", {}),
        "EVALUATE_COMBINED_DDPG": ("ddpg.evaluate_combined", {}),
    }
    for task, (name, extra) in want.items():
        seen.clear()
        tmain.do_task(TCFG.replace(TASK=task), num_frames=5.0,
                      csv_path="rows.csv")
        (got, kw), csv = seen
        assert got.endswith(name) and kw == dict(device="cuda", **extra), \
            (task, got, kw)
        assert csv == ("csv", "rows.csv")
    with pytest.raises(ValueError, match="Unknown TASK"):
        tmain.do_task(TCFG.replace(TASK="NOPE"), device="cpu")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
