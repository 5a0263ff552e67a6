"""The port's reward families, replay buffer, batched merge env and frame
budget against the JAX package, in float64 on the CPU: rewards to 1e-12,
the replay's ring and draws exactly (JAX's uniforms fed to the port), and
60 env ticks of every EnvKind with the JAX world's draws replayed (flags
exact, observations and rewards to 1e-9)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (JaxReplay, jax_state_to_torch, jax_world_to_torch,
                           random_states)
from rl_mpc_lanemerging_torch import convert
from rl_mpc_lanemerging_torch.agents import budget as tbudget
from rl_mpc_lanemerging_torch.envs import merge_env as tenv
from rl_mpc_lanemerging_torch.rl import replay as trb
from rl_mpc_lanemerging_torch.rl import rewards as trew
from rl_mpc_lanemerging_torch.sim import CounterRandom
from rl_mpc_lanemerging_tpu import geometry as jgeo
from rl_mpc_lanemerging_tpu.agents import budget as jbudget
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.envs import merge_env as jenv
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.rl import replay as jrb
from rl_mpc_lanemerging_tpu.rl import rewards as jrew
from rl_mpc_lanemerging_tpu.sim import world as jworld

SMALL = dict(MAX_CARS=16, MAX_SENSED_CARS=8)
TCFG = convert.settings_from_json("configs/train_default_1.json").replace(
    **SMALL)
CFG = Settings.load_from_file("configs/train_default_1.json").replace(**SMALL)
F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# --- rewards ---------------------------------------------------------------

@pytest.mark.parametrize("family", ["Slotted", "Slotted Jerk", "Continuous",
                                    "ST"])
def test_rewards_match_jax(family):
    k = 12                 # random_states places up to 11 cars
    cfg = CFG.replace(REWARD_FUNCTION=family, MAX_SENSED_CARS=k)
    tcfg = TCFG.replace(REWARD_FUNCTION=family, MAX_SENSED_CARS=k)
    rng = np.random.default_rng(3)
    d = random_states(rng, 64, cfg)
    # a few egos sit within MIN_FOLLOW_DISTANCE of a car, and some alone
    d["other_x"][:8, 0] = d["ego_x"][:8] + cfg.CAR_LENGTH + rng.uniform(
        0.2, 4.0, 8)
    d["other_present"][:8, 0] = True
    d["other_present"][8:12] = False
    d["other_x"][8:12] = -np.inf
    jerk = rng.uniform(-6, 6, 64)
    crashed = rng.uniform(size=64) < 0.15
    arrived = ~crashed & (rng.uniform(size=64) < 0.15)
    js = HighwayState(**{f: jnp.asarray(v) for f, v in d.items()})
    fn = jrew.get_reward_function(cfg)
    want = jax.jit(jax.vmap(lambda s, j, c, a: fn(s, j, c, a, cfg)))(
        js, jnp.asarray(jerk), jnp.asarray(crashed), jnp.asarray(arrived))
    got = trew.get_reward_function(tcfg)(
        jax_state_to_torch(js), torch.as_tensor(jerk),
        torch.as_tensor(crashed), torch.as_tensor(arrived), tcfg)
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12,
                               rtol=0)
    assert len(np.unique(np.asarray(want).round(9))) >= 3


def test_unknown_reward_family_raises():
    with pytest.raises(ValueError, match="Invalid reward function"):
        trew.get_reward_function(TCFG.replace(REWARD_FUNCTION="nope"))


# --- replay ----------------------------------------------------------------

def _batches(rng, n_batches, rows, dim, discrete):
    out = []
    for _ in range(n_batches):
        action = rng.integers(0, 5, rows) if discrete \
            else rng.uniform(-5, 5, rows)
        out.append(dict(obs=rng.normal(size=(rows, dim)),
                        next_obs=rng.normal(size=(rows, dim)),
                        action=action, reward=rng.normal(size=rows),
                        terminal=rng.uniform(size=rows) < 0.2,
                        valid=rng.uniform(size=rows) < 0.7,
                        discount=rng.uniform(0.9, 1.0, rows)))
    return out


def _filled(discrete, rng, n_batches=5):
    """The same transitions through both buffers: capacity 13 -> 16 rows,
    five batches of 7 rows wrap the ring."""
    j = jrb.init_replay(13, 3, discrete, dtype=jnp.float64)
    t = trb.init_replay(13, 3, discrete, dtype=F64)
    for b in _batches(rng, n_batches, 7, 3, discrete):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = {k: torch.as_tensor(v) for k, v in b.items()}
        j = jrb.add_batch(j, jb["obs"], jb["next_obs"], jb["action"],
                          jb["reward"], jb["terminal"], jb["valid"], 2.0,
                          discount=jb["discount"])
        t = trb.add_batch(t, tb["obs"], tb["next_obs"], tb["action"],
                          tb["reward"], tb["terminal"], tb["valid"], 2.0,
                          discount=tb["discount"])
    return j, t


@pytest.mark.parametrize("discrete", [False, True],
                         ids=["continuous", "discrete"])
def test_replay_add_batch_wraps_like_jax(discrete):
    j, t = _filled(discrete, np.random.default_rng(0))
    assert t.capacity == 16 and t.obs.shape == (17, 3)
    assert int(t.pos) == int(j.pos) and int(t.size) == int(j.size) == 16
    for f in ("obs", "next_obs", "action", "reward", "terminal", "discount",
              "priority"):
        np.testing.assert_array_equal(_np(getattr(t, f))[:16],
                                      np.asarray(getattr(j, f)), err_msg=f)


def test_replay_add_batch_counts_only_valid_rows():
    t = trb.init_replay(8, 2, False, dtype=F64)
    valid = torch.tensor([True, False, False, True, False])
    t = trb.add_batch(t, torch.ones(5, 2), torch.ones(5, 2), torch.zeros(5),
                      torch.arange(5.0), torch.zeros(5, dtype=torch.bool),
                      valid, 1.0)
    assert int(t.size) == 2 and int(t.pos) == 2
    np.testing.assert_array_equal(_np(t.reward)[:3], [0.0, 3.0, 0.0])
    np.testing.assert_array_equal(_np(t.priority)[:8],
                                  [1, 1, 0, 0, 0, 0, 0, 0])


def _with_priorities(rng):
    """Both buffers after a wrap, then the same priority update on indices
    that occur once."""
    j, t = _filled(True, rng)
    idx = rng.permutation(16)[:9]
    td = rng.normal(0, 2, 9)
    cfg = CFG
    j = jrb.update_priorities(j, jnp.asarray(idx), jnp.asarray(td), cfg)
    t = trb.update_priorities(t, torch.as_tensor(idx), torch.as_tensor(td),
                              TCFG)
    np.testing.assert_allclose(_np(t.priority)[:16], np.asarray(j.priority),
                               rtol=1e-12, atol=0)
    return j, t


def test_replay_sample_uses_jax_uniforms_for_identical_indices():
    j, t = _with_priorities(np.random.default_rng(1))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        u = jax.random.uniform(key, (64,), jnp.float64)
        j_idx, j_batch = jrb.sample(j, key, 64)
        t_idx, t_batch = trb.sample(t, 64, u=torch.tensor(np.asarray(u)))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        for f, v in j_batch.items():
            np.testing.assert_array_equal(_np(t_batch[f]), np.asarray(v),
                                          err_msg=f)
        assert t_idx.max() < 16


def test_replay_sample_with_weights_matches_jax():
    j, t = _with_priorities(np.random.default_rng(2))
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, (32,), jnp.float64)
    for beta in (0.4, 0.73):
        j_idx, _, j_w = jrb.sample_with_weights(j, key, 32, beta)
        t_idx, _, t_w = trb.sample_with_weights(
            t, 32, torch.tensor(beta, dtype=F64),
            u=torch.tensor(np.asarray(u)))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=0,
                                   atol=1e-12)
        assert t_w.max() == 1.0


def test_replay_sample_never_draws_the_scratch_row():
    """Invalid rows land in the scratch row; the draws stay in [:cap] and
    follow the priorities."""
    t = trb.init_replay(4, 1, True, dtype=F64)
    t = trb.add_batch(t, torch.zeros(6, 1), torch.zeros(6, 1),
                      torch.arange(6), torch.zeros(6, dtype=F64),
                      torch.zeros(6, dtype=torch.bool),
                      torch.tensor([True, True, False, False, False, False]),
                      1.0)
    g = torch.Generator().manual_seed(0)
    idx, batch = trb.sample(t, 4000, generator=g)
    assert set(idx.tolist()) == {0, 1}
    assert abs(float((idx == 0).double().mean()) - 0.5) < 0.05
    np.testing.assert_array_equal(np.unique(batch["action"].numpy()), [0, 1])


def test_replay_scratch_row_holds_no_invalid_row():
    """Whichever invalid row a scatter writes last (unspecified on a card),
    the buffers come out the same: the scratch row is cleared."""
    valid = torch.tensor([False, True, False, True, False])
    order = torch.tensor([4, 1, 2, 3, 0])      # the invalid rows reordered
    obs = torch.arange(10, dtype=F64).reshape(5, 2) + 1.0
    rows = (obs, obs + 100.0, torch.arange(5) + 1,
            torch.arange(5, dtype=F64) + 1.0, torch.ones(5, dtype=torch.bool))
    got = []
    for perm in (torch.arange(5), order):
        t = trb.init_replay(4, 2, True, dtype=F64)
        t = trb.add_batch(t, *(x[perm] for x in rows), valid[perm], 1.0,
                          torch.arange(5, dtype=F64)[perm] + 2.0)
        got.append(t)
    for name in ("obs", "next_obs", "action", "reward", "terminal",
                 "discount", "priority"):
        a, b = getattr(got[0], name), getattr(got[1], name)
        assert torch.equal(a, b), name
        assert not a[4].any(), name
    assert torch.equal(got[0].obs[:2], obs[[1, 3]])
    assert int(got[0].size) == 2 and int(got[0].pos) == 2


# --- env -------------------------------------------------------------------

WAIT, EPISODE = 2.0, 6.0         # 10 warmup ticks, 30-tick episodes


def _env_worlds():
    """Four JAX worlds with traffic after 120 ticks of warmup; scenario 0's
    ego is 25 m from its exit (it arrives), scenario 1's ego sits on a
    traffic car on the highway (it collides), 2 and 3 start in warmup."""
    cfg = CFG
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    w = jax.vmap(lambda k: jworld.init_world(k, cfg, jnp.float64))(keys)
    step = jax.jit(jax.vmap(lambda w, c: jworld.world_step(w, c, cfg)))
    for _ in range(120):
        w = step(w, w.ego_v)
    arc = np.array([jgeo.EGO_ARRIVAL_ARC - 25.0,
                    jgeo.EGO_JUNCTION_ARC + 45.0, 40.0, 40.0])
    ego_x = np.asarray(jgeo.route_xy(jnp.asarray(arc)))[:, 0]
    cars_x = np.asarray(w.cars_x).copy()
    active = np.asarray(w.cars_active).copy()
    cars_x[1, 0], active[1, 0] = ego_x[1] + 2.0, True
    cars_v = np.asarray(w.cars_v).copy()
    cars_v[1, 0] = 8.0
    w = w._replace(
        cars_x=jnp.asarray(cars_x), cars_active=jnp.asarray(active),
        cars_v=jnp.asarray(cars_v),
        ego_active=jnp.asarray([True, True, False, False]),
        ego_arc=jnp.asarray(arc), ego_v=jnp.asarray([15.0, 9.0, 0.0, 0.0]),
        ego_prev_v=jnp.asarray([15.0, 9.0, 0.0, 0.0]))
    return w


def _actions(kind, rng, ticks, batch):
    if kind == "jerk":
        return rng.integers(0, len(CFG.JERK_VALUES_DQN), (ticks, batch))
    if kind == "accel":
        return rng.integers(0, len(CFG.ACCELERATION_VALUES_DQN),
                            (ticks, batch))
    return rng.uniform(-6.0, 6.0, (ticks, batch))


@pytest.mark.parametrize("kind", ["jerk", "accel", "jerk-continuous"])
def test_env_step_matches_jax_for_60_ticks(kind):
    cfg = CFG.replace(INVALID_ACTION_PENALTY=-1.0,
                      REWARD_FUNCTION={"jerk": "Slotted Jerk", "accel": "ST",
                                       "jerk-continuous": "Continuous"}[kind])
    tcfg = TCFG.replace(INVALID_ACTION_PENALTY=-1.0,
                        REWARD_FUNCTION=cfg.REWARD_FUNCTION)
    jw = _env_worlds()
    replay = JaxReplay(jw.rng)
    je = jenv.env_reset(jw, cfg, wait_before_start=WAIT)
    je = je._replace(warmup_left=jnp.asarray([0, 0, 10, 3], jnp.int32))
    te = tenv.env_reset(jax_world_to_torch(jw), tcfg, wait_before_start=WAIT)
    te = te._replace(warmup_left=torch.tensor([0, 0, 10, 3],
                                              dtype=torch.int32))
    step = jax.jit(lambda e, a: jenv.env_step(
        e, a, cfg, jenv.EnvKind(kind), max_episode_length=EPISODE,
        wait_before_start=WAIT))
    actions = _actions(kind, np.random.default_rng(9), 60, 4)
    seen = {f: 0 for f in ("collided", "arrived", "done", "valid")}
    spawns = 0
    for t in range(60):
        je, jtr = step(je, jnp.asarray(actions[t]))
        te, ttr = tenv.env_step(te, torch.as_tensor(actions[t]), tcfg, replay,
                                tenv.EnvKind(kind),
                                max_episode_length=EPISODE,
                                wait_before_start=WAIT)
        for f in ("terminal", "done", "valid", "collided", "arrived"):
            np.testing.assert_array_equal(ttr[f].numpy(), np.asarray(jtr[f]),
                                          err_msg=f"{f} at tick {t}")
        for f in ("obs", "reward", "next_obs"):
            np.testing.assert_allclose(ttr[f].numpy(), np.asarray(jtr[f]),
                                       atol=1e-9, rtol=0,
                                       err_msg=f"{f} at tick {t}")
        for f in ("ticks", "warmup_left"):
            np.testing.assert_array_equal(getattr(te, f).numpy(),
                                          np.asarray(getattr(je, f)),
                                          err_msg=f"{f} at tick {t}")
        np.testing.assert_allclose(te.prev_accel.numpy(),
                                   np.asarray(je.prev_accel), atol=1e-9,
                                   rtol=0)
        np.testing.assert_array_equal(te.world.ego_active.numpy(),
                                      np.asarray(je.world.ego_active))
        np.testing.assert_allclose(te.world.ego_v.numpy(),
                                   np.asarray(je.world.ego_v), atol=1e-9,
                                   rtol=0)
        for f in seen:
            seen[f] += int(np.asarray(jtr[f]).sum())
        spawns += int(ttr["spawn_now"].sum())
    # every path of the episode bookkeeping ran: an arrival, a collision,
    # timeouts, warmup and spawns
    assert seen["arrived"] >= 1 and seen["collided"] >= 1
    assert seen["done"] > seen["arrived"] + seen["collided"]
    assert spawns >= 4 and 0 < seen["valid"] < 240


def test_env_step_reads_nothing_on_the_host(monkeypatch):
    """env_step runs without a host read: Tensor.item and Tensor.__bool__
    are never called."""
    tcfg = TCFG
    w = jax_world_to_torch(_env_worlds())
    env = tenv.env_reset(w, tcfg, wait_before_start=WAIT)

    def forbidden(*a, **k):
        raise AssertionError("host read inside env_step")

    monkeypatch.setattr(torch.Tensor, "item", forbidden)
    monkeypatch.setattr(torch.Tensor, "__bool__", forbidden)
    for _ in range(3):
        env, tr = tenv.env_step(env, torch.zeros(4, dtype=F64), tcfg,
                                CounterRandom(0),
                                max_episode_length=EPISODE,
                                wait_before_start=WAIT)
    assert tr["reward"].shape == (4,)


# --- budget ----------------------------------------------------------------

def test_budget_matches_jax(caplog):
    for args in [(8, 128, 200), (8, 4, 30), (1, 1, 1), (20, 512, 200, 100,
                                                         32)]:
        assert tbudget.grad_steps_per_round(*args) \
            == jbudget.grad_steps_per_round(*args)
    for args in [(0.0, 1.0, 0.0), (0.01, 0.95, 0.3, 25.0),
                 (0.0, 1.0, 0.25, float("nan")), (0.2, 0.7, 1.0, None)]:
        assert tbudget.snapshot_score(*args) == jbudget.snapshot_score(*args)
    for args in [(1e6, 25600), (100, 0), (5e4, 6400, 3)]:
        assert list(tbudget.frame_budget_rounds(*args)) \
            == list(jbudget.frame_budget_rounds(*args))
    with caplog.at_level(logging.WARNING):
        list(tbudget.frame_budget_rounds(10, 5, safety=1))
    assert "frame budget not reached" in caplog.text
