"""The tabular Q path and the Gym adapter of the port against the JAX
package on the CPU: ``discretize_state`` exact (absent cars and bucket
edges included), ``q_update_episode`` and the fold of B episodes within
1e-6 in float32, the greedy tabular controller, one collect round and
``scripts/train_tabular_torch.py``; the Gym IDs, their registration and
entry points, the three envs' API, and a Gym step equal to the batched
``env_step`` from the same state."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_state_to_torch, random_states
from rl_mpc_lanemerging_torch import tasks as ttasks
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.envs import gym_compat as tgym
from rl_mpc_lanemerging_torch.envs.merge_env import env_step
from rl_mpc_lanemerging_torch.rl import tabular as ttab
from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.envs import gym_compat as jgym
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.rl import tabular as jtab

CFG = Settings().replace(MAX_SENSED_CARS=12)
TCFG = TSettings().replace(MAX_SENSED_CARS=12)
SMALL = dict(MAX_CARS=16, MAX_SENSED_CARS=8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _edge_states():
    """States on the bucket edges: ego x at -66 / -51, speeds at the
    edges, cars exactly 5 / 10 / 20 / 50 m away with relative speeds at
    the edges, and egos with no car, only one behind, only one ahead."""
    k = CFG.MAX_SENSED_CARS
    rows = []
    for i, (x, v) in enumerate([(-66.0, 2.0), (-51.0, 5.0), (-66.1, 10.0),
                                (-50.9, 20.0), (0.0, 30.0), (-80.0, 0.0)]):
        for cars in ([], [x - 5.0], [x + 10.0], [x + 20.0, x - 50.0],
                     [x + 50.0, x - 10.0]):
            ox = np.full(k, -np.inf)
            ox[:len(cars)] = sorted(cars, reverse=True)
            ov = np.zeros(k)
            ov[:len(cars)] = [v - 15.0, v + 5.0][:len(cars)]
            pr = np.zeros(k, bool)
            pr[:len(cars)] = True
            rows.append((x, -1.5, v, 0.0, ox, ov, np.zeros(k), pr))
    return {f: np.asarray(c) for f, c in zip(HighwayState._fields,
                                             zip(*rows))}


@pytest.mark.parametrize("kind", ["random", "edges"])
def test_discretize_state_matches_jax(kind):
    d = random_states(np.random.default_rng(1), 256, CFG) \
        if kind == "random" else _edge_states()
    js = HighwayState(**{f: jnp.asarray(v) for f, v in d.items()})
    want = jax.jit(jax.vmap(jtab.discretize_state))(js)
    got = ttab.discretize_state(jax_state_to_torch(js))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"bucket {i}")
    # the buckets stay in the table, and absent cars take the farthest
    if kind == "edges":
        for i, n in enumerate((3, 6, 5, 5, 6, 6)):
            assert set(got[i].tolist()) <= set(range(n))
        assert 4 in got[2].tolist() and 4 in got[3].tolist()


def _episodes(rng, b, t_len):
    """Random episodes over a few states (so that updates meet), a valid
    prefix with holes, float32 rewards."""
    states6 = [rng.integers(0, 2, (b, t_len)) for _ in range(6)]
    actions = rng.integers(0, 5, (b, t_len))
    rewards = rng.normal(0, 2, (b, t_len)).astype(np.float32)
    valid = (np.arange(t_len)[None, :] < rng.integers(1, t_len, (b, 1))) \
        & (rng.uniform(size=(b, t_len)) < 0.9)
    return states6, actions, rewards, valid


@pytest.mark.parametrize("discount,step", [(1.0, 0.5), (0.9, 0.01)])
def test_q_update_and_fold_match_jax(discount, step):
    """One episode, then a fold of 6 in order, float32: Q and visits within
    1e-6 of JAX's scan."""
    rng = np.random.default_rng(3)
    states6, actions, rewards, valid = _episodes(rng, 6, 40)
    q0 = rng.normal(0, 1, (3, 6, 5, 5, 6, 6, 5)).astype(np.float32)

    def jax_fold(q, visits, n):
        for b in range(n):
            q, visits = jtab.q_update_episode(
                q, visits, tuple(jnp.asarray(s[b]) for s in states6),
                jnp.asarray(actions[b]), jnp.asarray(rewards[b]),
                jnp.asarray(valid[b]), discount, step)
        return q, visits

    zeros = jnp.zeros(q0.shape, jnp.float32)
    for n in (1, 6):
        want_q, want_v = jax_fold(jnp.asarray(q0), zeros, n)
        q, visits = torch.as_tensor(q0.copy()), torch.zeros(q0.shape)
        if n == 1:
            ttab.q_update_episode(
                q, visits, tuple(torch.as_tensor(s[0]) for s in states6),
                torch.as_tensor(actions[0]), torch.as_tensor(rewards[0]),
                torch.as_tensor(valid[0]), discount, step)
        else:
            ttab.fold_episodes(
                q, visits, [torch.as_tensor(s) for s in states6],
                torch.as_tensor(actions), torch.as_tensor(rewards),
                torch.as_tensor(valid), discount, step)
        np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-6,
                                   rtol=0)
        np.testing.assert_array_equal(visits.numpy(), np.asarray(want_v))
        assert float(visits.sum()) == valid[:n].sum()


@pytest.mark.parametrize("avoid", [True, False])
def test_greedy_tabular_controller_matches_jax(avoid):
    cfg, tcfg = (c.replace(AVOID_UNVISITED_STATES=avoid) for c in (CFG, TCFG))
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (3, 6, 5, 5, 6, 6, 5)).astype(np.float32)
    visits = (rng.uniform(size=q.shape) < 0.5).astype(np.float32)
    d = random_states(np.random.default_rng(2), 64, cfg)
    js = HighwayState(**{f: jnp.asarray(v, jnp.float32 if v.dtype != bool
                                        else bool) for f, v in d.items()})
    want = jax.jit(jtab.greedy_tabular_controller(
        jnp.asarray(q), jnp.asarray(visits), cfg))(js)
    got = ttab.greedy_tabular_controller(torch.as_tensor(q),
                                         torch.as_tensor(visits), tcfg)(
        jax_state_to_torch(js))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_collect_round_keeps_first_episodes_and_folds():
    """B=4 scenarios, 3 s episodes after 1 s of warmup, 60 ticks: valid
    steps only inside each scenario's first episode, the fold visits each
    valid step once."""
    cfg = TCFG.replace(MAX_EPISODE_LENGTH=3.0, REWARD_FUNCTION="Slotted",
                       **SMALL)
    worlds = init_world(cfg, 4, torch.float32, "cpu")
    rec = ttab.collect_random_round(cfg, worlds, CounterRandom(2), 60,
                                    torch.Generator().manual_seed(0),
                                    wait_before_start=1.0)
    assert rec.actions.shape == rec.valid.shape == (4, 60)
    assert all(s.shape == (4, 60) for s in rec.states6)
    for row in rec.valid.tolist():
        first = row.index(True)
        last = len(row) - 1 - row[::-1].index(True)
        assert all(row[first:last + 1]) and 0 < last - first + 1 <= 15
    q, visits = ttab.initialize_q(cfg), ttab.initialize_q(cfg)
    ttab.fold_episodes(q, visits, rec.states6, rec.actions, rec.rewards,
                       rec.valid, cfg.GAMMA, cfg.STEP_SIZE)
    assert float(visits.sum()) == int(rec.valid.sum())
    assert bool((q != 0).any())


def test_train_tabular_script(tmp_path, monkeypatch, capsys):
    """One round of 4 episodes on the CPU (602 ticks at full width; short
    evaluation episodes): q.npy and visits.npy under runs_torch/<log dir>,
    the evaluation's row in the CSV."""
    monkeypatch.chdir(tmp_path)
    real = ttasks.evaluate_controller
    monkeypatch.setattr(ttasks, "evaluate_controller", lambda *a, **kw: real(
        a[0].replace(**SMALL), *a[1:],
        **{**kw, "max_episode_length": 6.0, "wait_before_start": 10.0}))
    monkeypatch.setattr(sys, "argv", [
        "train_tabular_torch.py", "--episodes", "4", "--batch", "4",
        "--eval-episodes", "4", "--log-dir", "tab", "--device", "cpu",
        "--csv", "rows.csv"])
    runpy.run_path(os.path.join(REPO, "scripts/train_tabular_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "round 1/1 episodes=4" in out and "crashed: " in out
    q = np.load("runs_torch/tab/q.npy")
    visits = np.load("runs_torch/tab/visits.npy")
    assert q.shape == visits.shape == (3, 6, 5, 5, 6, 6, 5)
    assert 0 < visits.sum() and (q != 0).any()
    assert (tmp_path / "rows.csv").read_text().count("\n") == 2


# --- Gym ---------------------------------------------------------------------

def test_env_ids_cover_reference():
    assert set(tgym.ENV_IDS) == set(jgym.ENV_IDS) == {
        "sumo-jerk-v0", "sumo-accel-v0", "sumo-jerk-continuous-v0"}


def test_registration_names_the_port_whatever_registered_first():
    """The JAX package and the port register the same three IDs; after the
    port's registration each names the port's class, whichever order the
    two ran in, and gymnasium.make builds it."""
    gymnasium = pytest.importorskip("gymnasium")
    for first in (jgym.register_environments, tgym.register_environments,
                  jgym.register_environments):
        first()
        assert tgym.register_environments() is True
        for env_id, kind in tgym.ENV_IDS.items():
            entry = gymnasium.spec(env_id).entry_point
            assert entry.startswith("rl_mpc_lanemerging_torch.envs."
                                    "gym_compat:"), entry
    env = gymnasium.make("sumo-jerk-continuous-v0", config={
        "settings": TCFG.replace(**SMALL), "wait_before_start": 1.0,
        "seed": 2, "device": "cpu"})
    obs, _ = env.reset()
    assert isinstance(env.unwrapped, tgym.ContinuousJerkEnv)
    assert obs.shape == (TCFG.obs_dim,)
    _, reward, _, _, _ = env.step(np.asarray([1.0], np.float32))
    assert np.isfinite(reward)
    env.close()


def test_registration_without_gym_packages(monkeypatch):
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    monkeypatch.setitem(sys.modules, "gym", None)
    assert tgym.register_environments() is False
    box, discrete = tgym._spaces()
    space = discrete(5)
    assert space.n == 5 and space.contains(4) and not space.contains(5)
    b = box(-1.0, 1.0, shape=(2,))
    assert b.shape == (2,) and b.contains(np.zeros(2))


@pytest.mark.parametrize("cls", [tgym.JerkEnv, tgym.AccelerationEnv,
                                 tgym.ContinuousJerkEnv])
def test_gym_step_is_the_batched_env_step(cls):
    """From the env's own state, a Gym step returns the batched
    ``env_step``'s next observation, reward and flags; spaces as in JAX;
    the device defaults to cuda."""
    cfg = TCFG.replace(**SMALL)
    env = cls({"settings": cfg, "wait_before_start": 2.0, "seed": 4,
               "device": "cpu", "max_episode_length": 30.0})
    jenv = getattr(jgym, cls.__name__)({"settings": CFG.replace(**SMALL)})
    assert type(env.action_space) is type(jenv.action_space)
    assert env.observation_space.shape == jenv.observation_space.shape
    obs, info = env.reset()
    assert obs.shape == (cfg.obs_dim,) and info == {}
    rng = np.random.default_rng(0)
    for _ in range(20):
        action = env.action_space.sample() if cls is not tgym.JerkEnv \
            else int(rng.integers(0, 5))
        before = env._env
        obs, reward, term, trunc, info = env.step(action)
        _, tr = env_step(before, env._encode_action(action), cfg, env._rng,
                         env.kind, max_episode_length=30.0,
                         wait_before_start=2.0)
        np.testing.assert_array_equal(obs, tr["next_obs"][0].numpy())
        assert reward == float(tr["reward"][0])
        assert (term, trunc) == (bool(tr["terminal"][0]),
                                 bool(tr["done"][0] & ~tr["terminal"][0]))
        assert info == {"crashed": bool(tr["collided"][0]),
                        "merged": bool(tr["arrived"][0])}
        if term or trunc:
            break
    if torch.cuda.is_available():
        assert cls({"settings": cfg}).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            cls({"settings": cfg})


def test_continuous_env_runs_to_its_end_and_reseeds():
    env = tgym.ContinuousJerkEnv({"settings": TCFG.replace(**SMALL),
                                  "wait_before_start": 2.0, "device": "cpu",
                                  "max_episode_length": 30.0, "seed": 3})
    first, _ = env.reset()
    steps, terminated, truncated = 0, False, False
    while not (terminated or truncated) and steps < 200:
        obs, reward, terminated, truncated, info = env.step(
            np.asarray([1.0], np.float32))
        steps += 1
        assert obs.shape == (env.cfg.obs_dim,) and isinstance(reward, float)
    assert terminated or truncated
    assert {"crashed", "merged"} <= set(info)
    with pytest.raises(RuntimeError):
        env.step(np.asarray([0.0], np.float32))
    second, _ = env.reset()
    assert not np.allclose(first, second)
