"""The port's observation vector, DDPG networks and converted actors
against the JAX package, on the CPU: ``state_vector`` on numpy-seeded states
(presence flags exact, floats to 1e-6 in f32 and 1e-12 in f64), the networks
against Flax ``apply`` on the same numpy trees (1e-5 in f32), and every
committed ``.npz`` against the orbax checkpoint it was converted from."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_states
from rl_mpc_lanemerging_torch import checkpoint as tcheckpoint
from rl_mpc_lanemerging_torch import convert
from rl_mpc_lanemerging_torch.agents import ddpg as tddpg
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.models.ddpg import DDPGActor, DDPGCritic
from rl_mpc_lanemerging_torch.rl import obs as tobs
from rl_mpc_lanemerging_tpu.agents import ddpg as jddpg
from rl_mpc_lanemerging_tpu.checkpoint import load_params
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.models import ddpg as jmodels
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.rl import obs as jobs

CFG = Settings()
TCFG = TSettings()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTORS = ("default", "fast", "low", "medium", "moderate")
# the second and third seed of each family; ddpg_medium2_extended's params
# were restored from a surviving artifact (ADVICE.md:3)
LATER_RUNS = tuple(f"runs/ddpg_{name}{seed}_extended" for name in ACTORS
                   for seed in (2, 3))


def _states(seed, batch=24):
    """Sensed states with the cases the slot order has to settle: cars that
    share an x (ahead and behind), a car at the ego's own x, scenarios with
    no car and with one car only."""
    d = random_states(np.random.default_rng(seed), batch, CFG)
    ox, pr = d["other_x"], d["other_present"]
    for i in range(batch):
        n = int(pr[i].sum())
        if i % 4 == 0 and n >= 4:
            ox[i, 1] = ox[i, 0]             # tie among the front cars
            ox[i, n - 1] = ox[i, n - 2]     # tie among the rear cars
            d["other_speed"][i, :n] = np.arange(n) + 1.0
        if i % 4 == 1 and n >= 1:
            ox[i, n // 2] = d["ego_x"][i]   # dx == 0 counts as behind
        if i % 8 == 2:                      # no car at all
            ox[i], pr[i] = -np.inf, False
            d["other_speed"][i] = d["other_accel"][i] = 0.0
    return d


def _both(d, dtype):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    js = HighwayState(**{k: jnp.asarray(v) if v.dtype == bool
                         else jnp.asarray(v, jd) for k, v in d.items()})
    ts = convert.highway_state_from_numpy(
        {k: v if v.dtype == bool else v.astype(np.dtype(jd))
         for k, v in d.items()}, "cpu")
    return js, ts


OBS_CASES = {
    "defaults": {},
    "no_other_accel": dict(USE_ACCELERATION_OF_OTHER_CARS=False),
    "absolute_speed": dict(USE_SPEED_DIFFERENCE=False),
    "not_normalized": dict(NORMALIZE_VECTOR_INPUT=False),
    "three_ahead_one_behind": dict(CARS_AHEAD=3, CARS_BEHIND=1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", OBS_CASES)
def test_state_vector_matches_jax(case, dtype):
    cfg, tcfg = CFG.replace(**OBS_CASES[case]), TCFG.replace(**OBS_CASES[case])
    js, ts = _both(_states(3), dtype)
    want = np.asarray(jax.vmap(lambda s: jobs.state_vector(s, cfg))(js))
    got = tobs.state_vector(ts, tcfg)
    assert got.dtype == dtype and got.shape == want.shape
    got = got.numpy()
    per_car = 4 if cfg.USE_ACCELERATION_OF_OTHER_CARS else 3
    flags = slice(per_car - 1, per_car * (cfg.CARS_AHEAD + cfg.CARS_BEHIND),
                  per_car)
    np.testing.assert_array_equal(got[:, flags], want[:, flags])
    assert set(np.unique(want[:, flags])) == {0.0, 1.0}
    atol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_state_vector_breaks_ties_by_slot_order():
    """Two cars at one x differ only in speed: the earlier slot comes
    first, ahead and behind, as the stable ``jnp.argsort`` has it."""
    k = CFG.MAX_SENSED_CARS
    ox = np.full((1, k), -np.inf)
    ox[0, :4] = [10.0, 10.0, -5.0, -5.0]
    ov = np.zeros((1, k))
    ov[0, :4] = [1.0, 2.0, 3.0, 4.0]
    d = dict(ego_x=np.zeros(1), ego_y=np.full(1, -1.6), ego_speed=np.zeros(1),
             ego_accel=np.zeros(1), other_x=ox, other_speed=ov,
             other_accel=np.zeros((1, k)), other_present=np.isfinite(ox))
    js, ts = _both(d, torch.float64)
    got = tobs.state_vector(ts, TCFG).numpy()[0]
    want = np.asarray(jobs.state_vector(
        jax.tree.map(lambda x: x[0], js), CFG))
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(got[[1, 5, 9, 13]] * CFG.MAX_SPEED,
                               [1.0, 2.0, 3.0, 4.0], atol=1e-12)


def _random_tree(rng, in_dim, hidden=256):
    dims = [(in_dim, hidden), (hidden, hidden), (hidden, 1)]
    return {"params": {f"Dense_{i}": {
        "kernel": rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (b,)).astype(np.float32)}
        for i, (a, b) in enumerate(dims)}}


def _torch_actor(tree, low=-5.0, high=5.0):
    state = convert.ddpg_actor_from_numpy(tree)
    hidden, in_dim = state["layers.Dense_0.weight"].shape
    actor = DDPGActor(in_dim, low, high, hidden)
    actor.load_state_dict(state)
    return actor


@pytest.mark.parametrize("source", ["random", "committed"])
def test_actor_matches_flax_apply(source):
    rng = np.random.default_rng(0)
    tree = _random_tree(rng, 20) if source == "random" \
        else tcheckpoint.load_actor_tree("runs/ddpg_default1_extended",
                                      committed=True)
    obs = rng.normal(0, 1, (64, 20)).astype(np.float32)
    want = np.asarray(jmodels.DDPGActor(action_low=-3.0, action_high=2.0)
                      .apply(tree, jnp.asarray(obs)))
    with torch.no_grad():
        got = _torch_actor(tree, -3.0, 2.0)(torch.as_tensor(obs)).numpy()
    assert got.shape == want.shape == (64, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert want.min() >= -3.0 and want.max() <= 2.0 and np.ptp(want) > 0.1


def test_critic_matches_flax_apply():
    rng = np.random.default_rng(1)
    tree = _random_tree(rng, 21)
    obs = rng.normal(0, 1, (64, 20)).astype(np.float32)
    act = rng.uniform(-5, 5, (64, 1)).astype(np.float32)
    want = np.asarray(jmodels.DDPGCritic().apply(tree, jnp.asarray(obs),
                                                 jnp.asarray(act)))
    critic = DDPGCritic()
    critic.load_state_dict(convert.ddpg_critic_from_numpy(tree))
    with torch.no_grad():
        got = critic(torch.as_tensor(obs), torch.as_tensor(act)).numpy()
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_converter_rejects_a_tree_that_is_not_three_dense_layers():
    tree = _random_tree(np.random.default_rng(2), 20)
    del tree["params"]["Dense_2"]
    with pytest.raises(ValueError, match="expected layers"):
        convert.ddpg_actor_from_numpy(tree)
    tree = _random_tree(np.random.default_rng(2), 20)
    tree["params"]["Dense_1"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="do not fit"):
        convert.ddpg_actor_from_numpy(tree)


def _actor_equals_its_checkpoint(run):
    want = load_params(run)["actor"]["params"]
    got = tcheckpoint.load_actor_tree(run, committed=True)["params"]
    assert sorted(got) == sorted(want)
    for layer in want:
        for leaf in ("kernel", "bias"):
            a, b = got[layer][leaf], np.asarray(want[layer][leaf])
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{layer}/{leaf}")
    actor = tcheckpoint.load_actor(run, "cpu", committed=True)
    assert not actor.training
    assert not any(p.requires_grad for p in actor.parameters())
    np.testing.assert_array_equal(
        actor.layers["Dense_0"].weight.numpy(),
        np.asarray(want["Dense_0"]["kernel"]).T)


@pytest.mark.parametrize("name", ACTORS)
def test_committed_actor_equals_its_checkpoint(name):
    _actor_equals_its_checkpoint(f"runs/ddpg_{name}1_extended")


@pytest.mark.parametrize("run", LATER_RUNS)
def test_later_actor_equals_its_checkpoint(run):
    _actor_equals_its_checkpoint(run)


def _critic_equals_its_checkpoint(run):
    """The critic beside each actor, as the DDPG trainer resumes it."""
    want = load_params(run)["critic"]["params"]
    got = tcheckpoint.load_params(run, committed=True)["critic"]["params"]
    assert sorted(got) == sorted(want)
    for layer in want:
        for leaf in ("kernel", "bias"):
            a, b = got[layer][leaf], np.asarray(want[layer][leaf])
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{layer}/{leaf}")
    critic = DDPGCritic()
    critic.load_state_dict(convert.ddpg_critic_from_numpy(
        tcheckpoint.load_params(run, committed=True)["critic"]))
    assert critic.layers["Dense_0"].weight.shape == (256, 21)


@pytest.mark.parametrize("name", ACTORS)
def test_committed_critic_equals_its_checkpoint(name):
    _critic_equals_its_checkpoint(f"runs/ddpg_{name}1_extended")


@pytest.mark.parametrize("run", LATER_RUNS)
def test_later_critic_equals_its_checkpoint(run):
    _critic_equals_its_checkpoint(run)


def test_every_config_finds_its_network():
    """Each of the configs that name a MODEL_NAME finds a committed
    network (the DDPG actors of all three seeds, Rainbow, custom DQN)."""
    import glob
    import json
    names = [json.load(open(p)).get("MODEL_NAME")
             for p in sorted(glob.glob(os.path.join(REPO, "configs",
                                                    "*.json")))]
    names = [n for n in names if n]
    assert len(names) == 93
    missing = sorted({n for n in names if not os.path.exists(
        os.path.join(REPO, tcheckpoint.params_path(n, committed=True)))})
    assert not missing


def test_missing_actor_names_the_export_script():
    with pytest.raises(FileNotFoundError,
                       match="scripts/export_ddpg_actors.py"):
        tcheckpoint.load_actor("runs/ddpg_default4_extended", "cpu")
    assert os.path.basename(tcheckpoint.weights_path(
        "runs/ddpg_low1_extended/")) == "ddpg_low1_extended.npz"


def test_a_run_of_the_port_shadows_the_converted_network(tmp_path,
                                                          monkeypatch):
    """``runs/<name>`` resolves to ``runs_torch/<name>/params.npz`` once a
    run of the port has written it, and to ``weights/<name>.npz`` before;
    ``committed=True`` reads the converted network in both cases."""
    run = "runs/ddpg_default1_extended"
    monkeypatch.chdir(tmp_path)
    assert tcheckpoint.params_path(run) == tcheckpoint.weights_path(run)
    committed = tcheckpoint.load_params(run)
    shifted = {net: {"params": {
        layer: {leaf: value + 1 for leaf, value in leaves.items()}
        for layer, leaves in tree["params"].items()}}
        for net, tree in committed.items()}
    path = tcheckpoint.save_params(
        os.path.join("runs_torch", "ddpg_default1_extended"), shifted)
    assert tcheckpoint.params_path(run) == path
    assert tcheckpoint.params_path(run, committed=True) \
        == tcheckpoint.weights_path(run)
    got = tcheckpoint.load_params(run)
    again = tcheckpoint.load_params(run, committed=True)
    for net, tree in committed.items():
        for layer, leaves in tree["params"].items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(
                    got[net]["params"][layer][leaf], value + 1)
                np.testing.assert_array_equal(
                    again[net]["params"][layer][leaf], value)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_actor_policy_and_controller_match_jax(dtype):
    """``actor_jerk`` and ``actor_controller`` with the committed default
    actor on sensed states: jerk to 1e-5 (f32) / 1e-9 (f64)."""
    run = "runs/ddpg_default1_extended"
    params = load_params(run)["actor"]
    js, ts = _both(_states(4), dtype)
    want_jerk = np.asarray(jddpg.actor_jerk(params, CFG)(js))
    want_speed = np.asarray(jddpg.actor_controller(params, CFG)(js))
    actor = tcheckpoint.load_actor(run, "cpu", TCFG.MINIMUM_NEGATIVE_JERK,
                                   TCFG.MAXIMUM_POSITIVE_JERK,
                                   committed=True).to(dtype)
    got_jerk = tddpg.actor_jerk(actor, TCFG)(ts)
    got_speed = tddpg.actor_controller(actor, TCFG)(ts)
    assert got_jerk.dtype == dtype and got_jerk.shape == (24,)
    atol = 1e-9 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got_jerk.numpy(), want_jerk, atol=atol, rtol=0)
    np.testing.assert_allclose(got_speed.numpy(), want_speed, atol=atol,
                               rtol=0)
    assert np.ptp(want_jerk) > 0.5
