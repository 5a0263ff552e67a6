"""The custom Double-DQN trainer of the port against the JAX package, on the
CPU: the Flax-style initialisation of ``DQNNet``, the converted
``dqn_custom_default1`` network (equal to its orbax checkpoint, identical
greedy actions), epsilon, the Double-DQN targets and one float64 grad step
(1e-9), two train rounds at B=4 with the JAX world's and trainer's draws
replayed (counters exact, parameters and priorities 1e-9), the ``train``
loop and the ``scripts/train_custom_dqn_torch.py`` script."""

import functools
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (JaxReplay, jax_state_to_torch, jax_world_to_torch,
                           random_states)
from rl_mpc_lanemerging_torch import checkpoint as tcheckpoint
from rl_mpc_lanemerging_torch import convert
from rl_mpc_lanemerging_torch.agents import dqn as tdqn
from rl_mpc_lanemerging_torch.models.mlp import DQNNet
from rl_mpc_lanemerging_torch.rl.obs import state_vector as tstate_vector
from rl_mpc_lanemerging_tpu.agents import dqn as jdqn
from rl_mpc_lanemerging_tpu.checkpoint import load_params
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.rl import replay as jrb
from rl_mpc_lanemerging_tpu.rl.obs import state_vector
from rl_mpc_lanemerging_tpu.sim import world as jworld

SMALL = dict(MAX_CARS=16, MAX_SENSED_CARS=8, REPLAY_BUFFER_SIZE=2048)
CFG = Settings.load_from_file("configs/train_default_1.json").replace(**SMALL)
TCFG = convert.settings_from_json("configs/train_default_1.json").replace(
    **SMALL)
RUN = "runs/dqn_custom_default1"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _params(seed):
    return _f64(jdqn._net(CFG).init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, CFG.obs_dim))))


def _torch_net(params):
    net = DQNNet(CFG.obs_dim, len(CFG.JERK_VALUES_DQN))
    net.load_state_dict(convert.dqn_from_numpy(params))
    return net.double()


def _assert_params(net, tree, atol, what=""):
    ours = convert.tree_from_state_dict(net.state_dict())["params"]
    assert sorted(ours) == sorted(tree["params"])
    for layer, leaves in tree["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(ours[layer][leaf], np.asarray(value),
                                       atol=atol, rtol=0,
                                       err_msg=f"{what}{layer}/{leaf}")


@pytest.mark.parametrize("num_hidden", [2, 3])
def test_dqn_net_starts_as_flax_dense(num_hidden):
    """Flax's layer names and shapes; zero biases; LeCun-normal kernels
    (standard deviation within 3% of sqrt(1/fan_in) on kernels of 4096
    values or more, nothing past the truncation); the same seed gives the
    same net."""
    flax_tree = jdqn.DQNNet(num_hidden=num_hidden).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20)))["params"]
    net = DQNNet(20, num_hidden=num_hidden,
                 generator=torch.Generator().manual_seed(1))
    ours = convert.tree_from_state_dict(net.state_dict())["params"]
    assert sorted(ours) == sorted(flax_tree)
    for layer, leaves in flax_tree.items():
        kernel = ours[layer]["kernel"].astype(np.float64)
        assert kernel.shape == leaves["kernel"].shape
        assert np.all(ours[layer]["bias"] == 0.0)
        bar = np.sqrt(1.0 / kernel.shape[0])
        if kernel.size >= 4096:
            assert abs(kernel.std() / bar - 1.0) < 0.03, layer
        assert np.abs(kernel).max() <= 2 * bar / 0.87962566103423978
    again = DQNNet(20, num_hidden=num_hidden,
                   generator=torch.Generator().manual_seed(1))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_dqn_dropout_only_when_asked():
    """USE_DROPOUT adds dropout after each hidden layer, inactive unless
    ``deterministic=False`` (as Flax's ``nn.Dropout``)."""
    x = torch.randn(64, 20, generator=torch.Generator().manual_seed(0))
    plain = DQNNet(20)
    drop = DQNNet(20, dropout=True)
    with torch.no_grad():
        assert torch.equal(drop(x), plain(x))
        torch.manual_seed(0)
        assert not torch.equal(drop(x, deterministic=False), plain(x))
    net = tdqn._net(TCFG.replace(USE_DROPOUT=True))
    assert net.dropout and not tdqn._net(TCFG).dropout


def test_committed_dqn_equals_its_checkpoint():
    want = load_params(RUN)["q"]["params"]
    got = tcheckpoint.load_params(RUN, committed=True)["q"]["params"]
    assert sorted(got) == sorted(want) == ["Dense_0", "Dense_1"]
    for layer in want:
        for leaf in ("kernel", "bias"):
            a, b = got[layer][leaf], np.asarray(want[layer][leaf])
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{layer}/{leaf}")
    net = tcheckpoint.load_dqn(RUN, "cpu", committed=True)
    assert net.layers["Dense_0"].weight.shape == (256, 20)
    assert net.layers["Dense_1"].weight.shape == (5, 256)


def test_converted_greedy_actions_match_jax():
    """128 float32 states: identical argmax-Q actions (several of them),
    speeds within 1e-6."""
    cfg = CFG.replace(MAX_SENSED_CARS=12)
    tcfg = TCFG.replace(MAX_SENSED_CARS=12)
    d = random_states(np.random.default_rng(4), 128, cfg)
    js = HighwayState(**{f: jnp.asarray(v, jnp.float32 if v.dtype != bool
                                        else bool) for f, v in d.items()})
    params = load_params(RUN)["q"]
    want = jax.jit(jdqn.greedy_controller(params, cfg))(js)
    obs = jax.vmap(lambda s: state_vector(s, cfg))(js)
    want_a = np.asarray(jnp.argmax(jdqn._net(cfg).apply(params, obs), -1))
    net = tcheckpoint.load_dqn(RUN, "cpu", committed=True)
    ts = jax_state_to_torch(js)
    got = tdqn.greedy_controller(net, tcfg)(ts)
    with torch.no_grad():
        got_a = net(tstate_vector(ts, tcfg)).argmax(-1).numpy()
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert len(np.unique(want_a)) >= 2


def test_epsilon_matches_jax():
    """float32 on both sides: within 1e-6 relative."""
    for episodes in (0, 1, 29_999, 30_000, 95_000, 400_000):
        got = tdqn.epsilon_by_episode(episodes, TCFG)
        want = jdqn.epsilon_by_episode(jnp.int32(episodes), CFG)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _batch(rng, n=50):
    return dict(obs=rng.normal(size=(n, CFG.obs_dim)),
                next_obs=rng.normal(size=(n, CFG.obs_dim)),
                action=rng.integers(0, 5, n), reward=rng.normal(0, 3, n),
                terminal=rng.uniform(size=n) < 0.3)


@pytest.mark.parametrize("double,clip", [(True, True), (False, False),
                                         (True, False)])
def test_targets_match_jax(double, clip):
    """Double-DQN or plain, clipped or not: 1e-9; terminal rows are their
    reward."""
    cfg = CFG.replace(DOUBLE_DQN=double, CLIP_TARGETS=clip,
                      CLIP_MIN_REWARD=-2.0, CLIP_MAX_REWARD=1.0)
    tcfg = TCFG.replace(DOUBLE_DQN=double, CLIP_TARGETS=clip,
                        CLIP_MIN_REWARD=-2.0, CLIP_MAX_REWARD=1.0)
    p, tp = _params(0), _params(1)
    b = _batch(np.random.default_rng(2))
    want = jdqn._targets(p, tp, {k: jnp.asarray(v) for k, v in b.items()},
                         cfg)
    got = tdqn._targets(_torch_net(p), _torch_net(tp),
                        {k: torch.as_tensor(v) for k, v in b.items()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9,
                               rtol=0)
    term = b["terminal"]
    np.testing.assert_array_equal(got.numpy()[term], b["reward"][term])


def test_grad_step_matches_jax():
    """Three float64 steps from the same parameters and fresh Adam states:
    parameters, loss and td errors within 1e-9; the targets carry no
    gradient (the target net is untouched, the step moves the net)."""
    p, tp = _params(0), _params(1)
    opt = optax.adam(CFG.LEARNING_RATE).init(p)
    net, target = _torch_net(p), _torch_net(tp).requires_grad_(False)
    topt = tdqn._adam(net, TCFG.LEARNING_RATE)
    step = jax.jit(functools.partial(jdqn._grad_step, cfg=CFG))
    rng = np.random.default_rng(5)
    for _ in range(3):
        b = _batch(rng)
        p, opt, loss, td = step(p, opt, {k: jnp.asarray(v)
                                         for k, v in b.items()},
                                target_params=tp)
        tloss, ttd = tdqn._grad_step(net, target, topt,
                                     {k: torch.as_tensor(v)
                                      for k, v in b.items()}, TCFG)
        np.testing.assert_allclose(float(tloss), float(loss), atol=1e-9)
        np.testing.assert_allclose(ttd.numpy(), np.asarray(td), atol=1e-9,
                                   rtol=0)
    _assert_params(net, p, 1e-9)
    _assert_params(target, tp, 0.0)
    assert not np.allclose(np.asarray(p["params"]["Dense_0"]["kernel"]),
                           np.asarray(_params(0)["params"]["Dense_0"][
                               "kernel"]))


class JaxDQNDraws:
    """The JAX trainer's draws from its key chain (dqn.py collect: one
    three-way split per tick; learn: one split per grad step)."""

    def __init__(self, key):
        self.key = key
        self.k_act = None

    def explore(self, batch, device):
        self.key, k_eps, self.k_act = jax.random.split(self.key, 3)
        return torch.as_tensor(np.array(jax.random.uniform(k_eps,
                                                             (batch,))))

    def random_action(self, batch, num_actions, device):
        return torch.as_tensor(np.array(jax.random.randint(
            self.k_act, (batch,), 0, num_actions)))

    def replay_uniform(self, batch, dtype, device):
        self.key, k = jax.random.split(self.key)
        jd = jnp.float64 if dtype == torch.float64 else jnp.float32
        return torch.as_tensor(np.array(jax.random.uniform(k, (batch,),
                                                             jd)))


def test_train_round_matches_jax_with_its_draws(monkeypatch):
    """Two 30-tick rounds at B=4 (3 s episodes after 2 s of warmup, batch
    16, 8 grad steps each, a target refresh between them), float64 on both
    sides (the JAX replay made float64 too), every draw JAX's: episodes and
    replay size exact, parameters, target, priorities and the round's loss
    sum within 1e-9."""
    cfg = CFG.replace(TRAINING_EPISODE_LENGTH=3.0, BATCH_SIZE=16)
    tcfg = TCFG.replace(TRAINING_EPISODE_LENGTH=3.0, BATCH_SIZE=16)
    init = jrb.init_replay
    monkeypatch.setattr(jrb, "init_replay", functools.partial(
        init, dtype=jnp.float64))
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    jw = jax.vmap(lambda k: jworld.init_world(k, cfg, jnp.float64))(keys)
    js = jdqn.make_train_state(cfg, jw, jax.random.PRNGKey(0),
                               wait_before_start=2.0)
    js = js._replace(params=_f64(js.params), target_params=_f64(js.params),
                     opt_state=optax.adam(cfg.LEARNING_RATE).init(
                         _f64(js.params)))
    ts = tdqn.make_train_state(
        tcfg, jax_world_to_torch(jw), JaxReplay(jw.rng), seed=0,
        wait_before_start=2.0,
        init_params=convert.dqn_from_numpy(js.params),
        draws=JaxDQNDraws(js.rng))
    for r in range(2):
        js = jdqn.train_round(js, cfg, env_ticks=30, grad_steps=8,
                              wait_before_start=2.0)
        ts = tdqn.train_round(ts, tcfg, env_ticks=30, grad_steps=8,
                              wait_before_start=2.0)
        assert int(ts.episodes) == int(js.episodes) > 0
        assert int(ts.replay.size) == int(js.replay.size) >= 16
        _assert_params(ts.net, js.params, 1e-9, f"round {r}: ")
        np.testing.assert_allclose(float(ts.loss_sum), float(js.loss_sum),
                                   atol=1e-9)
        cap = ts.replay.capacity
        np.testing.assert_allclose(ts.replay.priority[:cap].numpy(),
                                   np.asarray(js.replay.priority),
                                   atol=1e-9, rtol=0)
        if r == 0:
            js, ts = jdqn.refresh_target(js), tdqn.refresh_target(ts)
    _assert_params(ts.target_net, js.target_params, 1e-9, "target: ")
    assert ts.grad_steps == 16


def test_train_loop_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The custom trainer's loop at B=4: target refreshes, two greedy
    evaluations, the best snapshot written as ``params.npz`` under ``q``
    (loadable by ``load_dqn``), settings and scalars."""
    monkeypatch.chdir(tmp_path)
    cfg = TCFG.replace(NUM_TRAINING_EPISODES=6, TARGET_NET_FREEZE_PERIOD=2,
                       EVALUATION_PERIOD=4, EVALUATION_EPISODE_LENGTH=6.0,
                       BATCH_SCENARIOS=4, SEED=11, LOG_DIR="dqn_loop",
                       TRAINING_EPISODE_LENGTH=10.0)
    refreshes = []
    real = tdqn.refresh_target
    monkeypatch.setattr(tdqn, "refresh_target",
                        lambda s: refreshes.append(1) or real(s))
    state = tdqn.train(cfg, verbose=True, env_ticks=80, device="cpu",
                       eval_episodes=4)
    out = capsys.readouterr().out
    assert int(state.episodes) >= 6 and refreshes
    assert out.count("[eval @") >= 1 and "selected snapshot" in out
    for f in ("settings.json", "scalars_eval_crash.csv", "params.npz"):
        assert os.path.exists(os.path.join("runs_torch/dqn_loop", f))
    net = tcheckpoint.load_dqn("runs/dqn_loop", "cpu")
    for a, b in zip(net.state_dict().values(),
                    state.net.state_dict().values()):
        assert torch.equal(a, b.float())


def test_train_custom_dqn_script(tmp_path, monkeypatch, capsys):
    """The script's wiring: it trains under LOG_DIR dqn_custom_default1 on
    the device asked for, evaluates the trained net over
    ``--episodes-eval`` at ``--batch`` and writes the row to ``--csv``
    (the trainer itself is stubbed; ``test_train_loop_on_the_cpu`` runs
    it)."""
    from rl_mpc_lanemerging_torch import tasks as ttasks
    monkeypatch.chdir(tmp_path)
    seen = {}

    def train(cfg, num_episodes, device):
        seen.update(log_dir=cfg.LOG_DIR, episodes=num_episodes,
                    device=str(device))
        return tdqn.DQNTrainState(
            net=tcheckpoint.load_dqn(RUN, "cpu", committed=True),
            target_net=None, opt=None, replay=None, env=None,
            world_rng=None, draws=None, episodes=None, loss_sum=None)

    real = ttasks.evaluate_controller
    monkeypatch.setattr(tdqn, "train", train)
    monkeypatch.setattr(ttasks, "evaluate_controller", lambda *a, **kw: real(
        a[0].replace(MAX_CARS=16, MAX_SENSED_CARS=8), *a[1:],
        **{**kw, "max_episode_length": 6.0, "wait_before_start": 10.0}))
    monkeypatch.setattr(sys, "argv", [
        "train_custom_dqn_torch.py", "--episodes-train", "7",
        "--episodes-eval", "4", "--batch", "4", "--device", "cpu",
        "--csv", "rows.csv"])
    runpy.run_path(os.path.join(REPO, "scripts/train_custom_dqn_torch.py"),
                   run_name="__main__")
    assert seen == {"log_dir": "dqn_custom_default1", "episodes": 7,
                    "device": "cpu"}
    assert "crashed: " in capsys.readouterr().out
    assert (tmp_path / "rows.csv").read_text().count("\n") == 2
