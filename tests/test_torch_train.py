"""The port's training path against the JAX package, in float64 on the CPU:
Flax-style initialisation of the DDPG nets, the DDPG update (1 and 10 steps
from the same parameters and Adam state, 1e-9), the Rainbow net, n-step
head, categorical loss (same NoisyNet noise, 1e-10) and greedy controller,
one train round of each trainer with the JAX world's draws replayed (the
JAX counters), and the training tasks and EVALUATE_DQN through the CLI."""

import csv
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (JaxReplay, jax_state_to_torch, jax_world_to_torch,
                           random_states)
from _torch_ranks import torch_ddpg as _torch_ddpg
from rl_mpc_lanemerging_torch import checkpoint as tcheckpoint
from rl_mpc_lanemerging_torch import convert, main as tmain
from rl_mpc_lanemerging_torch import tasks as ttasks
from rl_mpc_lanemerging_torch.agents import ddpg as tddpg
from rl_mpc_lanemerging_torch.agents import rainbow as trainbow
from rl_mpc_lanemerging_torch.models.ddpg import DDPGActor, DDPGCritic
from rl_mpc_lanemerging_torch.models.rainbow import RainbowNet
from rl_mpc_lanemerging_torch.rundir import RunDir
from rl_mpc_lanemerging_tpu.agents import ddpg as jddpg
from rl_mpc_lanemerging_tpu.agents import rainbow as jrainbow
from rl_mpc_lanemerging_tpu.checkpoint import load_params
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.models import ddpg as jmodels
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.sim import world as jworld

SMALL = dict(MAX_CARS=16, MAX_SENSED_CARS=8, REPLAY_BUFFER_SIZE=2048)
CFG = Settings.load_from_file("configs/train_default_1.json").replace(**SMALL)
TCFG = convert.settings_from_json("configs/train_default_1.json").replace(
    **SMALL)
F64 = torch.float64
RAINBOW_RUN = "runs/rainbow_default1_extended"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _close(got: torch.Tensor, want, atol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


# --- DDPG ------------------------------------------------------------------

@pytest.mark.parametrize("net", ["actor", "critic"])
def test_ddpg_nets_start_as_flax_dense(net):
    """Zero biases, LeCun-normal kernels: standard deviation within 3% of
    sqrt(1/fan_in) (on the kernels of 4096 values or more), nothing beyond
    the truncation at 2 standard deviations of the untruncated normal; the
    Flax init at the same widths holds to the same bars."""
    g = torch.Generator().manual_seed(3)
    module = DDPGActor(20, generator=g) if net == "actor" \
        else DDPGCritic(20, generator=g)
    flax_mod = jmodels.DDPGActor() if net == "actor" else jmodels.DDPGCritic()
    args = (jnp.zeros((1, 20)),) if net == "actor" \
        else (jnp.zeros((1, 20)), jnp.zeros((1, 1)))
    flax_tree = flax_mod.init(jax.random.PRNGKey(3), *args)["params"]
    ours = convert.tree_from_state_dict(module.state_dict())["params"]
    assert sorted(ours) == sorted(flax_tree)
    for layer in flax_tree:
        fan_in = flax_tree[layer]["kernel"].shape[0]
        bar = np.sqrt(1.0 / fan_in)
        for tree in (ours, flax_tree):
            kernel = np.asarray(tree[layer]["kernel"], np.float64)
            assert kernel.shape == flax_tree[layer]["kernel"].shape
            assert np.all(np.asarray(tree[layer]["bias"]) == 0.0)
            if kernel.size >= 4096:         # sampling error ~1%
                assert abs(kernel.std() / bar - 1.0) < 0.03, (layer,
                                                              kernel.std())
            assert np.abs(kernel).max() <= 2 * bar / 0.87962566103423978
    # the draws come from the generator: the same seed gives the same net
    again = DDPGActor(20, generator=torch.Generator().manual_seed(3))
    if net == "actor":
        for a, b in zip(module.parameters(), again.parameters()):
            assert torch.equal(a, b)


def _ddpg_params(seed):
    actor, critic = jddpg._nets(CFG)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    ap = _f64(actor.init(k1, jnp.zeros((1, CFG.obs_dim))))
    cp = _f64(critic.init(k2, jnp.zeros((1, CFG.obs_dim)),
                          jnp.zeros((1, 1))))
    return ap, cp


def _ddpg_batch(rng, n=100):
    action = rng.uniform(-5, 5, n)
    return dict(obs=rng.normal(size=(n, CFG.obs_dim)),
                next_obs=rng.normal(size=(n, CFG.obs_dim)), action=action,
                reward=action / 5.0 + rng.normal(0, 0.1, n),
                terminal=rng.uniform(size=n) < 0.3)


@pytest.mark.parametrize("updates", [1, 10])
def test_ddpg_update_matches_jax(updates):
    """Same parameters, fresh Adam states, target nets started elsewhere
    (so the polyak average shows): actor, critic and both targets to
    1e-9."""
    lr = 1e-3
    ap, cp = _ddpg_params(0)
    ta, tc = _ddpg_params(1)
    ao, co = optax.adam(lr).init(ap), optax.adam(lr).init(cp)
    actor, critic, t_actor, t_critic, a_opt, c_opt = _torch_ddpg(ap, cp, lr)
    t_actor.load_state_dict(convert.ddpg_actor_from_numpy(ta))
    t_critic.load_state_dict(convert.ddpg_critic_from_numpy(tc))
    j_update = jax.jit(functools.partial(jddpg._update, CFG, lr))
    rng = np.random.default_rng(4)
    for _ in range(updates):
        b = _ddpg_batch(rng)
        ap, cp, ta, tc, ao, co = j_update(
            ap, cp, ta, tc, ao, co, {k: jnp.asarray(v) for k, v in b.items()})
        tddpg._update(actor, critic, t_actor, t_critic, a_opt, c_opt,
                      {k: torch.as_tensor(v) for k, v in b.items()})
    for module, tree, name in ((actor, ap, "actor"), (critic, cp, "critic"),
                               (t_actor, ta, "target actor"),
                               (t_critic, tc, "target critic")):
        ours = convert.tree_from_state_dict(module.state_dict())["params"]
        for layer, leaves in tree["params"].items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(ours[layer][leaf],
                                           np.asarray(value), atol=1e-9,
                                           rtol=0,
                                           err_msg=f"{name}/{layer}/{leaf}")
    # the update moved every network
    ap0, cp0 = _ddpg_params(0)
    assert not np.allclose(np.asarray(ap0["params"]["Dense_0"]["kernel"]),
                           np.asarray(ap["params"]["Dense_0"]["kernel"]))


# --- Rainbow ---------------------------------------------------------------

def _jax_noise(key, dims):
    """The noise the JAX RainbowNet draws from ``key`` (rainbow.py:44-48,
    64)."""
    def f(e):
        return jnp.sign(e) * jnp.sqrt(jnp.abs(e))

    out = []
    for k, (n_in, n_out) in zip(jax.random.split(key, 3), dims):
        k1, k2 = jax.random.split(k)
        out.append((f(jax.random.normal(k1, (n_in,))),
                    f(jax.random.normal(k2, (n_out,)))))
    return out


@functools.lru_cache(maxsize=None)
def _rainbow_params():
    return _f64(load_params(RAINBOW_RUN)["q_dist"])


def _torch_rainbow(params):
    net = RainbowNet(CFG.obs_dim)
    net.load_state_dict(convert.rainbow_from_numpy(params))
    return net.double()


DIMS = [(20, 256), (256, 51), (256, 255)]


def test_rainbow_net_matches_flax_apply_with_the_same_noise():
    params = _rainbow_params()
    net = jrainbow._net(CFG)
    obs = np.random.default_rng(0).normal(size=(16, CFG.obs_dim))
    key = jax.random.PRNGKey(7)
    noise = [tuple(torch.as_tensor(np.asarray(e)) for e in pair)
             for pair in _jax_noise(key, DIMS)]
    tnet = _torch_rainbow(params)
    for j_rng, t_noise in ((None, None), (key, noise)):
        want = net.apply(params, jnp.asarray(obs), rng=j_rng)
        with torch.no_grad():
            got = tnet(torch.as_tensor(obs), t_noise)
        assert got.shape == (16, 5, 51)
        _close(got, want, 1e-10)


def test_committed_rainbow_equals_its_checkpoint():
    want = load_params(RAINBOW_RUN)["q_dist"]["params"]
    got = tcheckpoint.load_params(RAINBOW_RUN, committed=True)["q_dist"][
        "params"]
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer])
        for leaf, value in want[layer].items():
            assert got[layer][leaf].dtype == np.float32
            np.testing.assert_array_equal(got[layer][leaf], np.asarray(value),
                                          err_msg=f"{layer}/{leaf}")


def _stage(rng, b=6, n=3, d=4):
    terminal = rng.uniform(size=(b, n)) < 0.3
    valid = rng.uniform(size=(b, n)) < 0.75
    terminal[0], valid[0] = False, True            # full window
    terminal[1], valid[1] = [False, True, False], True
    valid[2] = [False, True, True]                 # invalid head
    return dict(obs=rng.normal(size=(b, n, d)),
                action=rng.integers(0, 5, (b, n)),
                reward=rng.normal(size=(b, n)),
                next_obs=rng.normal(size=(b, n, d)), terminal=terminal,
                valid=valid)


@pytest.mark.parametrize("fill", [2, 3])
def test_nstep_head_matches_jax(fill):
    d = _stage(np.random.default_rng(fill))
    js = jrainbow.NStepStage(**{k: jnp.asarray(v) for k, v in d.items()},
                             fill=jnp.asarray(fill, jnp.int32))
    ts = trainbow.NStepStage(**{k: torch.as_tensor(v) for k, v in d.items()},
                             fill=fill)
    want = jrainbow.nstep_head(js, 0.99)
    got = trainbow.nstep_head(ts, 0.99)
    names = ("obs", "action", "R", "next_obs", "terminal", "discount",
             "valid")
    for name, g, w in zip(names, got, want):
        if name in ("R", "discount"):
            _close(g, w, 1e-12, name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert bool(got[6].any()) == (fill == 3)


def test_stage_push_matches_jax():
    rng = np.random.default_rng(5)
    d = _stage(rng)
    js = jrainbow.NStepStage(**{k: jnp.asarray(v) for k, v in d.items()},
                             fill=jnp.asarray(2, jnp.int32))
    ts = trainbow.NStepStage(**{k: torch.as_tensor(v) for k, v in d.items()},
                             fill=2)
    tr = dict(obs=rng.normal(size=(6, 4)), action=rng.integers(0, 5, 6),
              reward=rng.normal(size=6), next_obs=rng.normal(size=(6, 4)),
              terminal=rng.uniform(size=6) < 0.5,
              valid=rng.uniform(size=6) < 0.5)
    want = jrainbow.stage_push(js, {k: jnp.asarray(v) for k, v in tr.items()})
    got = trainbow.stage_push(ts, {k: torch.as_tensor(v)
                                   for k, v in tr.items()})
    for f in ("obs", "action", "reward", "next_obs", "terminal", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.fill == int(want.fill) == 3


def _rainbow_batch(rng, n=32):
    return dict(obs=rng.normal(size=(n, CFG.obs_dim)),
                next_obs=rng.normal(size=(n, CFG.obs_dim)),
                action=rng.integers(0, 5, n),
                reward=rng.uniform(-12, 11, n),
                terminal=rng.uniform(size=n) < 0.2,
                discount=0.99 ** rng.integers(1, 4, n).astype(float))


@pytest.mark.parametrize("weighted", [False, True])
def test_categorical_loss_matches_jax(weighted):
    """Loss, per-sample cross-entropy and the projected target m to 1e-10
    with the same noise; the target net differs from the online net.  JAX's
    m is read from the loss function's closure, where the JAX package keeps
    it."""
    params = _rainbow_params()
    target = _f64(jax.tree.map(lambda x: x * 0.9,
                               load_params(RAINBOW_RUN)["q_dist"]))
    rng = np.random.default_rng(6)
    b = _rainbow_batch(rng)
    w = rng.uniform(0.2, 1.0, 32) if weighted else None
    key = jax.random.PRNGKey(11)
    loss_fn = jrainbow._categorical_loss(
        params, target, {k: jnp.asarray(v) for k, v in b.items()}, key, CFG,
        weights=None if w is None else jnp.asarray(w))
    j_loss, j_ce = loss_fn(params)
    j_m = dict(zip(loss_fn.__code__.co_freevars,
                   (c.cell_contents for c in loss_fn.__closure__)))["m"]
    # the online net's noise: the first half of the loss key (rainbow.py:245)
    noise = [tuple(torch.as_tensor(np.asarray(e)) for e in pair)
             for pair in _jax_noise(jax.random.split(key)[0], DIMS)]
    t_loss, t_ce, t_m = trainbow._categorical_loss(
        _torch_rainbow(params), _torch_rainbow(target),
        {k: torch.as_tensor(v) for k, v in b.items()}, noise,
        None if w is None else torch.as_tensor(w))
    _close(t_m, j_m, 1e-10, "m")
    _close(t_ce, j_ce, 1e-10, "ce")
    _close(t_loss, j_loss, 1e-10, "loss")
    np.testing.assert_allclose(t_m.sum(dim=1).numpy(), 1.0, atol=1e-12)
    assert (t_m > 0).sum(dim=1).max() >= 2          # mass split over atoms


def test_greedy_controller_matches_jax():
    params = _rainbow_params()
    cfg, tcfg = CFG.replace(MAX_SENSED_CARS=12), TCFG.replace(
        MAX_SENSED_CARS=12)
    d = random_states(np.random.default_rng(8), 48, cfg)
    js = HighwayState(**{f: jnp.asarray(v) for f, v in d.items()})
    want = jax.jit(jrainbow.greedy_controller(params, cfg))(js)
    net = _torch_rainbow(params)
    ts = jax_state_to_torch(js)
    got = trainbow.greedy_controller(net, tcfg)(ts)
    _close(got, want, 1e-12)
    # the actions behind the speeds: argmax of E[Z], first index on ties
    from rl_mpc_lanemerging_tpu.rl.obs import state_vector
    obs = jax.vmap(lambda s: state_vector(s, cfg))(js)
    q = jnp.sum(jax.nn.softmax(jrainbow._net(cfg).apply(params, obs), -1)
                * jrainbow._support(), -1)
    from rl_mpc_lanemerging_torch.rl.obs import state_vector as tsv
    with torch.no_grad():
        tq = (torch.softmax(net(tsv(ts, tcfg)), -1)
              * trainbow._support(ts.ego_x)).sum(-1)
    np.testing.assert_array_equal(tq.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(q, -1)))
    assert len(np.unique(np.asarray(jnp.argmax(q, -1)))) >= 2


# --- the slice as a whole --------------------------------------------------

WAIT = 2.0


def _jax_worlds(seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return jax.vmap(lambda k: jworld.init_world(k, CFG, jnp.float64))(keys)


@pytest.mark.parametrize("trainer", ["ddpg", "rainbow"])
def test_train_round_counts_match_jax(trainer, monkeypatch):
    """One 30-tick round at B=4 with REPLAY_START 32 on both sides and the
    JAX world's draws replayed: the port's frames, episodes and replay size
    equal JAX's, updates ran, and every parameter stays finite."""
    jmod, tmod = (jddpg, tddpg) if trainer == "ddpg" \
        else (jrainbow, trainbow)
    monkeypatch.setattr(jmod, "REPLAY_START", 32)
    monkeypatch.setattr(tmod, "REPLAY_START", 32)
    jw = _jax_worlds(5)
    js = jmod.make_train_state(CFG, jw, jax.random.PRNGKey(0),
                               wait_before_start=WAIT)
    ts = tmod.make_train_state(TCFG, jax_world_to_torch(jw), JaxReplay(jw.rng),
                               seed=0, wait_before_start=WAIT)
    if trainer == "ddpg":
        js = jddpg.train_round(js, CFG, lr=1e-3, env_ticks=30,
                               updates_per_tick=4, wait_before_start=WAIT)
        ts = tddpg.train_round(ts, TCFG, env_ticks=30, updates_per_tick=4,
                               wait_before_start=WAIT)
        params = list(ts.actor.parameters()) + list(ts.critic.parameters())
        steps = ts.updates
    else:
        js = jrainbow.train_round(js, CFG, lr=1e-3, env_ticks=30,
                                  grad_steps=4, wait_before_start=WAIT,
                                  epsilon=0.5)
        ts = trainbow.train_round(ts, TCFG, env_ticks=30, grad_steps=4,
                                  wait_before_start=WAIT, epsilon=0.5)
        params = list(ts.net.parameters())
        steps = ts.grad_steps
        updated = ts.replay.priority[:int(ts.replay.size)] != 2.0
        assert 0 < int(updated.sum()) <= 4 * trainbow.RAINBOW_BATCH
    assert int(ts.frames) == int(js.frames) > 0
    assert int(ts.episodes) == int(js.episodes)
    assert int(ts.replay.size) == int(js.replay.size) >= 32
    assert steps > 0 and ts.learning
    assert all(bool(torch.isfinite(p).all()) for p in params)


def _short_evaluations(monkeypatch):
    """Evaluation rounds of 10 s of warmup and 6 s episodes."""
    real = ttasks.evaluate_controller

    def short(*a, **kw):
        return real(*a, **{**kw, "max_episode_length": 6.0,
                           "wait_before_start": 10.0})

    monkeypatch.setattr(ttasks, "evaluate_controller", short)


def _cli_config(tmp_path, **kw):
    with open(os.path.join(REPO, "configs/train_default_1.json")) as fh:
        base = json.load(fh)
    base.update(MAX_CARS=16, MAX_SENSED_CARS=8, BATCH_SCENARIOS=4,
                NUM_EPISODES=4, MAX_EPISODE_LENGTH=30.0, **kw)
    path = tmp_path / f"{kw['LOG_DIR']}.json"
    path.write_text(json.dumps(base))
    return str(path)


@pytest.mark.parametrize("progress", [
    {"episodes": 3, "avg_return": -1.5, "lr": 1e-4},      # DDPG
    {"episodes": 3, "lr": 1e-4},                          # Rainbow
    {"epsilon": 0.5, "loss": 0.25},                       # custom DQN
], ids=["ddpg", "rainbow", "dqn"])
def test_scalars_keep_one_schema_per_file(tmp_path, progress):
    """A trainer's progress rows and selection-eval rows, interleaved, land
    in one file per key set, each read back by ``csv.DictReader`` into the
    keys and values it was given; a later run rotates each file."""
    selection = {"eval_crash": 0.0, "eval_merge": 1.0, "eval_jerk": 0.5,
                 "eval_t_merge": 26.5}
    rows = [(10, progress), (20, selection), (30, progress),
            (40, selection)]
    run = RunDir(str(tmp_path))
    for step, values in rows:
        run.log_scalars(step, values)
    assert len(os.listdir(tmp_path)) == 2
    for values in (progress, selection):
        with open(run.scalars_path(values)) as fh:
            read = list(csv.DictReader(fh))
        want = [(s, v) for s, v in rows if v is values]
        assert [int(r.pop("step")) for r in read] == [s for s, _ in want]
        assert read == [{k: repr(float(x)) for k, x in v.items()}
                        for _, v in want]
    RunDir(str(tmp_path)).log_scalars(50, selection)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(run.scalars_path(progress)),
         "scalars_eval_crash.csv", "scalars_eval_crash.1.csv"])
    with pytest.raises(ValueError):
        run.log_scalars(60, {"eval_crash": 1.0})


def test_cli_trains_and_resumes_ddpg_on_the_cpu(tmp_path, monkeypatch,
                                                capsys):
    """TRAIN_DDPG through the CLI at a budget of one round per stage, then
    RESUME_DDPG from the extended stage's checkpoint, on a narrowed config:
    both stages write params.npz, the resumed run starts from them, and the
    evaluation's row goes to the CSV."""
    monkeypatch.chdir(tmp_path)
    _short_evaluations(monkeypatch)
    monkeypatch.setattr(tddpg, "train", functools.partial(
        tddpg.train, eval_episodes=4))
    monkeypatch.setattr(tddpg, "TICKS_PER_ROUND", 40)
    cfg = _cli_config(tmp_path, TASK="TRAIN_DDPG", LOG_DIR="cli_ddpg")
    tmain.main([cfg, "--device", "cpu", "--frames", "1",
                "--csv", "rows.csv"])
    out = capsys.readouterr().out
    assert "DDPG train: 1 frames" in out and "DDPG extended" in out
    assert "[eval @" in out and "crashed: " in out
    trees = [tcheckpoint.load_params(f"runs/cli_ddpg{s}")
             for s in ("", "_extended")]
    for tree in trees:
        assert sorted(tree) == ["actor", "critic"]
        assert tree["critic"]["params"]["Dense_0"]["kernel"].shape == (21,
                                                                       256)
    resume = _cli_config(tmp_path, TASK="RESUME_DDPG",
                         LOG_DIR="cli_ddpg_resumed",
                         MODEL_NAME="runs/cli_ddpg_extended")
    seen = {}
    real = tddpg.make_train_state

    def spy(*a, **kw):
        seen["init"] = kw.get("init_params")
        return real(*a, **kw)

    monkeypatch.setattr(tddpg, "make_train_state", spy)
    tmain.main([resume, "--device", "cpu", "--frames", "1",
                "--csv", "rows.csv"])
    np.testing.assert_array_equal(
        seen["init"][0]["layers.Dense_0.weight"].numpy(),
        trees[1]["actor"]["params"]["Dense_0"]["kernel"].T)
    assert (tmp_path / "rows.csv").read_text().count("\n") == 3


def test_cli_trains_and_evaluates_rainbow_on_the_cpu(tmp_path, monkeypatch,
                                                     capsys):
    """TRAIN_DQN through the CLI at a budget of one round per stage, and
    EVALUATE_DQN with the converted rainbow_default1_extended network."""
    monkeypatch.chdir(tmp_path)
    _short_evaluations(monkeypatch)
    monkeypatch.setattr(trainbow, "train", functools.partial(
        trainbow.train, eval_episodes=4))
    monkeypatch.setattr(trainbow, "TICKS_PER_ROUND", 40)
    cfg = _cli_config(tmp_path, TASK="TRAIN_DQN", LOG_DIR="cli_dqn")
    tmain.main([cfg, "--device", "cpu", "--frames", "1"])
    out = capsys.readouterr().out
    assert "[eval @" in out and "crashed: " in out
    for s in ("", "_extended"):
        tree = tcheckpoint.load_params(f"runs/cli_dqn{s}")
        assert sorted(tree) == ["q_dist"]
    ev = _cli_config(tmp_path, TASK="EVALUATE_DQN", LOG_DIR="cli_eval_dqn",
                     MODEL_NAME=RAINBOW_RUN)
    tmain.main([ev, "--device", "cpu", "--csv", "rows.csv"])
    out = capsys.readouterr().out
    assert "[4/4]" in out and "crashed: " in out
    assert (tmp_path / "rows.csv").read_text().count("\n") == 2
