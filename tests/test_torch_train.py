"""The port's training path against the JAX package, in float64 on the CPU:
Flax-style initialisation of the DDPG nets, the DDPG update (1 and 10 steps
from the same parameters and Adam state, 1e-9), the Rainbow net, n-step
head, categorical loss (same NoisyNet noise, 1e-10) and greedy controller,
one train round of each trainer with the JAX world's draws replayed (the
JAX counters) and with every JAX draw replayed (parameters, Adam moments
and priorities, 1e-7), the default draw source's order, and the training
tasks and EVALUATE_DQN through the CLI."""

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

from _torch_parity import (JaxDDPGDraws, JaxRainbowDraws, JaxReplay,
                           jax_noisy_noise, jax_state_to_torch,
                           jax_world_to_torch, random_states)
from _torch_ranks import torch_ddpg as _torch_ddpg
from rl_mpc_lanemerging_torch import checkpoint as tcheckpoint
from rl_mpc_lanemerging_torch import convert, main as tmain
from rl_mpc_lanemerging_torch import tasks as ttasks
from rl_mpc_lanemerging_torch.agents import ddpg as tddpg
from rl_mpc_lanemerging_torch.agents import rainbow as trainbow
from rl_mpc_lanemerging_torch.agents.draws import GeneratorDraws
from rl_mpc_lanemerging_torch.models.ddpg import DDPGActor, DDPGCritic
from rl_mpc_lanemerging_torch.models.rainbow import RainbowNet, sample_noise
from rl_mpc_lanemerging_torch.rundir import RunDir
from rl_mpc_lanemerging_tpu.agents import ddpg as jddpg
from rl_mpc_lanemerging_tpu.agents import rainbow as jrainbow
from rl_mpc_lanemerging_tpu.checkpoint import load_params
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.models import ddpg as jmodels
from rl_mpc_lanemerging_tpu.prediction import HighwayState
from rl_mpc_lanemerging_tpu.rl import replay as jrb
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
             for pair in jax_noisy_noise(key, DIMS)]
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
             for pair in jax_noisy_noise(jax.random.split(key)[0], DIMS)]
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


ROUND_ATOL = 1e-7


def _assert_tree(got, want, atol, what):
    """A port tree (``convert.tree_from_state_dict``) against a JAX one."""
    assert sorted(got["params"]) == sorted(want["params"]), what
    for layer, leaves in want["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(got["params"][layer][leaf],
                                       np.asarray(value), atol=atol, rtol=0,
                                       err_msg=f"{what}/{layer}/{leaf}")


def _assert_net(module, tree, what):
    _assert_tree(convert.tree_from_state_dict(module.state_dict()), tree,
                 ROUND_ATOL, what)


def _assert_adam(opt, module, jax_opt_state, what):
    """Both moments of a torch Adam against optax's, in the Flax layout,
    and the step count exactly."""
    adam = jax_opt_state[0]
    named = list(module.named_parameters())
    assert {int(opt.state[p]["step"]) for _, p in named} == {int(adam.count)}
    for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = convert.tree_from_state_dict(
            {n: opt.state[p][key] for n, p in named})
        _assert_tree(got, want, ROUND_ATOL, f"{what} {key}")


def _assert_replay(replay, jreplay):
    assert int(replay.size) == int(jreplay.size)
    assert int(replay.pos) == int(jreplay.pos)
    _close(replay.priority[:replay.capacity], jreplay.priority, ROUND_ATOL,
           "priority")


def _f64_jax_replay(monkeypatch):
    monkeypatch.setattr(jrb, "init_replay", functools.partial(
        jrb.init_replay, dtype=jnp.float64))


SHORT = dict(MAX_EPISODE_LENGTH=3.0)         # episodes end inside a round


def test_ddpg_round_matches_jax_with_its_draws(monkeypatch):
    """One 30-tick round at B=4 (3 s episodes after 2 s of warmup), float64
    on both sides (the JAX replay made float64 too), REPLAY_START 32 and 4
    updates per tick, every draw JAX's
    (world, exploration noise, replay): actor, critic, both targets, both
    Adam moments and the replay's priorities within 1e-7 of JAX's; the
    counters, the replay's cursor and each scenario's running return
    exact, the sum of the ended episodes' returns to 1e-14 (XLA and torch
    add the scenarios in other orders)."""
    lr = 1e-3
    cfg, tcfg = CFG.replace(**SHORT), TCFG.replace(**SHORT)
    _f64_jax_replay(monkeypatch)
    for mod in (jddpg, tddpg):
        monkeypatch.setattr(mod, "REPLAY_START", 32)
        monkeypatch.setattr(mod, "DDPG_REPLAY_CAPACITY", 4096)
    jw = _jax_worlds(5)
    js = jddpg.make_train_state(cfg, jw, jax.random.PRNGKey(0), lr=lr,
                                wait_before_start=WAIT)
    ap, cp = _f64(js.actor_params), _f64(js.critic_params)
    js = js._replace(actor_params=ap, critic_params=cp, target_actor=ap,
                     target_critic=cp, actor_opt=optax.adam(lr).init(ap),
                     critic_opt=optax.adam(lr).init(cp))
    ts = tddpg.make_train_state(
        tcfg, jax_world_to_torch(jw), JaxReplay(jw.rng), seed=0, lr=lr,
        wait_before_start=WAIT,
        init_params=(convert.ddpg_actor_from_numpy(ap),
                     convert.ddpg_critic_from_numpy(cp)),
        draws=JaxDDPGDraws(js.rng))
    js = jddpg.train_round(js, cfg, lr=lr, env_ticks=30, updates_per_tick=4,
                           wait_before_start=WAIT)
    ts = tddpg.train_round(ts, tcfg, env_ticks=30, updates_per_tick=4,
                           wait_before_start=WAIT)
    assert ts.updates > 0 and int(ts.episodes) > 0
    for name in ("frames", "episodes"):
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    np.testing.assert_array_equal(ts.ret_acc.numpy(), np.asarray(js.ret_acc))
    np.testing.assert_allclose(float(ts.ep_ret_sum), float(js.ep_ret_sum),
                               rtol=1e-14)
    assert float(ts.ep_ret_n) == float(js.ep_ret_n)
    for module, tree, name in (
            (ts.actor, js.actor_params, "actor"),
            (ts.critic, js.critic_params, "critic"),
            (ts.target_actor, js.target_actor, "target actor"),
            (ts.target_critic, js.target_critic, "target critic")):
        _assert_net(module, tree, name)
    _assert_adam(ts.actor_opt, ts.actor, js.actor_opt, "actor")
    _assert_adam(ts.critic_opt, ts.critic, js.critic_opt, "critic")
    _assert_replay(ts.replay, js.replay)


def test_rainbow_round_matches_jax_with_its_draws(monkeypatch):
    """One 30-tick round at B=4 (3 s episodes after 2 s of warmup), float64
    on both sides, REPLAY_START 32, 16 grad steps and epsilon 0.5, every
    draw JAX's (world, NoisyNet noise of each tick and grad step, epsilon
    uniforms, random actions, PER uniforms): the online and target nets,
    both Adam moments and the replay's priorities within 1e-7 of JAX's; the
    counters, the replay's cursor and the n-step window's flags exact.  The
    JAX init is float64 under x64, so the port's nets must take float64
    ``init_params`` without rounding them to float32."""
    lr = 1e-3
    cfg, tcfg = CFG.replace(**SHORT), TCFG.replace(**SHORT)
    _f64_jax_replay(monkeypatch)
    for mod in (jrainbow, trainbow):
        monkeypatch.setattr(mod, "REPLAY_START", 32)
    jw = _jax_worlds(5)
    js = jrainbow.make_train_state(cfg, jw, jax.random.PRNGKey(0), lr=lr,
                                   wait_before_start=WAIT)
    params = _f64(js.params)
    js = js._replace(params=params, target_params=params,
                     opt_state=optax.adam(lr).init(params))
    ts = trainbow.make_train_state(
        tcfg, jax_world_to_torch(jw), JaxReplay(jw.rng), seed=0, lr=lr,
        wait_before_start=WAIT, init_params=convert.rainbow_from_numpy(params),
        draws=JaxRainbowDraws(js.rng))
    js = jrainbow.train_round(js, cfg, lr=lr, env_ticks=30, grad_steps=16,
                              wait_before_start=WAIT, epsilon=0.5)
    ts = trainbow.train_round(ts, tcfg, env_ticks=30, grad_steps=16,
                              wait_before_start=WAIT, epsilon=0.5)
    assert ts.grad_steps == 16 and int(ts.episodes) > 0
    for name in ("frames", "episodes"):
        assert int(getattr(ts, name)) == int(getattr(js, name)), name
    assert ts.stage.fill == int(js.stage.fill)
    for name in ("action", "terminal", "valid"):
        np.testing.assert_array_equal(getattr(ts.stage, name).numpy(),
                                      np.asarray(getattr(js.stage, name)))
    _assert_net(ts.net, js.params, "net")
    _assert_net(ts.target_net, js.target_params, "target")
    _assert_adam(ts.opt, ts.net, js.opt_state, "net")
    _assert_replay(ts.replay, js.replay)
    init_pri = TCFG.PER_MAX_PRIORITY ** TCFG.PER_ALPHA
    assert int((ts.replay.priority[:int(ts.replay.size)] != init_pri).sum())


class _Recording:
    """A draw source that hands on another's draws and records each call:
    (method, arguments, result)."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*args):
            out = fn(*args)
            self.calls.append((name, args, out))
            return out
        return call


def _seeded_round(trainer, monkeypatch, draws=None):
    """A seeded round of the port alone, at B=4 in float64 on the CPU."""
    tmod = tddpg if trainer == "ddpg" else trainbow
    monkeypatch.setattr(tmod, "REPLAY_START", 32)
    monkeypatch.setattr(tddpg, "DDPG_REPLAY_CAPACITY", 4096)
    cfg = TCFG.replace(BATCH_SCENARIOS=4, SEED=7, **SHORT)
    worlds, world_rng = ttasks.make_worlds(cfg, dtype=F64, device="cpu")
    state = tmod.make_train_state(cfg, worlds, world_rng, seed=3,
                                  wait_before_start=WAIT, draws=draws)
    if trainer == "ddpg":
        return tddpg.train_round(state, cfg, env_ticks=30,
                                 updates_per_tick=4, wait_before_start=WAIT)
    return trainbow.train_round(state, cfg, env_ticks=30, grad_steps=8,
                                wait_before_start=WAIT, epsilon=0.5)


def _the_generator_call(name, args, g, net):
    """What the trainers called on their generator before the draw source
    took the calls over, for each of its methods."""
    if name in ("tick_noise", "step_noise"):
        return sample_noise(net, g)
    if name == "action_noise":
        shape, dtype, device = args
        return torch.randn(shape, generator=g, dtype=dtype, device=device)
    if name == "random_action":
        batch, n, device = args
        return torch.randint(0, n, (batch,), generator=g, device=device)
    if name == "explore":
        batch, device, dtype = args
    else:                                    # replay_uniform
        batch, dtype, device = args
    return torch.rand((batch,), generator=g, dtype=dtype, device=device)


@pytest.mark.parametrize("trainer", ["ddpg", "rainbow"])
def test_default_draws_are_the_generator_calls_in_their_order(trainer,
                                                              monkeypatch):
    """The default draw source leaves a seeded round as it was before the
    seam: a round through a recorder of the default source equals the plain
    round bit for bit; the draws come in the trainer's order (DDPG: the
    tick's noise, then one replay draw per update; Rainbow: each tick's
    noise, epsilon uniforms and random actions, then per grad step the PER
    uniforms and the step's noise); and each equals the generator call the
    trainer made before, on a fresh generator of the same seed, which ends
    in the same state as the round's."""
    plain = _seeded_round(trainer, monkeypatch)
    rec = _Recording(GeneratorDraws(torch.Generator().manual_seed(3)))
    seen = _seeded_round(trainer, monkeypatch, draws=rec)
    nets = ("actor", "critic", "target_actor", "target_critic") \
        if trainer == "ddpg" else ("net", "target_net")
    for net in nets:
        for a, b in zip(getattr(plain, net).parameters(),
                        getattr(seen, net).parameters()):
            assert torch.equal(a, b), net
    assert int(plain.frames) == int(seen.frames) > 0
    assert torch.equal(plain.replay.priority, seen.replay.priority)
    if trainer == "ddpg":
        learning = plain.updates // 4
        order = [n for t in range(30) for n in ["action_noise"] + (
            ["replay_uniform"] * 4 if t >= 30 - learning else [])]
        net = None
    else:
        learning = plain.grad_steps
        order = ["tick_noise", "explore", "random_action"] * 30 \
            + ["replay_uniform", "step_noise"] * learning
        net = seen.net
    assert learning > 0
    assert [c[0] for c in rec.calls] == order
    g = torch.Generator().manual_seed(3)
    for name, args, out in rec.calls:
        want = _the_generator_call(name, args, g, net)
        if isinstance(out, list):
            assert all(torch.equal(a, b) for pa, pb in zip(out, want)
                       for a, b in zip(pa, pb)), name
        else:
            assert torch.equal(out, want), name
    assert torch.equal(g.get_state(), plain.draws.generator.get_state())


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
