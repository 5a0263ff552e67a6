"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy and handed to both sides; the JAX side runs on
the CPU with x64, as the rest of the suite does (tests/conftest.py).
Every ``test_torch_*.py`` file imports this module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rl_mpc_lanemerging_torch import convert
from rl_mpc_lanemerging_torch.sim.rng import StepDraws
from rl_mpc_lanemerging_tpu.sim import world as jworld

# The suite runs in several worker processes at once; one intra-op thread
# each keeps the port's small-tensor CPU work from oversubscribing the cores.
torch.set_num_threads(1)


def to_np(tree):
    """numpy arrays of a JAX or torch NamedTuple (or a single array)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_np(x) for x in tree))
    return np.asarray(tree)


def jax_state_to_torch(state):
    """Port HighwayState from a batched JAX HighwayState."""
    return convert.highway_state_from_numpy(
        {k: np.asarray(v) for k, v in state._asdict().items()}, "cpu")


def jax_world_to_torch(world, steps=None):
    return convert.world_state_from_numpy(
        {k: np.asarray(v) for k, v in world._asdict().items()}, "cpu",
        steps=steps)


def random_states(rng, batch, cfg):
    """A batch of sensed states (numpy, f64): merge-entry platoons and light
    traffic, with absent slots at -inf as the JAX world reports them."""
    k = cfg.MAX_SENSED_CARS
    out = {f: [] for f in ("ego_x", "ego_y", "ego_speed", "ego_accel",
                           "other_x", "other_speed", "other_accel",
                           "other_present")}
    for i in range(batch):
        n = int(rng.integers(0, 12))
        if i % 2 == 0:
            ego_x = rng.uniform(-70, -45)
            ego_y = rng.uniform(-1.6, 2.0)
            xs = ego_x + rng.uniform(-5, 15) + np.cumsum(rng.uniform(8, 15, n))
        else:
            ego_x = rng.uniform(-150, 40)
            ego_y = -1.5 if ego_x > 1.5 else rng.uniform(-4, 6)
            xs = rng.uniform(-200, 60, n)
        xs = np.sort(xs)[::-1]
        ox = np.full(k, -np.inf)
        ox[:n] = xs
        ov = np.zeros(k)
        ov[:n] = rng.uniform(0, 12, n)
        oa = np.zeros(k)
        oa[:n] = rng.uniform(-3, 2, n)
        pr = np.zeros(k, bool)
        pr[:n] = True
        for f, v in zip(out, (ego_x, ego_y, rng.uniform(0, 20),
                              rng.uniform(-4, 3), ox, ov, oa, pr)):
            out[f].append(v)
    return {f: np.asarray(v) for f, v in out.items()}


@functools.partial(jax.jit, static_argnums=1)
def _jax_step_draws(keys, jd):
    """The JAX world's per-step key split and draws (world.py:290-330)."""
    def one(key):
        _, k_vary, k_type, k_sf, k_dep = jax.random.split(key, 5)
        probs = jnp.asarray(jworld.IDM_TYPE_PROBS, jd)
        return (jax.random.split(key, 5)[0],
                jax.random.uniform(k_vary, dtype=jd),
                jax.random.choice(k_type, probs.shape[0], p=probs),
                jax.random.normal(k_sf, dtype=jd),
                jax.random.uniform(k_dep, dtype=jd))
    return jax.vmap(one)(keys)


@functools.partial(jax.jit, static_argnums=1)
def _jax_start_draw(keys, jd):
    """The episode runner's start-speed split and normal (episode.py:202)."""
    def one(key):
        k_next, k_start = jax.random.split(key)
        return k_next, jax.random.normal(k_start, dtype=jd)
    return jax.vmap(one)(keys)


def _t(x, dtype):
    return torch.as_tensor(np.array(x)).to(dtype)


def _jd(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


class JaxReplay:
    """A draw source for the port that replays the JAX world's own
    ``jax.random`` draws from the same key chain, so that per-step parity
    is exact.

    Scenario i asks for its draws at its world-step count; a frozen scenario
    asks again at the same count and gets the same draws, as a frozen JAX
    world keeps its key."""

    def __init__(self, keys):
        self.key = np.asarray(keys)                  # (B, 2) current key
        self.step = None                             # (B,) step of `key`
        self.next_key = None                         # key at step + 1

    def _sync(self, steps):
        steps = steps.cpu().numpy()
        if self.step is None:
            self.step = steps.copy()
        adv = steps == self.step + 1
        assert np.all(adv | (steps == self.step)), (steps, self.step)
        if adv.any():
            self.key = np.where(adv[:, None], self.next_key, self.key)
        self.step = steps.copy()

    def step_draws(self, steps, dtype):
        self._sync(steps)
        nxt, vary, typ, sf, dep = _jax_step_draws(jnp.asarray(self.key),
                                                  _jd(dtype))
        self.next_key = np.asarray(nxt)
        return StepDraws(vary=_t(vary, dtype), type_idx=_t(typ, torch.int64),
                         speed_factor=_t(sf, dtype), depart=_t(dep, dtype))

    def start_normal(self, steps, dtype):
        self._sync(steps)
        nxt, z = _jax_start_draw(jnp.asarray(self.key), _jd(dtype))
        self.key = np.asarray(nxt)
        return _t(z, dtype)


def jax_noisy_noise(key, dims):
    """The noise the JAX RainbowNet draws from ``key`` (models/rainbow.py:
    one split per layer, then one for eps_in and one for eps_out), f(e) =
    sign(e) sqrt(|e|), for layers of (in, out) widths ``dims``."""
    def f(e):
        return jnp.sign(e) * jnp.sqrt(jnp.abs(e))

    out = []
    for k, (n_in, n_out) in zip(jax.random.split(key, len(dims)), dims):
        k1, k2 = jax.random.split(k)
        out.append((f(jax.random.normal(k1, (n_in,))),
                    f(jax.random.normal(k2, (n_out,)))))
    return out


def _noise_of(key, net):
    dims = [tuple(layer.w_mu.shape) for layer in net.layers.values()]
    dtype = next(net.parameters()).dtype
    return [tuple(_t(e, dtype) for e in pair)
            for pair in jax_noisy_noise(key, dims)]


class JaxDDPGDraws:
    """A draw source for the port's DDPG trainer that replays the JAX
    trainer's key chain (agents/ddpg.py): one split per tick for the
    exploration normals (:155-157), one per update for the replay uniforms
    (:182, rl/replay.py:109)."""

    def __init__(self, key):
        self.key = key

    def _split(self):
        self.key, k = jax.random.split(self.key)
        return k

    def action_noise(self, shape, dtype, device):
        return _t(jax.random.normal(self._split(), tuple(shape)), dtype)

    def replay_uniform(self, batch, dtype, device):
        return _t(jax.random.uniform(self._split(), (batch,), _jd(dtype)),
                  dtype)


class JaxRainbowDraws:
    """A draw source for the port's Rainbow trainer that replays the JAX
    trainer's key chain (agents/rainbow.py): a four-way split per collect
    tick (NoisyNet noise, epsilon uniforms, random actions; :235-246) and a
    three-way split per grad step (replay uniforms, then the online net's
    noise from the first half of the loss key; :271, :169)."""

    def __init__(self, key):
        self.key = key
        self.k_eps = self.k_act = self.k_loss = None

    def tick_noise(self, net):
        self.key, k_noise, self.k_eps, self.k_act = jax.random.split(
            self.key, 4)
        return _noise_of(k_noise, net)

    def explore(self, batch, device, dtype=torch.float64):
        return _t(jax.random.uniform(self.k_eps, (batch,)), dtype)

    def random_action(self, batch, num_actions, device):
        return _t(jax.random.randint(self.k_act, (batch,), 0, num_actions,
                                     jnp.int32), torch.int64)

    def replay_uniform(self, batch, dtype, device):
        self.key, k_sample, self.k_loss = jax.random.split(self.key, 3)
        return _t(jax.random.uniform(k_sample, (batch,), _jd(dtype)), dtype)

    def step_noise(self, net):
        return _noise_of(jax.random.split(self.k_loss)[0], net)
