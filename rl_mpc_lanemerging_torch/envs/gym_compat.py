"""Gym-compatible single-scenario environment surface.

Port of ``rl_mpc_lanemerging_tpu/envs/gym_compat.py``.  The reference
registers its three SUMO environments with Gym so that third-party trainers
can ``gym.make`` them (reference merge_gym.py:228-246
``register_environments`` -> ``sumo-jerk-v0``, ``sumo-accel-v0``,
``sumo-jerk-continuous-v0``).  This adapter steps one scenario (B=1)
through the same batched ``env_step`` the port's trainers use, so its
semantics are those of the batched env:

* ``reset`` advances the world through the warmup ticks before returning
  the first observation (the reference blocks in ``reset`` while SUMO warms
  up, merge_gym.py:142-149); each reset draws a new episode from
  ``CounterRandom`` keyed by (seed, episode count);
* ``step`` follows the Gymnasium 5-tuple API ``(obs, reward, terminated,
  truncated, info)``; the invalid-action penalty is folded into the reward
  as in the batched env.

The env config takes the reference's keys (merge_gym.py:17-26)
``max_episode_length`` and ``wait_before_start``, plus ``settings`` (a
``Settings``), ``seed`` and ``device`` (``cuda`` unless given).  Neither
``gym`` nor ``gymnasium`` is required: without them the adapter uses
minimal stand-in spaces and ``register_environments()`` returns False with
a warning.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..config import Settings
from ..sim import CounterRandom, init_world
from .merge_env import EnvKind, env_reset, env_step

__all__ = ["MergeGymEnv", "JerkEnv", "AccelerationEnv",
           "ContinuousJerkEnv", "register_environments", "ENV_IDS"]

logger = logging.getLogger(__name__)

ENV_IDS = {
    "sumo-jerk-v0": EnvKind.JERK,
    "sumo-accel-v0": EnvKind.ACCELERATION,
    "sumo-jerk-continuous-v0": EnvKind.CONTINUOUS_JERK,
}


def _spaces():
    """Return (Box, Discrete): real Gym spaces when available, otherwise
    lightweight stand-ins with the same core attributes."""
    try:
        from gymnasium import spaces
        return spaces.Box, spaces.Discrete
    except ImportError:
        pass
    try:
        from gym import spaces
        return spaces.Box, spaces.Discrete
    except ImportError:
        pass

    class _Box:
        def __init__(self, low, high, shape=None, dtype=np.float32):
            self.low = np.broadcast_to(np.asarray(low, dtype), shape).copy()
            self.high = np.broadcast_to(np.asarray(high, dtype),
                                        shape).copy()
            self.shape = tuple(shape)
            self.dtype = dtype

        def sample(self, rng=np.random):
            return rng.uniform(self.low, self.high).astype(self.dtype)

        def contains(self, x):
            x = np.asarray(x)
            return x.shape == self.shape and bool(
                np.all(x >= self.low) and np.all(x <= self.high))

    class _Discrete:
        def __init__(self, n):
            self.n = int(n)
            self.shape = ()
            self.dtype = np.int64

        def sample(self, rng=np.random):
            return int(rng.randint(self.n))

        def contains(self, x):
            return 0 <= int(x) < self.n

    return _Box, _Discrete


def _env_base():
    """gymnasium.Env / gym.Env when available (gymnasium.make refuses
    classes not inheriting its Env), plain object otherwise."""
    try:
        import gymnasium
        return gymnasium.Env
    except ImportError:
        try:
            import gym
            return gym.Env
        except ImportError:
            return object


def _episode_seed(seed: int, episode: int) -> int:
    """The draw-source seed of episode ``episode`` of an env seeded
    ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(episode)])
               .generate_state(1)[0])


class MergeGymEnv(_env_base()):
    """Single-scenario Gym(nasium)-API adapter over the batched env."""

    kind: EnvKind = EnvKind.CONTINUOUS_JERK
    metadata = {"render_modes": []}

    def __init__(self, config: Optional[dict] = None):
        config = dict(config or {})
        self.cfg: Settings = config.get("settings") or Settings()
        self.max_episode_length = float(
            config.get("max_episode_length", self.cfg.MAX_EPISODE_LENGTH))
        self.wait_before_start = float(config.get("wait_before_start", 20))
        self.device = resolve_device(config.get("device", "cuda"))
        self._seed = config.get("seed", 0)
        self._episode = 0
        self._env = None
        self._rng = None

        Box, Discrete = _spaces()
        d = self.cfg.obs_dim
        self.observation_space = Box(-np.inf, np.inf, shape=(d,),
                                     dtype=np.float32)
        if self.kind == EnvKind.JERK:
            self.action_space = Discrete(len(self.cfg.JERK_VALUES_DQN))
        elif self.kind == EnvKind.ACCELERATION:
            self.action_space = Discrete(
                len(self.cfg.ACCELERATION_VALUES_DQN))
        else:
            self.action_space = Box(self.cfg.MINIMUM_NEGATIVE_JERK,
                                    self.cfg.MAXIMUM_POSITIVE_JERK,
                                    shape=(1,), dtype=np.float32)

    # -- Gymnasium API ---------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._seed = seed
        self._rng = CounterRandom(_episode_seed(self._seed, self._episode))
        self._episode += 1
        world = init_world(self.cfg, 1, torch.float32, self.device)
        # the batched env only inserts the ego on the warmup_left 1 -> 0
        # transition, so a sub-tick wait would give an egoless episode;
        # clamp to at least one warmup tick
        self._wait = max(self.wait_before_start, self.cfg.TICK_LENGTH)
        env = env_reset(world, self.cfg, wait_before_start=self._wait)
        # advance through warmup so the first obs is the episode start;
        # the tick count is host-known, so no per-tick read is needed
        noop = self._noop_action()
        for _ in range(int(self._wait / self.cfg.TICK_LENGTH)):
            env, _ = self._step(env, noop)
        self._env = env
        return env.obs[0].cpu().numpy(), {}

    def step(self, action):
        if self._env is None:
            raise RuntimeError("call reset() before step()")
        self._env, tr = self._step(self._env, self._encode_action(action))
        terminated = bool(tr["terminal"][0])
        truncated = bool(tr["done"][0]) and not terminated
        if terminated or truncated:
            self._env = None                 # require reset()
        info = {"crashed": bool(tr["collided"][0]),
                "merged": bool(tr["arrived"][0])}
        return (tr["next_obs"][0].cpu().numpy(), float(tr["reward"][0]),
                terminated, truncated, info)

    def close(self):
        self._env = None

    # -- helpers ---------------------------------------------------------
    def _step(self, env, action):
        return env_step(env, action, self.cfg, self._rng, self.kind,
                        max_episode_length=self.max_episode_length,
                        wait_before_start=self._wait)

    def _noop_action(self) -> torch.Tensor:
        if self.kind == EnvKind.CONTINUOUS_JERK:
            return torch.zeros((1,), device=self.device)
        if self.kind == EnvKind.JERK:
            # the middle entry of the symmetric jerk table is 0
            return torch.full((1,), len(self.cfg.JERK_VALUES_DQN) // 2,
                              dtype=torch.int64, device=self.device)
        table = np.asarray(self.cfg.ACCELERATION_VALUES_DQN)
        return torch.full((1,), int(np.argmin(np.abs(table))),
                          dtype=torch.int64, device=self.device)

    def _encode_action(self, action) -> torch.Tensor:
        if self.kind == EnvKind.CONTINUOUS_JERK:
            return torch.as_tensor(np.asarray(action, np.float32).reshape(1),
                                   device=self.device)
        return torch.tensor([int(np.asarray(action).reshape(()))],
                            dtype=torch.int64, device=self.device)


class JerkEnv(MergeGymEnv):
    kind = EnvKind.JERK


class AccelerationEnv(MergeGymEnv):
    kind = EnvKind.ACCELERATION


class ContinuousJerkEnv(MergeGymEnv):
    kind = EnvKind.CONTINUOUS_JERK


_ENTRY_POINTS = {
    "sumo-jerk-v0": JerkEnv,
    "sumo-accel-v0": AccelerationEnv,
    "sumo-jerk-continuous-v0": ContinuousJerkEnv,
}


def register_environments() -> bool:
    """Register the three env IDs (reference merge_gym.py:228-246) with
    gymnasium or gym, whichever is importable, naming this module's classes
    (an earlier registration of the same IDs is overridden).  Returns True
    when a registry accepted them; False (with a warning) when neither
    package is present: the adapter classes stay directly
    constructible."""
    mod = None
    try:
        import gymnasium as mod
    except ImportError:
        try:
            import gym as mod
        except ImportError:
            pass
    if mod is None:
        logger.warning(
            "neither gymnasium nor gym is installed; sumo-*-v0 IDs not "
            "registered (construct rl_mpc_lanemerging_torch.envs.gym_compat "
            "classes directly)")
        return False
    for env_id, cls in _ENTRY_POINTS.items():
        mod.envs.register(
            id=env_id,
            entry_point=f"{cls.__module__}:{cls.__name__}",
            max_episode_steps=500,
            kwargs={"config": {}})
    return True
