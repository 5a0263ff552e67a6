"""Parity of the port's dense DP twin (ops/st_dp.py) with the JAX package's
``st_dp`` and with the C++ heap oracle, in float64 at atol 1e-9."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (test-process settings)
from rl_mpc_lanemerging_torch.ops import st_dp as tdp
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.ops import oracle
from rl_mpc_lanemerging_tpu.ops import st_dp as jdp

CFG = Settings()
W = jdp.STWeights(
    CFG.D_WEIGHT, CFG.V_WEIGHT, CFG.A_WEIGHT, CFG.J_WEIGHT,
    CFG.DESIRED_SPEED, CFG.MAX_SPEED, CFG.MAX_NEGATIVE_ACCELERATION,
    CFG.MAX_POSITIVE_ACCELERATION, CFG.MINIMUM_NEGATIVE_JERK,
    CFG.MAXIMUM_POSITIVE_JERK, CFG.MIN_ALLOWED_DISTANCE)
TW = tdp.STWeights(*W)
MOFF = jdp.default_max_offset(CFG.MAX_SPEED, 0.3, 0.05)
ATOL = 1e-9


def random_lattices(rng, batch, num_t=10, num_s=401):
    """Moving obstacle bands, as tests/test_st_dp.py:random_lattice."""
    obst = np.zeros((batch, num_t, num_s), bool)
    dist = np.full((batch, num_t, num_s), 1e10)
    s_values = np.empty((batch, num_s))
    for b in range(batch):
        s_values[b] = rng.uniform(-200, 20) + np.arange(num_s) * 0.05
        for _ in range(3):
            pos, vel = rng.uniform(0, num_s), rng.uniform(-40, 40)
            half = int(rng.integers(40, 120))
            for t in range(num_t):
                c = int(pos + vel * t)
                lo, hi = max(c - half, 0), min(c + half, num_s)
                if lo < num_s and hi > 0:
                    obst[b, t, lo:hi] = True
                d2 = np.minimum(np.abs(np.arange(num_s) - (c - half)),
                                np.abs(np.arange(num_s) - (c + half)))
                dist[b, t] = np.minimum(dist[b, t], d2 * 0.05)
        dist[b][obst[b]] = 0.0
    obst[:, :, 0] = False
    t_values = np.arange(num_t) * 0.3
    v0 = rng.uniform(0, 25, batch)
    a0 = rng.uniform(-6, 4.5, batch)
    return obst, s_values, t_values, v0, a0, dist


@functools.lru_cache(maxsize=None)
def _jax_solvers():
    fast = jax.jit(jax.vmap(
        lambda o, s, t, v, a, d: jdp.solve_st_fast(o, s, t, v, a, d, W, MOFF),
        in_axes=(0, 0, None, 0, 0, 0)))
    no_jerk = jax.jit(jax.vmap(
        lambda o, s, t, v, d: jdp.solve_st_no_jerk_fast(o, s, t, v, d, W,
                                                        MOFF),
        in_axes=(0, 0, None, 0, 0)))
    return fast, no_jerk


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("seed", range(3))
def test_jerk_dp_matches_jax_and_oracle(seed):
    obst, sv, tv, v0, a0, dist = random_lattices(
        np.random.default_rng(seed), 4)
    got = tdp.solve_st_fast(_t(obst), _t(sv), _t(tv), _t(v0), _t(a0),
                            _t(dist), TW, MOFF).numpy()
    ref = np.asarray(_jax_solvers()[0](obst, sv, tv, v0, a0, dist))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    for b in range(len(v0)):
        want = oracle.solve_fast(
            obst[b], sv[b], tv, v0[b], a0[b], dist[b], *W)
        np.testing.assert_allclose(got[b], want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(3))
def test_no_jerk_dp_matches_jax_and_oracle(seed):
    obst, sv, tv, v0, _, dist = random_lattices(
        np.random.default_rng(1000 + seed), 4)
    got = tdp.solve_st_no_jerk_fast(_t(obst), _t(sv), _t(tv), _t(v0),
                                    _t(dist), TW, MOFF).numpy()
    ref = np.asarray(_jax_solvers()[1](obst, sv, tv, v0, dist))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    for b in range(len(v0)):
        want = oracle.solve_no_jerk_fast(
            obst[b], sv[b], tv, v0[b], dist[b], W.d_weight, W.v_weight,
            W.a_weight, W.desired_speed, W.max_speed,
            W.negative_acceleration_limit, W.positive_acceleration_limit,
            W.min_allowed_distance)
        np.testing.assert_allclose(got[b], want, atol=ATOL, rtol=0)


def test_negative_range_wraparound_quirk():
    """A braking ego with max_v < 0 gets an inverted feasible range whose
    negative indices wrap around the reference's numpy lattice
    (tests/test_pallas.py:142-169); the port's twin must reproduce it as the
    JAX twin and the oracle do."""
    num_t, num_s = 18, 3001
    sv = (-121.3 + np.arange(num_s) * 0.05)[None]
    tv = np.arange(num_t) * 0.3
    obst = np.zeros((1, num_t, num_s), bool)
    dist = np.full((1, num_t, num_s), 1e10)
    v0, a0 = np.array([0.01]), np.array([-2.33])
    got = tdp.solve_st_fast(_t(obst), _t(sv), _t(tv), _t(v0), _t(a0),
                            _t(dist), TW, MOFF).numpy()[0]
    want = oracle.solve_fast(obst[0], sv[0], tv, v0[0], a0[0], dist[0], *W)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    ref = np.asarray(jdp.solve_st_fast(
        jnp.asarray(obst[0]), jnp.asarray(sv[0]), jnp.asarray(tv),
        jnp.float64(v0[0]), jnp.float64(a0[0]), jnp.asarray(dist[0]), W,
        MOFF))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_blocked_future_is_zero_filled():
    num_t, num_s = 10, 401
    sv = (np.arange(num_s) * 0.05)[None]
    tv = np.arange(num_t) * 0.3
    obst = np.zeros((1, num_t, num_s), bool)
    obst[:, 5:] = True
    dist = np.where(obst, 0.0, 1e10)
    got = tdp.solve_st_fast(_t(obst), _t(sv), _t(tv), _t([5.0]), _t([0.0]),
                            _t(dist), TW, MOFF).numpy()[0]
    assert np.all(got[5:] == 0.0) and np.any(got[1:5] > 0.0)
