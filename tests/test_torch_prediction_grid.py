"""Parity of the port's geometry, forecaster and grid construction with the
JAX package, in float64 on the CPU.

Bars: geometry and forecasts within 1e-9; grid obstacles exactly equal and
distances within 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_state_to_torch, random_states, to_np
from rl_mpc_lanemerging_torch import geometry as tgeo
from rl_mpc_lanemerging_torch import prediction as tpred
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.planner.grid import build_st_grid as t_grid
from rl_mpc_lanemerging_tpu import geometry as jgeo
from rl_mpc_lanemerging_tpu import prediction as jpred
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.planner.grid import build_st_grid as j_grid

CFG = Settings.load_from_file("configs/st_default.json")
TCFG = TSettings.load_from_file("configs/st_default.json")
NARROW = CFG.replace(FUTURE_S=15.0)
TNARROW = TCFG.replace(FUTURE_S=15.0)
ATOL = 1e-9


def _jstate(d):
    return jpred.HighwayState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_settings_copy_matches_jax_package():
    assert TCFG.export_settings() == CFG.export_settings()
    assert (TCFG.num_t, TCFG.num_s, TCFG.fine_horizon) == (18, 3001, 26)
    assert (TNARROW.num_s, TNARROW.fine_horizon) == (NARROW.num_s, 26)


@pytest.mark.parametrize("seed", range(3))
def test_route_xy_and_ego_s(seed):
    rng = np.random.default_rng(seed)
    arc = rng.uniform(-10.0, 330.0, 257)
    got = tgeo.route_xy(torch.as_tensor(arc)).numpy()
    ref = np.asarray(jgeo.route_xy(jnp.asarray(arc)))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    x = rng.uniform(-260, 120, 257)
    y = rng.uniform(-3, 30, 257)
    np.testing.assert_allclose(
        tgeo.get_ego_s(torch.as_tensor(x), torch.as_tensor(y)).numpy(),
        np.asarray(jgeo.get_ego_s(jnp.asarray(x), jnp.asarray(y))),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tgeo.get_obstacle_s_from_x(torch.as_tensor(x)).numpy(),
        np.asarray(jgeo.get_obstacle_s_from_x(jnp.asarray(x))), atol=0)


@functools.lru_cache(maxsize=None)
def _jax_steps():
    with_ego = jax.jit(jax.vmap(lambda s, v: jpred.predict_step_with_ego(
        s, v, 0.3, CFG)))
    without = jax.jit(jax.vmap(lambda s: jpred.predict_step_without_ego(
        s, 0.3, CFG)))
    closest = jax.jit(jax.vmap(jpred.get_closest_cars))
    return with_ego, without, closest


def _assert_state_close(got, ref):
    for f in jpred.HighwayState._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f)


@pytest.mark.parametrize("seed", range(3))
def test_forecast_steps_and_closest_cars(seed):
    rng = np.random.default_rng(100 + seed)
    d = random_states(rng, 64, CFG)
    js, ts = _jstate(d), jax_state_to_torch(_jstate(d))
    speeds = rng.uniform(0, 20, 64)
    with_ego, without, closest = _jax_steps()

    j_next, j_crash = with_ego(js, jnp.asarray(speeds))
    t_next, t_crash = tpred.predict_step_with_ego(
        ts, torch.as_tensor(speeds), 0.3, TCFG)
    _assert_state_close(to_np(t_next), j_next)
    np.testing.assert_array_equal(t_crash.numpy(), np.asarray(j_crash))

    j_next, j_crash = without(js)
    t_next, t_crash = tpred.predict_step_without_ego(ts, 0.3, TCFG)
    _assert_state_close(to_np(t_next), j_next)
    np.testing.assert_array_equal(t_crash.numpy(), np.asarray(j_crash))

    for t_car, j_car in zip(tpred.get_closest_cars(ts), closest(js)):
        for a, b in zip(t_car, j_car):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                       rtol=0)


def _grid_parity(cfg, tcfg, batch, seed):
    rng = np.random.default_rng(seed)
    d = random_states(rng, batch, cfg)
    js = _jstate(d)
    ref = jax.jit(jax.vmap(lambda s: j_grid(s, cfg, jnp.float64)))(js)
    got = t_grid(jax_state_to_torch(js), tcfg, torch.float64)
    np.testing.assert_array_equal(got.obstacles.numpy(),
                                  np.asarray(ref.obstacles))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(ref.distances), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.s_values.numpy(), np.asarray(ref.s_values),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.t_values.numpy(),
                               np.asarray(ref.t_values)[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.ego_speed.numpy(),
                               np.asarray(ref.ego_speed), atol=0)
    return got


@pytest.mark.parametrize("seed", range(2))
def test_grid_narrow_config(seed):
    got = _grid_parity(NARROW, TNARROW, 8, 200 + seed)
    assert got.obstacles.shape == (8, NARROW.num_t, NARROW.num_s)


def test_grid_full_width():
    got = _grid_parity(CFG, TCFG, 2, 300)
    assert got.obstacles.shape == (2, 18, 3001)
    assert got.obstacles.any()
