"""The port's batched ADMM smoother (ops/qp.py) against the JAX package's
``finer_fit_qp`` (float64, atol 1e-8) and against the converged scipy QP in
float32 (first step within 2e-4, path within 5e-3, tests/test_qp.py)."""

import functools

import jax
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (test-process settings)
from test_qp import CDT, CFG, DT, N, feasible_coarse_path, scipy_reference
from rl_mpc_lanemerging_torch.ops import qp as tqp
from rl_mpc_lanemerging_tpu.ops import qp as jqp

BOUNDS = dict(coarse_delta_t=CDT, max_speed=CFG.MAX_SPEED,
              pos_accel=CFG.MAX_POSITIVE_ACCELERATION,
              neg_accel=CFG.MAX_NEGATIVE_ACCELERATION,
              pos_jerk=CFG.MAXIMUM_POSITIVE_JERK,
              neg_jerk=CFG.MINIMUM_NEGATIVE_JERK,
              iterations=CFG.QP_ITERATIONS)


@functools.lru_cache(maxsize=None)
def _jax_fit():
    return jax.jit(jax.vmap(functools.partial(
        jqp.finer_fit_qp, op=jqp.build_operator(N, DT), **BOUNDS)))


def _batch(seed, batch=6):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(0, 25, batch)
    a0 = rng.uniform(-4, 4, batch)
    coarse = np.stack([feasible_coarse_path(rng, v, a)
                       for v, a in zip(v0, a0)])
    coarse = coarse + rng.uniform(-150, 50, (batch, 1))
    valid = np.full(batch, coarse.shape[1], np.int32)
    # trimmed plans: zeros past the last valid coarse point
    valid[::3] = rng.integers(1, coarse.shape[1], len(valid[::3]))
    for b in range(batch):
        coarse[b, valid[b]:] = 0.0
    return coarse, valid, v0, a0


def _port_fit(coarse, valid, v0, a0, dtype):
    t = lambda x: torch.as_tensor(x).to(dtype)  # noqa: E731
    x, fine_len = tqp.finer_fit_qp(
        t(coarse), torch.as_tensor(valid), t(v0), t(a0),
        tqp.build_operator(N, DT), **BOUNDS)
    return x.numpy(), fine_len.numpy()


def test_operator_copy_matches_jax_package():
    got, ref = tqp.build_operator(N, DT), jqp.build_operator(N, DT)
    for f in ("a", "solve", "row_scale", "a_row_sums"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.parametrize("seed", range(3))
def test_qp_matches_jax_float64(seed):
    coarse, valid, v0, a0 = _batch(seed)
    x, fine_len = _port_fit(coarse, valid, v0, a0, torch.float64)
    x_ref, len_ref = _jax_fit()(coarse, valid, v0, a0)
    np.testing.assert_array_equal(fine_len, np.asarray(len_ref))
    np.testing.assert_allclose(x, np.asarray(x_ref), atol=1e-8, rtol=0)


def test_qp_float32_matches_converged_qp():
    rng = np.random.default_rng(42)
    v0 = rng.uniform(0, 25, 2)
    a0 = rng.uniform(-4, 4, 2)
    coarse = np.stack([feasible_coarse_path(rng, v, a)
                       for v, a in zip(v0, a0)])
    valid = np.full(2, coarse.shape[1], np.int32)
    x, fine_len = _port_fit(coarse, valid, v0, a0, torch.float32)
    assert np.all(fine_len == N)
    for b in range(2):
        ref = scipy_reference(coarse[b], v0[b], a0[b])
        assert abs((x[b, 1] - x[b, 0]) - (ref[1] - ref[0])) < 2e-4
        np.testing.assert_allclose(x[b], ref, atol=5e-3)


def test_a_scenario_path_does_not_depend_on_its_batch():
    """The iterates hold one scenario per column, so that a batch split
    over ranks gives each scenario the bits of the whole batch: 8
    scenarios fitted together and as two halves of 4 agree exactly."""
    coarse, valid, v0, a0 = _batch(3, batch=8)
    whole, whole_len = _port_fit(coarse, valid, v0, a0, torch.float32)
    for half in (slice(0, 4), slice(4, 8)):
        part, part_len = _port_fit(coarse[half], valid[half], v0[half],
                                   a0[half], torch.float32)
        assert np.isfinite(part).all()
        np.testing.assert_array_equal(part_len, whole_len[half])
        np.testing.assert_array_equal(part, whole[half])
