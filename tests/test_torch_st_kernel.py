"""The port's ST wavefront DP (ops/st_kernel.py): the CUDA kernel's plain
version against the JAX package's Pallas kernel (interpret mode) and against
the port's dense twin, and the wrapper's device dispatch.  The kernel itself
is held against its plain version on the card by tests/test_torch_cuda.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (test-process settings)
from test_pallas import B, S, T, random_batch
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.ops import st_dp as tdp
from rl_mpc_lanemerging_torch.ops import st_kernel
from rl_mpc_lanemerging_torch.planner.mpc import weights_from_settings
from rl_mpc_lanemerging_tpu.ops import st_dp as jdp
from rl_mpc_lanemerging_tpu.ops import st_pallas

TCFG = TSettings()
TW = weights_from_settings(TCFG)
MOFF = tdp.default_max_offset(TCFG.MAX_SPEED, 0.3, 0.05)
KW = dict(delta_t=0.3, delta_s=0.05, w=TW, max_offset=MOFF)


@functools.lru_cache(maxsize=None)
def _inputs(seed=0):
    return random_batch(seed)


def _torch_inputs(seed=0, device="cpu"):
    return [torch.as_tensor(x, device=device) for x in _inputs(seed)]


@functools.lru_cache(maxsize=None)
def _plain(seed=0):
    return st_kernel.st_wavefront_reference(*_torch_inputs(seed),
                                            **KW).numpy()


def _first_steps(seq):
    return seq[:, 1] - seq[:, 0]


def test_kernel_shapes_at_st_default():
    cfg = TSettings.load_from_file("configs/st_default.json")
    moff = tdp.default_max_offset(cfg.MAX_SPEED, cfg.T_DISCRETIZATION,
                                  cfg.S_DISCRETIZATION)
    assert st_kernel.kernel_shapes(cfg.num_s, moff) == (3008, 184)


def test_plain_version_matches_jax_pallas_kernel():
    """Same arithmetic as the JAX kernel: >= 99% of paths identical within
    1e-4, first steps within 0.101 m (f32 rounding may differ between XLA
    and torch on a rare near-tie)."""
    solver = st_pallas.make_pallas_solver(
        0.3, 0.05, jdp.STWeights(*TW), MOFF, T, S, interpret=True)
    obst, sv, v0, a0, dist = _inputs()
    ref = np.asarray(solver(jnp.asarray(obst), jnp.asarray(sv),
                            jnp.asarray(v0), jnp.asarray(a0),
                            jnp.asarray(dist)))
    got = _plain()
    assert got.shape == (B, T) and got.dtype == np.float32
    identical = np.mean(np.all(np.abs(got - ref) <= 1e-4, axis=1))
    assert identical >= 0.99, f"{identical:.2%} paths identical"
    assert np.abs(_first_steps(got) - _first_steps(ref)).max() <= 0.101


def test_plain_version_matches_dense_twin():
    """The JAX package's kernel-vs-dense bars (tests/test_pallas.py)."""
    obst, sv, v0, a0, dist = _torch_inputs()
    tv = torch.arange(T, dtype=torch.float32) * torch.tensor(0.3)
    dense = tdp.solve_st_fast(obst, sv, tv, v0, a0, dist, TW, MOFF).numpy()
    got = _plain()
    step_diff = np.abs(_first_steps(got) - _first_steps(dense))
    assert np.mean(step_diff < 1e-4) >= 0.97
    assert step_diff.max() <= 0.101
    assert np.all(np.isclose(got, dense, atol=1e-3), axis=1).mean() >= 0.85


def test_wrapper_takes_plain_version_on_cpu():
    before = st_kernel.launches
    got = st_kernel.st_wavefront(*_torch_inputs(), **KW)
    assert st_kernel.launches == before
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), _plain())


def test_wrapper_refuses_other_devices():
    meta = [x.to("meta") for x in _torch_inputs()]
    with pytest.raises(ValueError, match="unsupported device"):
        st_kernel.st_wavefront(*meta, **KW)


def test_penalty_fold_marks_obstacles_and_padding():
    obst, _, _, _, dist = _torch_inputs()
    pen = st_kernel.fold_penalty(obst, dist, TW, 320)
    assert pen.shape == (B, T, 320) and pen.dtype == torch.float32
    assert torch.all(pen[..., S:] == st_kernel.BIG)
    assert torch.all(pen[..., :S][obst] == st_kernel.BIG)
    free = ~obst & (dist >= TW.min_allowed_distance)
    assert torch.allclose(pen[..., :S][free],
                          TW.d_weight / dist[free].float())
