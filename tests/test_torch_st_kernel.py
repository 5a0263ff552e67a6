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


def test_launch_refuses_cpu_and_mixed_device_inputs():
    """The launch path refuses CPU inputs, and inputs on two devices,
    before it builds or launches anything."""
    before = st_kernel.launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        st_kernel.prepare_launch(*_torch_inputs(), **KW)
    obst, sv, v0, a0, dist = _torch_inputs()
    with pytest.raises(ValueError,
                       match="ego_speed on cpu, obstacles on meta"):
        st_kernel.st_wavefront(obst.to("meta"), sv.to("meta"), v0,
                               a0.to("meta"), dist.to("meta"), **KW)
    assert st_kernel.launches == before


def test_penalty_fold_marks_obstacles_and_padding():
    obst, _, _, _, dist = _torch_inputs()
    pen = st_kernel.fold_penalty(obst, dist, TW, 320)
    assert pen.shape == (B, T, 320) and pen.dtype == torch.float32
    assert torch.all(pen[..., S:] == st_kernel.BIG)
    assert torch.all(pen[..., :S][obst] == st_kernel.BIG)
    free = ~obst & (dist >= TW.min_allowed_distance)
    assert torch.allclose(pen[..., :S][free],
                          TW.d_weight / dist[free].float())


# --- the kernel's algorithm (integer bands, reachable sources, packed-key
# scatter minimum) in plain torch against the scan; atol 0 throughout, both
# sides being the port's own f32 arithmetic

def _banded(args):
    return st_kernel.st_wavefront_reference(*args, **KW, banded=True).numpy()


def _tables(args, tables_fn, work=None):
    obst, _, v0, a0, dist = args
    v0, a0, s_pad, d_pad = st_kernel._shapes_and_start(obst, v0, a0, MOFF)
    pen = st_kernel.fold_penalty(obst, dist, TW, s_pad)
    consts = st_kernel._kernel_constants(0.3, 0.05, TW)
    return tables_fn(pen, v0, a0, consts, obst.shape[2], d_pad, work=work)


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_sequences_identical_to_scan(seed):
    got = _banded(_torch_inputs(seed))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _plain(seed))


def test_banded_tables_equal_scan_tables_on_reachable_cells():
    args = _torch_inputs(1)
    work_s, work_b = [], []
    bp_s, vmin_s, amin_s = _tables(
        args, st_kernel._wavefront_tables_reference, work_s)
    bp_b, vmin_b, amin_b = _tables(
        args, st_kernel._wavefront_tables_banded, work_b)
    torch.testing.assert_close(vmin_b, vmin_s, rtol=0, atol=0)
    finite = vmin_s < st_kernel.BIG
    assert torch.equal(amin_b[finite], amin_s[finite])
    # a cell no reachable source pushed to keeps bp = j + 1 in the banded
    # tables; every other cell (the reachable ones among them) must agree
    cells = torch.arange(bp_b.shape[2], dtype=torch.int32)
    pushed = bp_b[:, 1:] != cells + 1
    assert pushed.any(dim=2)[:, 0].all()
    assert torch.equal(bp_b[:, 1:][pushed], bp_s[:, 1:][pushed])
    # the pairs the banded sweep visits are the scan's in-band pairs from
    # reachable sources, layer by layer, and so are the reachable cells
    assert [w[:2] for w in work_b] == work_s
    assert all(0 < w[1] <= w[2] for w in work_b[:3])


def test_integer_band_is_the_float_band():
    d_pad = 184
    rng = np.random.default_rng(0)
    xlo = rng.uniform(-20.0, 220.0, 4000).astype(np.float32)
    width = rng.uniform(-3.0, 12.0, 4000).astype(np.float32)
    xhi = xlo + width
    exact = rng.integers(-5, 200, 500).astype(np.float32)
    xlo = np.concatenate([xlo, exact, exact, exact - 0.5,
                          [np.nan, 3.0, -7.0, 190.0, 183.0, 0.0]])
    xhi = np.concatenate([xhi, exact, exact + 2.0, exact + 0.5,
                          [5.0, np.nan, -2.0, 400.0, 183.0, 0.0]])
    lo, hi = st_kernel._integer_band(torch.as_tensor(xlo, dtype=torch.float32),
                                     torch.as_tensor(xhi, dtype=torch.float32),
                                     d_pad)
    d = np.arange(d_pad, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        float_band = (d[None, :] >= xlo[:, None].astype(np.float32)) \
            & (d[None, :] <= xhi[:, None].astype(np.float32))
    int_band = (d[None, :] >= lo.numpy()[:, None]) \
        & (d[None, :] <= hi.numpy()[:, None])
    np.testing.assert_array_equal(int_band, float_band)
    assert float_band.any(axis=1).sum() > 3000
    empty = ~float_band.any(axis=1)
    assert empty.sum() > 100
    assert np.all(lo.numpy()[empty] == 1) and np.all(hi.numpy()[empty] == 0)
    assert lo.max() < 256 and hi.max() < d_pad


def test_packed_key_order_is_cost_then_largest_offset():
    d_pad = 184
    rng = np.random.default_rng(1)
    cost = rng.choice(np.array([0.0, 1e-30, 0.5, 0.5000001, 1.0, 7.25, 1e6,
                                2.9e30, -1.0, -0.25], np.float32), 3000)
    cost[:1000] = rng.uniform(0, 100, 1000).astype(np.float32)
    d = rng.integers(0, d_pad, 3000)
    key = st_kernel._pack_key(torch.as_tensor(cost),
                              torch.as_tensor(d_pad - 1 - d)).numpy()
    assert len(np.unique(key)) == len(set(zip(cost.tolist(), d.tolist())))
    # sorting by key is sorting by (cost ascending, d descending)
    by_key = np.argsort(key, kind="stable")
    by_rule = np.lexsort((-d, cost))
    np.testing.assert_array_equal(cost[by_key], cost[by_rule])
    np.testing.assert_array_equal(d[by_key], d[by_rule])
    least, low = st_kernel._unpack_key(torch.as_tensor(key))
    np.testing.assert_array_equal(least.numpy(), cost)
    np.testing.assert_array_equal(d_pad - 1 - low.numpy(), d)
    assert key.max() < st_kernel._NO_KEY


def _blocked_layer_inputs(layer=3):
    obst, sv, v0, a0, dist = (x.clone() for x in _torch_inputs(1))
    obst[::2, layer, :] = True
    dist[::2, layer, :] = 0
    return obst, sv, v0, a0, dist


@pytest.mark.parametrize("banded", [False, True])
def test_all_blocked_layer_ends_the_path(banded):
    args = _blocked_layer_inputs()
    got = st_kernel.st_wavefront_reference(*args, **KW,
                                           banded=banded).numpy()
    assert np.all(got[::2, 3:] == 0.0)
    np.testing.assert_array_equal(got[::2, 0], args[1][::2, 0].numpy())
    np.testing.assert_array_equal(got[1::2], _plain(1)[1::2])
    if banded:
        np.testing.assert_array_equal(
            got, st_kernel.st_wavefront_reference(*args, **KW).numpy())


@pytest.mark.parametrize("banded", [False, True])
def test_single_scenario_batch(banded):
    args = [x[17:18] for x in _torch_inputs(0)]
    got = st_kernel.st_wavefront_reference(*args, **KW, banded=banded)
    assert got.shape == (1, T)
    np.testing.assert_array_equal(got.numpy(), _plain(0)[17:18])


def test_penalty_fold_written_out_is_the_scalar_division():
    _, _, _, _, dist = _torch_inputs()
    clamped = torch.clamp_min(dist, 1.0)
    assert torch.equal(torch.reciprocal(clamped) * 1e6, 1e6 / clamped)
    far = dist[dist > 0]
    assert torch.equal(torch.reciprocal(far), 1.0 / far)


def test_kernel_constants_carry_the_penalty_weights():
    consts = st_kernel._kernel_constants(0.3, 0.05, TW)
    assert consts.dtype == np.float32
    assert len(consts) == len(st_kernel._CONST_NAMES) == 18
    assert consts[16] == np.float32(TW.d_weight)
    assert consts[17] == np.float32(TW.min_allowed_distance)


def test_every_plain_vs_dense_disagreement_gets_a_class():
    """chip_smoke's sorting of kernel-vs-dense disagreements, run here on
    the random lattices with the plain version in the kernel's place."""
    import chip_smoke
    obst, sv, v0, a0, dist = _torch_inputs()
    tv = torch.arange(T, dtype=torch.float32) * torch.tensor(0.3)
    dense = tdp.solve_st_fast(obst, sv, tv, v0, a0, dist, TW, MOFF)
    got = torch.as_tensor(_plain())
    differ = np.flatnonzero(~np.all(
        np.isclose(got.numpy(), dense.numpy(), atol=1e-3), axis=1))
    assert 0 < len(differ) <= 0.15 * B
    kinds = [chip_smoke.classify_disagreement(
        got[i], dense[i], obst[i], sv[i], dist[i], float(v0[i]),
        float(a0[i]), 0.3, 0.05, TW, MOFF) for i in differ]
    assert {k["kind"] for k in kinds} <= {"equal-cost tie", "f32 flip",
                                          "band edge"}, kinds
    assert all(k["float64_dense_agrees_with"] for k in kinds)
    # a path against itself is a tie, and lies in the kernel's own bands
    full = int(np.flatnonzero(got.numpy()[:, -1] != 0)[0])
    same = chip_smoke.classify_disagreement(
        got[full], got[full], obst[full], sv[full], dist[full],
        float(v0[full]), float(a0[full]), 0.3, 0.05, TW, MOFF)
    assert same["kind"] == "equal-cost tie" and same["layers"] == (T, T)
    assert same["dense_path_in_kernel_bands"]
