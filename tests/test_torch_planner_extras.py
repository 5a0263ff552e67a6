"""The planner's single-scenario, corridor and conditional forms of the port
against the JAX package, in float64 on the CPU at the JAX tests' narrow
settings: ``plan_st`` (paths 1e-9, valid lengths exact), ``
test_guaranteed_crash`` (flags exact), ``corridor_from_state`` (bounds
1e-9, infinities in place), the QP with a corridor (1e-9),
``st_control_speed(use_corridor=True)`` (speed and smoothed path 1e-9),
``path_cost_report`` (costs 1e-9 relative, counts exact) and
``batched_conditional_st`` (flags exact, speeds 1e-9)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_state_to_torch, random_states
from rl_mpc_lanemerging_torch.config import Settings as TSettings
from rl_mpc_lanemerging_torch.ops import qp as tqp
from rl_mpc_lanemerging_torch.planner import mpc as tmpc
from rl_mpc_lanemerging_torch.prediction import HighwayState as THighway
from rl_mpc_lanemerging_tpu.config import Settings
from rl_mpc_lanemerging_tpu.ops import qp as jqp
from rl_mpc_lanemerging_tpu.planner import mpc as jmpc
from rl_mpc_lanemerging_tpu.prediction import HighwayState

NARROW = dict(FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=16, MAX_SENSED_CARS=12,
              QP_ITERATIONS=5)
CFG = Settings().replace(**NARROW)
TCFG = TSettings().replace(**NARROW)
F64 = jnp.float64
N = 16


@functools.lru_cache(maxsize=None)
def _states():
    """16 sensed states (float64) on both sides."""
    d = random_states(np.random.default_rng(11), N, CFG)
    js = HighwayState(**{f: jnp.asarray(v) for f, v in d.items()})
    return js, jax_state_to_torch(js)


def _one(ts, i):
    return THighway(*(x[i] for x in ts))


def _close(got, want, atol=1e-9, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


def test_plan_st_and_certificate_match_jax():
    js, ts = _states()
    jplan = jax.jit(jax.vmap(lambda s: jmpc.plan_st(s, CFG, F64)))(js)
    jcrash = jax.jit(jax.vmap(
        lambda s: jmpc.test_guaranteed_crash(s, CFG, F64)))(js)
    for i in range(N):
        plan = tmpc.plan_st(_one(ts, i), TCFG, torch.float64)
        _close(plan.s_sequence, jplan.s_sequence[i], what=f"path {i}")
        assert int(plan.valid_len) == int(jplan.valid_len[i])
        assert plan.grid.obstacles.shape == (TCFG.num_t, TCFG.num_s)
        np.testing.assert_array_equal(plan.grid.obstacles.numpy(),
                                      np.asarray(jplan.grid.obstacles[i]))
        assert bool(tmpc.test_guaranteed_crash(
            _one(ts, i), TCFG, torch.float64)) == bool(jcrash[i])
    # both kinds of plan and of verdict occur
    valid = np.asarray(jplan.valid_len)
    assert (valid == TCFG.num_t).any() and (valid < TCFG.num_t).any()
    assert 0 < int(np.sum(jcrash)) < N


def test_plan_st_honours_the_no_jerk_solver():
    js, ts = _states()
    cfg, tcfg = (c.replace(USE_FAST_ST_SOLVER=False) for c in (CFG, TCFG))
    want = jax.jit(jax.vmap(lambda s: jmpc.plan_st(s, cfg, F64)))(js)
    for i in range(4):
        plan = tmpc.plan_st(_one(ts, i), tcfg, torch.float64)
        _close(plan.s_sequence, want.s_sequence[i], what=f"path {i}")


def test_batched_plan_through_the_kernel_route_honours_the_no_jerk_solver():
    """USE_FAST_ST_SOLVER=False sends the kernel route (``use_kernel=True``,
    the card's) to the no-jerk DP, as JAX's dense path and the reference
    do: sequences and valid lengths exactly JAX's, and unlike the
    jerk-limited plans on some states."""
    js, ts = _states()
    cfg, tcfg = (c.replace(USE_FAST_ST_SOLVER=False) for c in (CFG, TCFG))
    jseq, jvalid, _ = jax.jit(lambda s: jmpc.batched_plan(s, cfg, F64))(js)
    seq, valid, _ = tmpc.batched_plan(ts, tcfg, torch.float64,
                                      use_kernel=True)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    jerk_limited = tmpc.batched_plan(ts, TCFG, torch.float64)[0]
    assert not torch.equal(seq, jerk_limited)


def test_corridor_from_state_matches_jax():
    js, ts = _states()
    last_s = np.random.default_rng(2).uniform(0.0, 40.0, N)
    jlo, jhi = jax.jit(jax.vmap(
        lambda s, l: jmpc.corridor_from_state(s, l, CFG, F64)))(
        js, jnp.asarray(last_s))
    lo, hi = tmpc.corridor_from_state(ts, torch.as_tensor(last_s), TCFG,
                                      torch.float64)
    for got, want, name in ((lo, jlo, "lo"), (hi, jhi, "hi")):
        want = np.asarray(want)
        assert got.shape == want.shape == (N, TCFG.fine_horizon)
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want),
                                      err_msg=name)
        fin = np.isfinite(want)
        _close(got.numpy()[fin], want[fin], what=name)
    assert np.isfinite(np.asarray(jhi)).any() and np.isinf(
        np.asarray(jhi)).any()
    assert np.isfinite(np.asarray(jlo)).any()


def test_qp_corridor_matches_jax():
    """A coarse path that wants to accelerate through a slow lead car, with
    a trailing car below (infinite early on): the smoothed path and its
    fine length to 1e-9, for a whole and a trimmed coarse path; the
    corridor moves the whole one."""
    n = CFG.fine_horizon
    op = jqp.build_operator(n, CFG.TICK_LENGTH)
    top = tqp.build_operator(n, TCFG.TICK_LENGTH)
    coarse = np.cumsum(np.full(CFG.num_t, 3.0))
    t_fine = np.arange(n) * CFG.TICK_LENGTH
    pos_hi = 12.0 + 2.0 * t_fine - CFG.CAR_LENGTH
    pos_lo = np.where(t_fine < 0.5, -np.inf, -4.0 + 1.0 * t_fine)
    args = (CFG.T_DISCRETIZATION, CFG.MAX_SPEED, CFG.MAX_POSITIVE_ACCELERATION,
            CFG.MAX_NEGATIVE_ACCELERATION, CFG.MAXIMUM_POSITIVE_JERK,
            CFG.MINIMUM_NEGATIVE_JERK)
    for valid in (CFG.num_t, 3):
        want, want_len = jqp.finer_fit_qp(
            jnp.asarray(coarse), jnp.asarray(valid), F64(10.0), F64(0.0), op,
            *args, iterations=200, pos_lo=jnp.asarray(pos_lo),
            pos_hi=jnp.asarray(pos_hi))
        got, got_len = tqp.finer_fit_qp(
            torch.as_tensor(coarse)[None], torch.tensor([valid]),
            torch.tensor([10.0], dtype=torch.float64),
            torch.tensor([0.0], dtype=torch.float64), top, *args,
            iterations=200, pos_lo=torch.as_tensor(pos_lo)[None],
            pos_hi=torch.as_tensor(pos_hi)[None])
        _close(got[0], want, what=f"valid {valid}")
        assert int(got_len[0]) == int(want_len)
        if valid < CFG.num_t:
            continue
        free, _ = tqp.finer_fit_qp(
            torch.as_tensor(coarse)[None], torch.tensor([valid]),
            torch.tensor([10.0], dtype=torch.float64),
            torch.tensor([0.0], dtype=torch.float64), top, *args,
            iterations=200)
        assert float((free - got).abs().max()) > 0.1


@pytest.mark.parametrize("use_corridor", [False, True])
def test_st_control_speed_matches_jax(use_corridor):
    js, ts = _states()
    want = jax.jit(jax.vmap(lambda s: jmpc.st_control_speed(
        s, CFG, F64, use_corridor=use_corridor)))(js)
    for i in range(N):
        speed, plan, fine, fine_len = tmpc.st_control_speed(
            _one(ts, i), TCFG, torch.float64, use_corridor=use_corridor)
        _close(speed, want[0][i], what=f"speed {i}")
        _close(fine, want[2][i], what=f"fine {i}")
        assert int(fine_len) == int(want[3][i])
        assert int(plan.valid_len) == int(want[1].valid_len[i])


def _lattice(rng, n=3001):
    s_values = np.arange(n, dtype=np.float64) * CFG.S_DISCRETIZATION
    distances = rng.uniform(1.0, 50.0, (CFG.num_t, n))
    return s_values, distances


def test_path_cost_report_matches_jax():
    """On-grid paths (every edge cost summed), off-grid ones (inf) and
    paths that break every limit, batched: costs 1e-9 relative, counts
    exact."""
    w = jmpc.weights_from_settings(CFG)
    tw = tmpc.weights_from_settings(TCFG)
    rng = np.random.default_rng(0)
    s_values, distances = _lattice(rng)
    seqs, v0, a0 = [], [], []
    for k in range(8):
        idx = np.cumsum(rng.integers(0, 30 if k < 6 else 400, CFG.num_t))
        seq = idx * CFG.S_DISCRETIZATION
        if k == 5:
            seq = seq + 0.013            # off the lattice
        seqs.append(seq)
        v0.append(rng.uniform(0, 15))
        a0.append(rng.uniform(-2, 2))
    seqs, v0, a0 = np.asarray(seqs), np.asarray(v0), np.asarray(a0)
    jtotal, jrep = jax.jit(jax.vmap(
        lambda s, v, a: jmpc.path_cost_report(
            s, v, a, CFG.T_DISCRETIZATION, jnp.asarray(distances),
            jnp.asarray(s_values), w)))(jnp.asarray(seqs), jnp.asarray(v0),
                                        jnp.asarray(a0))
    total, rep = tmpc.path_cost_report(
        torch.as_tensor(seqs), torch.as_tensor(v0), torch.as_tensor(a0),
        TCFG.T_DISCRETIZATION, torch.as_tensor(distances)[None].expand(
            8, -1, -1), torch.as_tensor(s_values)[None].expand(8, -1), tw)
    jtotal = np.asarray(jtotal)
    np.testing.assert_array_equal(np.isinf(total.numpy()), np.isinf(jtotal))
    fin = np.isfinite(jtotal)
    np.testing.assert_allclose(total.numpy()[fin], jtotal[fin], rtol=1e-9,
                               atol=0)
    for key, counts in jrep.items():
        np.testing.assert_array_equal(rep[key].numpy(), np.asarray(counts),
                                      err_msg=key)
    assert np.isinf(jtotal[5]) and fin.sum() == 7
    assert all(int(np.asarray(jrep[k])[7]) > 0 for k in jrep)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_conditional_st_matches_jax(dtype):
    """Proposed speeds around the current ones: identical takeover flags
    (both kinds occur) and speeds within 1e-9 (float64) / 1e-4 (float32)
    on the dense DP; on the kernel's plain version in float32 the same
    flags."""
    js, ts = _states()
    jd = F64 if dtype == torch.float64 else jnp.float32
    proposed = np.asarray(js.ego_speed) + np.random.default_rng(3).uniform(
        -3, 6, N)
    jspeed, jtake = jax.jit(lambda s, p: jmpc.batched_conditional_st(
        s, p, CFG, jd))(js, jnp.asarray(proposed))
    speed, take = tmpc.batched_conditional_st(ts, torch.as_tensor(proposed),
                                              TCFG, dtype)
    np.testing.assert_array_equal(take.numpy(), np.asarray(jtake))
    _close(speed, jspeed, atol=1e-9 if dtype == torch.float64 else 1e-4)
    assert 0 < int(take.sum()) < N
    if dtype == torch.float32:
        k_speed, k_take = tmpc.batched_conditional_st(
            ts, torch.as_tensor(proposed), TCFG, dtype, use_kernel=True)
        np.testing.assert_array_equal(k_take.numpy(), np.asarray(jtake))
