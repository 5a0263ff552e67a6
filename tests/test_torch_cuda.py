"""The CUDA kernel of the port against its plain version, and the trained
actor and the combined arbiter on the card against the CPU and the dense
twin.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda

Without a card its ``cuda`` tests skip.
"""

import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch.config import Settings
from rl_mpc_lanemerging_torch.ops import st_dp, st_kernel
from rl_mpc_lanemerging_torch.planner.mpc import weights_from_settings

CFG = Settings()
W = weights_from_settings(CFG)
KW = dict(delta_t=0.3, delta_s=0.05, w=W,
          max_offset=st_dp.default_max_offset(CFG.MAX_SPEED, 0.3, 0.05))


def random_grids(seed, batch=128, num_t=8, num_s=301):
    """Moving obstacle bands (as tests/test_pallas.py:random_batch)."""
    rng = np.random.default_rng(seed)
    obst = np.zeros((batch, num_t, num_s), bool)
    dist = np.full((batch, num_t, num_s), 1e10, np.float32)
    cells = np.arange(num_s)
    for b in range(batch):
        for _ in range(rng.integers(0, 3)):
            pos, vel = rng.uniform(0, num_s), rng.uniform(-30, 30)
            half = int(rng.integers(20, 60))
            for t in range(num_t):
                c = int(pos + vel * t)
                lo, hi = max(c - half, 0), max(min(c + half, num_s), 0)
                obst[b, t, lo:hi] = True
                gap = np.minimum(np.abs(cells - (c - half)),
                                 np.abs(cells - (c + half))) * 0.05
                dist[b, t] = np.minimum(dist[b, t], gap)
        dist[b][obst[b]] = 0
    obst[:, :, 0] = False
    s_values = (rng.uniform(-150, 0, (batch, 1))
                + cells[None, :] * 0.05).astype(np.float32)
    v0 = rng.uniform(0, 25, batch).astype(np.float32)
    a0 = rng.uniform(-5, 4, batch).astype(np.float32)
    return obst, s_values, v0, a0, dist


def _tensors(seed, device, batch=128):
    return [torch.as_tensor(x, device=device)
            for x in random_grids(seed, batch)]


def blocked_layer_grids(seed, layer=4, batch=16):
    """Random grids whose even scenarios have every cell of one layer
    blocked: their paths end at the layer before it."""
    obst, s_values, v0, a0, dist = random_grids(seed, batch)
    obst[::2, layer, :] = True
    dist[::2, layer, :] = 0
    return obst, s_values, v0, a0, dist


def test_plain_version_is_per_scenario():
    """One block per scenario on the card: a scenario's path must not depend
    on the rest of the batch."""
    args = _tensors(3, "cpu")
    whole = st_kernel.st_wavefront_reference(*args, **KW)
    part = st_kernel.st_wavefront_reference(*(x[40:47] for x in args), **KW)
    torch.testing.assert_close(part, whole[40:47], rtol=0, atol=0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_kernel_matches_plain_version_on_card(seed):
    _need_card()
    args = _tensors(seed, "cuda")
    before = st_kernel.launches
    got = st_kernel.st_wavefront(*args, **KW)
    torch.cuda.synchronize()
    assert st_kernel.launches == before + 1
    ref = st_kernel.st_wavefront_reference(*args, **KW)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 7])
def test_kernel_matches_plain_version_on_card_small_batch(batch):
    _need_card()
    args = _tensors(5, "cuda", batch)
    got = st_kernel.st_wavefront(*args, **KW)
    ref = st_kernel.st_wavefront_reference(*args, **KW)
    assert got.shape == (batch, 8)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card_blocked_layer():
    _need_card()
    args = [torch.as_tensor(x, device="cuda") for x in blocked_layer_grids(6)]
    got = st_kernel.st_wavefront(*args, **KW).cpu().numpy()
    ref = st_kernel.st_wavefront_reference(*args, **KW).cpu().numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.all(got[::2, 4:] == 0.0)


@pytest.mark.cuda
def test_kernel_on_unaligned_views_and_counts_its_pairs_on_card():
    """Slices of a larger batch start at addresses that are not multiples
    of 4 bytes (rows of 301 obstacle bytes); the counter receives the pairs
    the plain banded version counts."""
    _need_card()
    args = _tensors(2, "cuda")
    part = [x[3:10] for x in args]
    visited = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = st_kernel.st_wavefront(*part, **KW, visited=visited)
    ref = st_kernel.st_wavefront_reference(*args, **KW)[3:10]
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    v0, a0, s_pad, d_pad = st_kernel._shapes_and_start(
        part[0], part[2], part[3], KW["max_offset"])
    work = []
    st_kernel._wavefront_tables_banded(
        st_kernel.fold_penalty(part[0], part[4], W, s_pad), v0, a0,
        st_kernel._kernel_constants(0.3, 0.05, W), part[0].shape[2], d_pad,
        work=work)
    assert int(visited.item()) == sum(p for p, _, _ in work) > 0


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    obst, sv, v0, a0, dist = _tensors(0, "cuda")
    with pytest.raises(ValueError, match="bool"):
        st_kernel.st_wavefront(obst.float(), sv, v0, a0, dist, **KW)
    with pytest.raises(ValueError, match="shape"):
        st_kernel.st_wavefront(obst, sv[:, :-1], v0, a0, dist, **KW)
    with pytest.raises(ValueError, match="on cpu"):
        st_kernel.st_wavefront(obst, sv, v0.cpu(), a0, dist, **KW)


# ---------------------------------------------------------------------------
# the trained actor and the combined arbiter on the card
# ---------------------------------------------------------------------------

def sensed_states(seed, batch, device, slots=32):
    """Merge-region states (float32): an ego on the ramp or the lane and up
    to 11 cars around it, sorted front to back, absent slots at -inf."""
    from rl_mpc_lanemerging_torch.prediction import HighwayState
    rng = np.random.default_rng(seed)
    ox = np.full((batch, slots), -np.inf, np.float32)
    ov = np.zeros((batch, slots), np.float32)
    oa = np.zeros((batch, slots), np.float32)
    ego_x = rng.uniform(-120, 40, batch).astype(np.float32)
    ego_y = np.where(ego_x > 1.5, -1.5,
                     rng.uniform(-4, 6, batch)).astype(np.float32)
    for b in range(batch):
        n = int(rng.integers(0, 12))
        ox[b, :n] = np.sort(ego_x[b] + rng.uniform(-80, 80, n))[::-1]
        ov[b, :n] = rng.uniform(0, 12, n)
        oa[b, :n] = rng.uniform(-3, 2, n)
    fields = (ego_x, ego_y, rng.uniform(0, 20, batch).astype(np.float32),
              rng.uniform(-4, 3, batch).astype(np.float32), ox, ov, oa,
              np.isfinite(ox))
    return HighwayState(*(torch.as_tensor(x, device=device) for x in fields))


def _policies(cfg):
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    return [ddpg.actor_jerk(load_actor(
        "runs/ddpg_default1_extended", dev, cfg.MINIMUM_NEGATIVE_JERK,
        cfg.MAXIMUM_POSITIVE_JERK), cfg) for dev in ("cuda", "cpu")]


@pytest.mark.cuda
def test_actor_on_card_matches_cpu():
    """Observation flags identical, jerk within 1e-5 (true fp32 products on
    both sides; the sums run in another order)."""
    _need_card()
    from rl_mpc_lanemerging_torch._device import pin_fp32_matmul
    from rl_mpc_lanemerging_torch.rl.obs import state_vector
    pin_fp32_matmul()
    on_card, on_cpu = _policies(CFG)
    states = sensed_states(0, 128, "cpu")
    states_card = type(states)(*(x.cuda() for x in states))
    obs, obs_card = state_vector(states, CFG), state_vector(states_card, CFG)
    assert torch.equal(obs[:, 3:16:4], obs_card[:, 3:16:4].cpu())
    torch.testing.assert_close(obs_card.cpu(), obs, rtol=0, atol=1e-6)
    torch.testing.assert_close(on_card(states_card).cpu(), on_cpu(states),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("strictly_better", [False, True])
def test_arbiter_with_kernel_matches_dense_twin_on_card(strictly_better):
    """``combined_controller`` on a narrowed grid (15 m, 301 cells), kernel
    against dense twin, both on the card: the two solvers may settle an f32
    near-tie differently (the bar the kernel holds against the dense twin
    is 97% of first steps), so takeover flags agree on >= 97% of 128 states
    and so do the speeds, within 1e-3 m/s."""
    _need_card()
    from rl_mpc_lanemerging_torch.agents import combined
    cfg = CFG.replace(FUTURE_S=15.0, TEST_ROLLOUT_STATE=True,
                      CHECK_ROLLOUT_CRASH=True, COMBINATION_MIN_DISTANCE=5.1,
                      TEST_ST_STRICTLY_BETTER=strictly_better)
    policy, _ = _policies(cfg)
    states = sensed_states(1, 128, "cuda")
    before = st_kernel.launches
    with_kernel, _, _ = combined.combined_controller(policy, cfg,
                                                     use_kernel=True)
    with_dense, _, _ = combined.combined_controller(policy, cfg,
                                                    use_kernel=False)
    speed_k, take_k = with_kernel(states)
    assert st_kernel.launches == before + 2
    speed_d, take_d = with_dense(states)
    assert st_kernel.launches == before + 2
    same = take_k == take_d
    assert float(same.float().mean()) >= 0.97
    assert 0.0 < float(take_k.mean()) < 1.0
    assert torch.isfinite(speed_k).all()
    close = (speed_k - speed_d).abs() <= 1e-3
    assert float((same & close).float().mean()) >= 0.97


# ---------------------------------------------------------------------------
# the training path on the card
# ---------------------------------------------------------------------------

def _env_pair(batch=64, warm_ticks=150):
    """The same env state on the CPU and on the card (float32): traffic
    after ``warm_ticks`` of warmup, every scenario at another phase of its
    episode (in warmup, about to spawn, driving)."""
    from rl_mpc_lanemerging_torch.envs import merge_env
    from rl_mpc_lanemerging_torch.sim import CounterRandom, init_world, warmup
    rng = CounterRandom(3)
    world = warmup(init_world(CFG, batch, torch.float32, "cpu"), CFG,
                   warm_ticks, rng)
    env = merge_env.env_reset(world, CFG)
    env = env._replace(warmup_left=torch.arange(batch, dtype=torch.int32)
                       % 4)
    jerk = torch.as_tensor(np.random.default_rng(0).uniform(-5, 5, batch),
                           dtype=torch.float32)
    for _ in range(40):                   # egos spawn and drive
        env, _ = merge_env.env_step(env, jerk, CFG, rng)
    env_card = merge_env.MergeEnvState(*(
        type(x)(*(y.cuda() for y in x)) if isinstance(x, tuple)
        else x.cuda() for x in env))
    return env, env_card, jerk, rng


@pytest.mark.cuda
def test_env_step_on_card_matches_cpu():
    """One env tick from the same state: every flag identical, observations
    and rewards within 1e-4."""
    _need_card()
    from rl_mpc_lanemerging_torch.envs import merge_env
    env, env_card, jerk, rng = _env_pair()
    _, tr = merge_env.env_step(env, jerk, CFG, rng)
    _, tr_card = merge_env.env_step(env_card, jerk.cuda(), CFG, rng)
    for f in ("done", "terminal", "valid", "spawn_now", "collided",
              "arrived"):
        assert torch.equal(tr_card[f].cpu(), tr[f]), f
    for f in ("obs", "next_obs", "reward"):
        torch.testing.assert_close(tr_card[f].cpu(), tr[f], rtol=0,
                                   atol=1e-4)
    assert bool(tr["valid"].any()) and not bool(tr["valid"].all())


@pytest.mark.cuda
def test_ddpg_update_on_card_matches_cpu():
    """One DDPG update from the same nets, Adam states and batch: every
    parameter tensor within 1e-4 of its largest magnitude, the bar of
    chip_smoke.py phase 15 (true fp32 products on both sides; Adam's first
    step moves each weight by about the learning rate whatever the size of
    its gradient, so a gradient near zero can flip its step)."""
    _need_card()
    import copy
    from rl_mpc_lanemerging_torch._device import pin_fp32_matmul
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.models.ddpg import DDPGActor, DDPGCritic
    pin_fp32_matmul()
    g = torch.Generator().manual_seed(0)
    nets = [DDPGActor(generator=g), DDPGCritic(generator=g),
            DDPGActor(generator=g), DDPGCritic(generator=g)]
    sides = []
    for dev in ("cpu", "cuda"):
        a, c, ta, tc = (m.to(dev) for m in copy.deepcopy(nets))
        sides.append((a, c, ta, tc, ddpg._adam(a, 1e-3), ddpg._adam(c, 1e-3)))
    rng = np.random.default_rng(1)
    batch = dict(obs=rng.normal(size=(100, 20)),
                 next_obs=rng.normal(size=(100, 20)),
                 action=rng.uniform(-5, 5, 100), reward=rng.normal(size=100),
                 terminal=rng.uniform(size=100) < 0.2)
    for side, dev in zip(sides, ("cpu", "cuda")):
        ddpg._update(*side, {k: torch.as_tensor(
            v, dtype=torch.bool if v.dtype == bool else torch.float32,
            device=dev) for k, v in batch.items()})
    for m_cpu, m_card in zip(sides[0][:4], sides[1][:4]):
        for p_cpu, p_card in zip(m_cpu.parameters(), m_card.parameters()):
            gap = (p_card.detach().cpu() - p_cpu.detach()).abs().max()
            assert float(gap) <= 1e-4 * float(p_cpu.detach().abs().max())


# ---------------------------------------------------------------------------
# the planner's conditional form, the custom DQN and the tabular fold
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_conditional_st_on_card_launches_the_kernel_twice():
    """``batched_conditional_st`` on the card (kernel) against the CPU
    (dense twin) on a narrowed grid: exactly 2 kernel launches per call,
    takeover flags agree on >= 97% of 128 states."""
    _need_card()
    from rl_mpc_lanemerging_torch._device import pin_fp32_matmul
    from rl_mpc_lanemerging_torch.planner import mpc
    pin_fp32_matmul()
    cfg = CFG.replace(FUTURE_S=15.0)
    states = sensed_states(2, 128, "cpu")
    proposed = states.ego_speed + torch.as_tensor(
        np.random.default_rng(2).uniform(-3, 6, 128), dtype=torch.float32)
    card = type(states)(*(x.cuda() for x in states))
    before = st_kernel.launches
    speed_k, take_k = mpc.batched_conditional_st(card, proposed.cuda(), cfg)
    assert st_kernel.launches == before + 2
    speed_d, take_d = mpc.batched_conditional_st(states, proposed, cfg)
    assert st_kernel.launches == before + 2
    same = take_k.cpu() == take_d
    assert float(same.float().mean()) >= 0.97
    assert 0.0 < float(take_d.float().mean()) < 1.0
    assert torch.isfinite(speed_k).all()


@pytest.mark.cuda
def test_dqn_forward_on_card_matches_cpu():
    """The converted dqn_custom_default1 net: identical greedy actions on
    128 states, Q values (up to ~40 in size) within 1e-5 + 1e-5 |Q| (true
    fp32 products on both sides; 256-term sums in another order)."""
    _need_card()
    from rl_mpc_lanemerging_torch._device import pin_fp32_matmul
    from rl_mpc_lanemerging_torch.checkpoint import load_dqn
    from rl_mpc_lanemerging_torch.rl.obs import state_vector
    pin_fp32_matmul()
    states = sensed_states(4, 128, "cpu")
    obs = state_vector(states, CFG)
    with torch.no_grad():
        q_cpu = load_dqn("runs/dqn_custom_default1", "cpu",
                         committed=True)(obs)
        q_card = load_dqn("runs/dqn_custom_default1", "cuda",
                          committed=True)(obs.cuda()).cpu()
    torch.testing.assert_close(q_card, q_cpu, rtol=1e-5, atol=1e-5)
    assert torch.equal(q_card.argmax(-1), q_cpu.argmax(-1))


@pytest.mark.cuda
def test_tabular_fold_on_card_matches_cpu():
    """The fold of 8 random episodes of 60 steps: Q and visits on the card
    within 1e-6 of the CPU's."""
    _need_card()
    from rl_mpc_lanemerging_torch.rl import tabular
    rng = np.random.default_rng(5)
    states6 = [torch.as_tensor(rng.integers(0, 2, (8, 60)))
               for _ in range(6)]
    actions = torch.as_tensor(rng.integers(0, 5, (8, 60)))
    rewards = torch.as_tensor(rng.normal(0, 2, (8, 60)), dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(8, 60)) < 0.9)
    out = []
    for dev in ("cpu", "cuda"):
        q = tabular.initialize_q(CFG, device=dev)
        visits = tabular.initialize_q(CFG, device=dev)
        tabular.fold_episodes(q, visits, [s.to(dev) for s in states6],
                              actions.to(dev), rewards.to(dev),
                              valid.to(dev), 0.9, 0.1)
        out.append((q.cpu(), visits.cpu()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=1e-6)
    assert torch.equal(out[1][1], out[0][1])


# ---------------------------------------------------------------------------
# the scenario mesh: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

def _qp_parts_against_whole(batch, parts):
    """The QP on the card at ``batch`` scenarios and the same scenarios
    solved as ``parts`` equal batches: (whole, split) smoothed paths."""
    from rl_mpc_lanemerging_torch.ops import qp
    rng = np.random.default_rng(5)
    n = CFG.fine_horizon
    coarse = np.cumsum(rng.uniform(0, 3, (batch, CFG.num_t)), axis=1) \
        + rng.uniform(-150, 0, (batch, 1))
    args = [torch.as_tensor(x, device="cuda") for x in (
        coarse.astype(np.float32), np.full(batch, CFG.num_t, np.int32),
        rng.uniform(0, 25, batch).astype(np.float32),
        rng.uniform(-4, 4, batch).astype(np.float32))]
    op = qp.build_operator(n, CFG.TICK_LENGTH)
    kw = dict(coarse_delta_t=CFG.T_DISCRETIZATION, max_speed=CFG.MAX_SPEED,
              pos_accel=CFG.MAX_POSITIVE_ACCELERATION,
              neg_accel=CFG.MAX_NEGATIVE_ACCELERATION,
              pos_jerk=CFG.MAXIMUM_POSITIVE_JERK,
              neg_jerk=CFG.MINIMUM_NEGATIVE_JERK,
              iterations=CFG.QP_ITERATIONS)
    whole = qp.finer_fit_qp(*args, op, **kw)[0]
    size = batch // parts
    split = torch.cat([qp.finer_fit_qp(*(a[i:i + size] for a in args),
                                       op, **kw)[0]
                       for i in range(0, batch, size)])
    return whole, split


@pytest.mark.cuda
def test_qp_rows_do_not_depend_on_the_batch_size():
    """The QP on the card at B=128 equals, bit for bit, the same scenarios
    solved as two batches of 64 and four of 32 (one scenario per column of
    the ADMM products): a sharded evaluation replays a one-process one."""
    _need_card()
    for parts in (2, 4):
        whole, split = _qp_parts_against_whole(128, parts)
        assert torch.equal(whole, split), parts


@pytest.mark.cuda
@pytest.mark.parametrize("batch, parts", [(256, 2), (512, 4)])
def test_qp_rows_past_128_columns_equal_batches_of_128(batch, parts):
    """The JAX rows' own batches (512, and 256 between): the QP at B equals
    the same scenarios solved as batches of 128, bit for bit."""
    _need_card()
    whole, split = _qp_parts_against_whole(batch, parts)
    gap = float((whole - split).abs().max())
    print(f"QP B={batch} vs {parts} x 128: largest gap {gap:.3g} m, "
          f"{int((whole != split).any(dim=1).sum())} of {batch} paths differ")
    assert torch.equal(whole, split), gap


@pytest.mark.cuda
def test_no_jerk_config_plans_dense_on_card_as_on_cpu():
    """USE_FAST_ST_SOLVER=False on the card: the kernel route plans with the
    no-jerk dense DP (K1 not launched), as on the CPU: >= 97% of 64 paths
    within 1e-3 m (the same DP in float32 on two devices may settle a
    near-tie differently); the jerk-limited plan through K1 differs."""
    _need_card()
    from rl_mpc_lanemerging_torch.planner import mpc
    cfg = CFG.replace(FUTURE_S=15.0, USE_FAST_ST_SOLVER=False)
    states = sensed_states(3, 64, "cpu")
    card = type(states)(*(x.cuda() for x in states))
    before = st_kernel.launches
    seq_k, valid_k, _ = mpc.batched_plan(card, cfg, use_kernel=True)
    assert st_kernel.launches == before
    seq_c, valid_c, _ = mpc.batched_plan(states, cfg, use_kernel=True)
    close = ((seq_k.cpu() - seq_c).abs() <= 1e-3).all(dim=1)
    print(f"no-jerk plans card vs CPU: {int(close.sum())} of 64 within "
          f"1e-3 m, valid lengths equal {bool(torch.equal(valid_k.cpu(), valid_c))}")
    assert float(close.float().mean()) >= 0.97
    jerk_limited = mpc.batched_plan(card, CFG.replace(FUTURE_S=15.0),
                                    use_kernel=True)[0]
    assert st_kernel.launches == before + 1
    assert not torch.equal(seq_k, jerk_limited)


@pytest.mark.cuda
def test_mesh_collectives_on_cuda_tensors():
    """``average_gradients``, ``agree_min`` and ``broadcast_modules`` on
    CUDA tensors, 2 gloo ranks on the one card (its all_reduce and
    broadcast take CUDA tensors; NCCL refuses two ranks on one GPU)."""
    _need_card()
    import _torch_ranks
    from rl_mpc_lanemerging_torch.parallel import sharded
    for out in sharded.spawn(_torch_ranks.card_collectives, 2,
                             backend="gloo", timeout=300):
        assert all(d.startswith("cuda") for d in out["devices"])
        np.testing.assert_array_equal(out["avg"][0], np.full((3, 2), 1.5))
        np.testing.assert_array_equal(out["avg"][1], np.arange(4.0) * 1.5)
        assert out["min"] == 10
        np.testing.assert_array_equal(out["weight"], np.zeros((2, 3)))


@pytest.mark.cuda
def test_per_draws_on_card_do_not_depend_on_the_scan_order():
    """A float32 PER ring's draws on the card: its float64 scan is exact,
    so repeated draws agree and equal those of the same exact scan on the
    CPU."""
    _need_card()
    from rl_mpc_lanemerging_torch.rl import replay as rb
    g = torch.Generator().manual_seed(7)
    ring = rb.init_replay(50000, 20, discrete=True, device="cuda")
    pri = (torch.clamp(torch.rand(ring.capacity, generator=g) * 5, max=4.0)
           + 1e-6) ** 0.5
    ring.priority[:ring.capacity] = pri.cuda()
    u = torch.rand(4096, generator=g)
    draws = [rb.sample(ring, 4096, u=u.cuda())[0].cpu() for _ in range(20)]
    c = torch.cumsum(pri, 0, dtype=torch.float64)
    want = torch.searchsorted(c, u * c[-1], right=True).clamp_(
        0, ring.capacity - 1)
    assert all(torch.equal(d, want) for d in draws)
