"""The obstacle-grid kernel (``ops/grid_kernel.py``, ``csrc/obstacle_grid.cu``)
against the plain path (``planner.grid.build_st_grid_plain``).

On the CPU: the dispatch (CPU tensors and float64 take the plain path and
``grid.path`` records 0), what the wrapper refuses, the kernel's per-slice
reach against the plain path's arithmetic, and a numpy copy of the CUDA
source's algorithm against the plain path bit for bit.  That copy guards
the design and the order of its float operations, not the shipped kernel:
an edit to ``csrc/obstacle_grid.cu`` alone cannot make it fail.  The
kernel itself is checked on the card (``cuda``): against the plain path,
bit for bit, one launch a build, and raising for a grid beyond a block.

This file imports neither JAX nor the JAX package, so that it runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_grid_kernel.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from rl_mpc_lanemerging_torch import tracing
from rl_mpc_lanemerging_torch._device import const
from rl_mpc_lanemerging_torch.config import Settings
from rl_mpc_lanemerging_torch.ops import grid_kernel
from rl_mpc_lanemerging_torch.planner import grid
from rl_mpc_lanemerging_torch.prediction import HighwayState

ST = Settings.load_from_file("configs/st_default.json")
COMBINED = Settings.load_from_file("configs/combined_default_1.json")
NARROW = ST.replace(FUTURE_S=15.0)
UNCERTAIN = NARROW.replace(START_UNCERTAINTY=0.4,
                           UNCERTAINTY_PER_SECOND=0.73)
F = np.float32


def merge_states(seed, batch, slots=32, sort=True):
    """Merge-region states (float32): an ego on the ramp or the lane and up
    to 14 cars around it, front to back (or in random slot order), absent
    slots at -inf."""
    rng = np.random.default_rng(seed)
    ox = np.full((batch, slots), -np.inf, np.float32)
    ov = np.zeros((batch, slots), np.float32)
    ego_x = rng.uniform(-120, 60, batch).astype(np.float32)
    ego_y = np.where(ego_x > 1.5, -1.5,
                     rng.uniform(-4, 6, batch)).astype(np.float32)
    for b in range(batch):
        n = int(rng.integers(0, min(15, slots + 1)))
        x = ego_x[b] + rng.uniform(-80, 120, n)
        x = np.sort(x)[::-1] if sort else x
        ox[b, :n] = x
        ov[b, :n] = rng.uniform(0, 14, n)
        if not sort:
            perm = rng.permutation(slots)
            ox[b], ov[b] = ox[b, perm], ov[b, perm]
    return _state(ego_x, ego_y, rng.uniform(0, 20, batch), ox, ov)


def _state(ego_x, ego_y, ego_v, ox, ov, present=None):
    ox = np.asarray(ox, np.float32)
    fields = (np.asarray(ego_x, np.float32), np.asarray(ego_y, np.float32),
              np.asarray(ego_v, np.float32),
              np.zeros(len(ego_x), np.float32), ox,
              np.asarray(ov, np.float32), np.zeros_like(ox),
              np.isfinite(ox) if present is None else present)
    return HighwayState(*(torch.as_tensor(x) for x in fields))


def edge_states(slots=32):
    """Hand-built cases, one a row: no car; the ego on the ramp before
    s=8 with cars; the ego ahead of every car (case B); every car in
    front (case C2); a car behind the ego (case C1); cars past the
    horizon and behind CRASH_MIN_S - MIN_ALLOWED_DISTANCE; absent slots
    between present ones; slots out of order; slot 0 absent before present
    ones; the ego on merge_point2's x; a queue closing on a stopped
    leader."""
    rows = [
        (-40.0, 3.0, []),
        (-60.0, 4.0, [(-30.0, 9.0), (-70.0, 7.0)]),
        (30.0, -1.5, [(10.0, 8.0), (-5.0, 9.0), (-30.0, 12.0)]),
        (30.0, -1.5, [(90.0, 3.0), (60.0, 8.0), (45.0, 11.0)]),
        (20.0, -1.5, [(50.0, 2.0), (28.0, 7.0), (10.0, 13.0), (-9, 15.0)]),
        (15.0, -1.5, [(300.0, 5.0), (160.0, 6.0), (-45.0, 4.0),
                      (-60.0, 8.0), (-80.0, 8.0)]),
        (10.0, -1.5, [(40.0, 5.0), None, (5.0, 9.0), None, (-20.0, 10.0)]),
        (10.0, -1.5, [(-20.0, 10.0), (40.0, 5.0), (5.0, 9.0), (70.0, 1.0)]),
        (10.0, -1.5, [None, (0.0, 11.0), (-12.0, 12.0)]),
        (1.5, -1.5, [(12.0, 6.0), (-3.0, 8.0)]),
        (-2.0, -1.0, [(8.0, 0.0), (2.0, 14.0), (-4.0, 14.0), (-10.0, 14.0),
                      (-16.0, 14.0)]),
    ]
    n = len(rows)
    ox = np.full((n, slots), -np.inf, np.float32)
    ov = np.zeros((n, slots), np.float32)
    for b, (_, _, cars) in enumerate(rows):
        for k, car in enumerate(cars):
            if car is not None:
                ox[b, k], ov[b, k] = car
    return _state([r[0] for r in rows], [r[1] for r in rows],
                  np.full(n, 9.0), ox, ov)


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 \
        else x


def assert_same_grid(got, want):
    for name in grid.STGrid._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name


# ---------------------------------------------------------------------------
# the CPU: dispatch, reach, and the kernel's algorithm
# ---------------------------------------------------------------------------

def test_grid_path_is_a_registered_counter():
    assert "grid.path" in tracing.COUNTERS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_builds_take_the_plain_path(dtype):
    state = merge_states(0, 6)
    state = HighwayState(*(x.to(dtype) if x.is_floating_point() else x
                           for x in state))
    assert not grid_kernel.supports(state, dtype)
    before = grid_kernel.launches
    tracing.clear()
    tracing.enable()
    try:
        got = grid.build_st_grid(state, NARROW, dtype)
    finally:
        tracing.disable()
    assert grid_kernel.launches == before
    assert [(c.name, c.value) for c in tracing.counts()] \
        == [("grid.path", 0)]
    tracing.clear()
    assert_same_grid(got, grid.build_st_grid_plain(state, NARROW, dtype))


def _swap(state, **fields):
    return state._replace(**fields)


REFUSALS = {
    "cpu": lambda s: (s, torch.float32, None),
    "float64_slots": lambda s: (
        _swap(s, other_x=s.other_x.double()), torch.float32, None),
    "float16_ego": lambda s: (
        _swap(s, ego_x=s.ego_x.half()), torch.float32, None),
    "byte_presence": lambda s: (
        _swap(s, other_present=s.other_present.to(torch.uint8)),
        torch.float32, None),
    "flat_slots": lambda s: (
        _swap(s, other_x=s.other_x[0]), torch.float32, None),
    "short_speeds": lambda s: (
        _swap(s, other_speed=s.other_speed[:, 1:]), torch.float32, None),
    "float64_grid": lambda s: (s, torch.float64, None),
    "short_reach": lambda s: (s, torch.float32, NARROW.num_t - 1),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_prepare_launch_refuses_what_the_kernel_cannot_take(case):
    """The wrapper raises ValueError, before it loads the kernel, for a
    layout, dtype, reach or device the kernel does not take (the CPU last:
    these states lie there)."""
    state, dtype, slices = REFUSALS[case](merge_states(11, 4))
    reach, cells = grid.kernel_reach(NARROW)
    if slices is not None:
        reach, cells = reach[:slices], cells[:slices]
    before = grid_kernel.launches
    with pytest.raises(ValueError, match="obstacle_grid"):
        grid_kernel.prepare_launch(state, NARROW, reach, cells, dtype)
    assert grid_kernel.launches == before


@pytest.mark.parametrize("cfg", [ST, UNCERTAIN], ids=["st", "uncertain"])
def test_kernel_reach_is_the_plain_paths(cfg):
    """The f32 reach the kernel takes equals the plain path's: slice 0 a
    host double as PyTorch rounds a scalar operand, the later slices the f32
    sum of ``const(uncertainty) + CAR_LENGTH``."""
    reach, cells = grid.kernel_reach(cfg)
    unc, plain_cells = grid._slice_reach(cfg)
    assert cells == plain_cells and len(reach) == cfg.num_t
    y = torch.zeros(1, dtype=torch.float32)
    assert float(y - (cfg.CAR_LENGTH + float(unc[0]))) == -float(reach[0])
    like = torch.zeros((), dtype=torch.float32)
    for t in range(1, cfg.num_t):
        assert float(const(float(unc[t]), like) + cfg.CAR_LENGTH) \
            == float(reach[t])
    if cfg is UNCERTAIN:
        assert cells[-1] > cells[0] and reach[-1] > reach[0]


def _sqrt(v):
    """The platform's float32 square root, as the plain path takes it: on
    this CPU ``torch.sqrt`` is not always correctly rounded (AVX-512 gives
    one ulp off on ~0.6% of inputs), where numpy's and the card's are."""
    return F(torch.sqrt(torch.tensor([v], dtype=torch.float32)).item())


def _ego_s(x, y, c):
    dx = x - c["merge_x"]
    dy = y - c["merge_y"]
    d = _sqrt(dx * dx + dy * dy)
    after = (x - c["merge2_x"]) + c["common_s"]
    return -d if x < c["merge_x"] else (d if x < c["merge2_x"] else after)


def _clamp_min(v, lo):
    return v if np.isnan(v) else max(v, lo)


def _roll_step(ex, ey, xs, vs, present, c):
    """csrc/obstacle_grid.cu roll_step in numpy float32 scalars."""
    num_k = len(xs)
    es = _ego_s(ex, ey, c)
    any_present, first_behind, last_present = False, -1, num_k - 1
    for k in range(num_k):
        if not present[k]:
            continue
        any_present, last_present = True, k
        if first_behind < 0 and xs[k] < ex:
            first_behind = k
    any_behind = first_behind >= 0
    front_most_behind = present[0] and xs[0] < ex
    prev_idx = first_behind - 1 if any_behind and first_behind > 0 else 0
    prev_x, prev_speed = xs[prev_idx], vs[prev_idx]
    rear_speed = vs[last_present] if any_present else F(0)
    case_a = es < c["reaction_threshold"] or not any_present
    case_b = not case_a and front_most_behind
    case_c1 = not case_a and not case_b and any_behind
    mx = F(-20) if case_b else (
        (prev_x - c["car_length"]) - F(5) if case_c1 else ex)
    my = F(-10) if case_b else ey
    sel = F(0) if case_a or case_b else (
        prev_speed if case_c1 else rear_speed)
    dx = c["merge2_x"] - mx
    dy = c["merge2_y"] - my
    norm = _sqrt(dx * dx + dy * dy)
    step = sel * c["dt"]
    safe = _clamp_min(norm, F(1e-12))
    pre_x = mx + (step * dx) / safe
    pre_y = _clamp_min(my + (step * dy) / safe, c["highway_y"])
    post_x = mx + sel * c["dt"]
    on_ramp = mx < c["merge2_x"]
    px, py = (pre_x, pre_y) if on_ramp else (post_x, my)
    merged = _ego_s(px, py, c) > c["reaction_threshold"]
    seen, last_x, last_speed = 0, F(np.inf), F(0)
    for k in range(num_k):
        x, speed, p = xs[k], vs[k], bool(present[k])
        behind = x < px
        use_ego = behind and seen == 0 and merged
        if behind and p:
            seen += 1
        lead_x = px if use_ego else last_x
        lead_speed = sel if use_ego else last_speed
        speed_diff = lead_speed - speed
        reacting = speed_diff < 0 and (lead_x - x) < c["reaction_gap"]
        new_accel = _clamp_min(speed_diff, c["max_decel"]) if reacting \
            else F(0)
        new_speed = speed + new_accel * c["dt"] if reacting else speed
        new_x = x + new_speed * c["dt"]
        last_x = new_x if p else lead_x
        last_speed = new_speed if p else lead_speed
        xs[k] = new_x if p else F(-np.inf)
        vs[k] = new_speed if p else F(0)
    return px, py


def kernel_algorithm(state, cfg):
    """The kernel's algorithm (csrc/obstacle_grid.cu), scenario by scenario
    in numpy float32 scalars; the marking vectorised over a slice's cells.
    Returns (obstacles, distances, s_values, t_values) as numpy."""
    names = ("dt", "ds", "car_length", "min_obstacle_s", "max_decel",
             "reaction_threshold", "reaction_gap", "merge_x", "merge_y",
             "merge2_x", "merge2_y", "merge3_x", "common_s", "highway_y")
    c = dict(zip(names, grid_kernel._constants(cfg)))
    reach, half = grid.kernel_reach(cfg)
    num_t, num_s = cfg.num_t, cfg.num_s
    ego_x, ego_y, _, _, other_x, other_speed, _, other_present = (
        x.numpy() for x in state)
    batch = len(ego_x)
    obst = np.zeros((batch, num_t, num_s), bool)
    dist = np.zeros((batch, num_t, num_s), np.float32)
    s_all = np.zeros((batch, num_s), np.float32)
    j = np.arange(num_s)
    for b in range(batch):
        start_s = _ego_s(ego_x[b], ego_y[b], c)
        s = start_s + j.astype(np.float32) * c["ds"]
        s_all[b] = s
        s_hi = (start_s + F(num_s - 1) * c["ds"]) + c["car_length"]
        xs, vs = other_x[b].copy(), other_speed[b].copy()
        present = other_present[b]
        ex, ey = ego_x[b], ego_y[b]
        for t in range(num_t):
            if t > 0:
                ex, ey = _roll_step(ex, ey, xs, vs, present, c)
            d = np.full(num_s, 1e10, np.float32)
            blocked = np.zeros(num_s, bool)
            for k in range(len(xs)):
                o = xs[k] - c["merge3_x"]
                if present[k] and o >= c["min_obstacle_s"] and o <= s_hi:
                    cell = int(np.trunc((o - start_s) / c["ds"]))
                    d = np.minimum(d, np.abs(np.abs(s - o) - reach[t]))
                    off = j - cell + half[t]
                    blocked |= (off >= 0) & (off < 2 * half[t])
            obst[b, t] = blocked
            dist[b, t] = np.where(blocked, F(0), d)
    t_values = np.arange(num_t).astype(np.float32) * c["dt"]
    return obst, dist, s_all, t_values


@pytest.mark.parametrize("cfg, states", [
    (NARROW, lambda: merge_states(2, 24)),
    (NARROW, lambda: merge_states(3, 24, sort=False)),
    (UNCERTAIN, lambda: merge_states(4, 16)),
    (NARROW, lambda: merge_states(5, 16, slots=48)),
    (NARROW, edge_states),
    (NARROW, lambda: edge_states(48)),
    (ST, lambda: merge_states(6, 3)),
], ids=["narrow", "unsorted", "uncertain", "k48", "edges", "edges_k48",
        "st"])
def test_kernel_algorithm_is_the_plain_path_bit_for_bit(cfg, states):
    """A numpy float32 copy of the CUDA source's statements gives the plain
    path's grid bit for bit: the algorithm, the order of every float
    operation and the constants' rounding.  It checks the copy, not the
    shipped kernel; the ``cuda`` tests below check the kernel."""
    state = states()
    want = grid.build_st_grid_plain(state, cfg)
    with np.errstate(invalid="ignore", over="ignore"):
        obst, dist, s_values, t_values = kernel_algorithm(state, cfg)
    np.testing.assert_array_equal(obst, want.obstacles.numpy())
    np.testing.assert_array_equal(dist.view(np.int32),
                                  want.distances.numpy().view(np.int32))
    np.testing.assert_array_equal(s_values.view(np.int32),
                                  want.s_values.numpy().view(np.int32))
    np.testing.assert_array_equal(t_values.view(np.int32),
                                  want.t_values.numpy().view(np.int32))
    assert want.obstacles.any() and (~want.obstacles).any()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _cuda(state):
    return HighwayState(*(x.cuda() for x in state))


def _kernel_against_plain(state, cfg):
    assert grid_kernel.supports(state, torch.float32)
    before = grid_kernel.launches
    got = grid.build_st_grid(state, cfg)
    assert grid_kernel.launches == before + 1
    want = grid.build_st_grid_plain(state, cfg)
    torch.cuda.synchronize()
    assert_same_grid(got, want)
    return got


def driven_states(cfg, batch, ticks=40, seed=0):
    """Sensed states of ``batch`` worlds of ``cfg`` on the card, ``ticks``
    control ticks after the ego joins at 15 m/s, driven at a steady 9 m/s
    (the merge region: ramp, junction and lane)."""
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, add_ego,
                                              init_world, sense, warmup,
                                              world_step)
    rng = CounterRandom(seed)
    worlds = init_world(cfg, batch, torch.float32, torch.device("cuda"))
    worlds = warmup(worlds, cfg, int(50.0 / cfg.TICK_LENGTH), rng)
    worlds = add_ego(worlds, torch.full((batch,), 15.0, device="cuda"))
    states = []
    for tick in range(ticks):
        sensed = sense(worlds, cfg)
        if tick % 10 == 9:
            states.append(sensed)
        worlds = world_step(worlds, torch.full_like(sensed.ego_speed, 9.0),
                            cfg, rng)
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4096, 1, 7])
def test_kernel_is_plain_path_on_sensed_states_on_card(batch):
    _need_card()
    for cfg in (ST, COMBINED):
        for state in driven_states(cfg, batch):
            g = _kernel_against_plain(state, cfg)
        if batch == 4096:
            assert g.obstacles.any() and int(state.other_present.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4096, 7])
def test_kernel_is_plain_path_on_rollout_test_states_on_card(batch):
    """The arbiter's second plan: the state its virtual rollout reaches."""
    _need_card()
    from rl_mpc_lanemerging_torch.agents import combined, ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    policy = ddpg.actor_jerk(load_actor(
        COMBINED.MODEL_NAME, "cuda", COMBINED.MINIMUM_NEGATIVE_JERK,
        COMBINED.MAXIMUM_POSITIVE_JERK, committed=True), COMBINED)
    for sensed in driven_states(COMBINED, batch, seed=1):
        test_state = combined._rl_rollout(policy, sensed, policy(sensed),
                                          COMBINED)[4]
        _kernel_against_plain(test_state, COMBINED)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [32, 48])
@pytest.mark.parametrize("cfg", [ST, NARROW, UNCERTAIN],
                         ids=["st", "narrow", "uncertain"])
def test_kernel_is_plain_path_on_edge_and_random_states_on_card(cfg, slots):
    _need_card()
    _kernel_against_plain(_cuda(edge_states(slots)), cfg)
    _kernel_against_plain(_cuda(merge_states(7, 512, slots)), cfg)
    _kernel_against_plain(_cuda(merge_states(8, 256, slots, sort=False)),
                          cfg)


@pytest.mark.cuda
def test_kernel_launches_once_a_build_and_float64_stays_plain_on_card():
    _need_card()
    state = _cuda(merge_states(9, 64))
    before = grid_kernel.launches
    tracing.clear()
    tracing.enable()
    try:
        for _ in range(3):
            grid.build_st_grid(state, NARROW)
        grid.build_st_grid(state, NARROW, torch.float64)
        wide = HighwayState(*(x.double() if x.is_floating_point() else x
                              for x in state))
        grid.build_st_grid(wide, NARROW, torch.float64)
    finally:
        tracing.disable()
    assert grid_kernel.launches == before + 3
    assert [c.value for c in tracing.counts() if c.name == "grid.path"] \
        == [1, 1, 1, 0, 0]
    tracing.clear()


def _with_slices(cfg, num_t):
    """``cfg`` with a horizon of exactly ``num_t`` slices."""
    out = cfg.replace(FUTURE_T=(num_t - 1.5) * cfg.T_DISCRETIZATION)
    assert out.num_t == num_t
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("num_t, num_k, ok", [
    (18, 32, True), (18, 48, True), (1, 1, True), (64, 32, True),
    (18, 320, True), (65, 32, False), (18, 321, False), (18, 0, False),
    (18, 400, False)])
def test_what_fits_a_block(num_t, num_k, ok):
    """A grid within one block (T <= 64, K >= 1, the lists within 48 KB of
    shared memory) is built by the kernel bit for bit; one beyond it raises
    on the card, with no launch and no fall back to the plain path."""
    _need_card()
    cfg = _with_slices(NARROW, num_t)
    state = _cuda(merge_states(10, 16, slots=num_k))
    if ok:
        _kernel_against_plain(state, cfg)
        return
    before = grid_kernel.launches
    with pytest.raises(ValueError, match="exceeds one block"):
        grid.build_st_grid(state, cfg)
    assert grid_kernel.launches == before
