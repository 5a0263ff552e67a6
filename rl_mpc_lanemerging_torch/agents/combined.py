"""Combined RL+MPC arbiter, the paper's core contribution.

Port of ``rl_mpc_lanemerging_tpu/agents/combined.py`` (reference
``RLAgent.do_combined_control``, dqn.py:117-200).  Per tick and per
scenario:

1. roll the RL policy forward ROLLOUT_LENGTH virtual steps through the
   forecaster (re-querying the policy each step, dqn.py:129-141), stopping
   on a predicted crash or past STOP_X;
2. the MPC takes over when any enabled gate fires:
   a. the rollout predicts a crash (CHECK_ROLLOUT_CRASH, dqn.py:144-147),
   b. the RL exceeds the desired speed (LIMIT_DQN_SPEED, dqn.py:148-151),
   c. the safety certificate condemns the step-ST_TEST_ROLLOUTS rollout
      state (TEST_ROLLOUT_STATE, dqn.py:152-155),
   d. the ST path is strictly better: lower mean |jerk| AND more progress
      over the common horizon, or the RL made no progress
      (TEST_ST_STRICTLY_BETTER, dqn.py:156-197);
3. otherwise the RL's first action executes through set_ego_jerk.

One ST solve from the sensed state serves both gate d and the takeover
command, and one solve from the rollout test state serves gate c; the gates
evaluate branchlessly across the batch, with no host synchronisation, and
the command is a ``torch.where`` select.  Both solves go through
``mpc.batched_st_control`` / ``mpc.batched_test_guaranteed_crash``: the CUDA
kernel when the states lie on the card, the dense DP on the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import geometry, tracing
from .._device import const, pin_fp32_matmul
from ..config import Settings
from ..planner import mpc
from ..prediction import HighwayState, predict_step_with_ego

__all__ = ["combined_controller", "arbitrate", "Decision",
           "path_mean_abs_jerk"]

Policy = Callable[[HighwayState], torch.Tensor]


def _speed_from_jerk(v, a, jerk, cfg: Settings):
    """control.py:160-171 integrator."""
    new_a = torch.clamp(a + jerk * cfg.TICK_LENGTH,
                        cfg.MAX_NEGATIVE_ACCELERATION,
                        cfg.MAX_POSITIVE_ACCELERATION)
    return torch.clamp(v + new_a * cfg.TICK_LENGTH, 0.0, cfg.MAX_SPEED)


def path_mean_abs_jerk(seq, length, v0, a0, delta_t):
    """Masked mean |jerk| along the first ``length`` (B,) points of each
    path of ``seq`` (B, n) (reference st.py:274-288): jerks from
    consecutive differences seeded with the measured v0 / a0 (B,)."""
    n = seq.shape[1]
    dt = const(delta_t, seq)
    v = torch.diff(seq, dim=1) / dt                          # (B, n-1)
    a = (v - torch.cat([v0[:, None], v[:, :-1]], dim=1)) / dt
    j = (a - torch.cat([a0[:, None], a[:, :-1]], dim=1)) / dt
    steps = torch.arange(1, n, device=seq.device)
    mask = steps[None, :] <= (length[:, None] - 1)
    total = torch.sum(torch.where(mask, torch.abs(j), 0.0), dim=1)
    return total / torch.clamp_min(length - 1, 1)


def _rl_rollout(policy: Policy, states: HighwayState, first_jerk,
                cfg: Settings):
    """Virtual rollout (dqn.py:129-141) with per-scenario freezing: a fixed
    loop of ROLLOUT_LENGTH steps in which a scenario that has crashed or
    passed STOP_X keeps its state.  Returns (s_history (B, R+1),
    rollout_len (B,), crash (B,), last_selected_speed (B,), test_state)."""
    rollouts = max(cfg.ROLLOUT_LENGTH, 1)
    b = states.ego_speed.shape[0]
    device = states.ego_speed.device
    s0 = geometry.get_ego_s(states.ego_x, states.ego_y)

    st = states
    stopped = torch.zeros((b,), dtype=torch.bool, device=device)
    crash = torch.zeros((b,), dtype=torch.bool, device=device)
    sel_speed = torch.zeros_like(states.ego_speed)
    test_st = states
    jerk = first_jerk
    emitted = [s0]
    valid = [torch.ones((b,), dtype=torch.bool, device=device)]

    for i in range(1, rollouts + 1):
        if i != 1:
            with tracing.span("combined.actor"):
                jerk = policy(st)                  # re-query (dqn.py:131-132)
        sel = _speed_from_jerk(st.ego_speed, st.ego_accel, jerk, cfg)
        nxt, crashed_now = predict_step_with_ego(
            st, sel, cfg.TICK_LENGTH, cfg, cfg.COMBINATION_MIN_DISTANCE)
        # freeze scenarios that already stopped
        nxt = HighwayState(*(
            torch.where(stopped.reshape((b,) + (1,) * (new.dim() - 1)),
                        old, new) for new, old in zip(nxt, st)))
        sel_speed = torch.where(stopped, sel_speed, sel)
        crash = crash | (~stopped & crashed_now)
        emitted.append(geometry.get_ego_s(nxt.ego_x, nxt.ego_y))
        valid.append(~stopped)
        if i == cfg.ST_TEST_ROLLOUTS:
            # frozen scenarios carry their final state through, matching
            # the reference's "last state" fallback (dqn.py:142-143)
            test_st = nxt
        stopped = stopped | crash | (nxt.ego_x > cfg.STOP_X)
        st = nxt

    if cfg.ST_TEST_ROLLOUTS > rollouts or cfg.ST_TEST_ROLLOUTS < 1:
        test_st = st

    s_hist = torch.stack(emitted, dim=1)           # (B, R+1)
    valid_m = torch.stack(valid, dim=1)
    rollout_len = valid_m.sum(dim=1)               # recorded points
    s_hist = torch.where(valid_m, s_hist, 0.0)
    return s_hist, rollout_len, crash, sel_speed, test_st


class Decision(NamedTuple):
    """One tick's arbitration, every field (B,).  A gate that the settings
    switch off reads False everywhere."""

    speed: torch.Tensor         # the executed command
    take: torch.Tensor          # bool: the MPC took over
    crash_pred: torch.Tensor    # gate a
    over_speed: torch.Tensor    # gate b
    condemned: torch.Tensor     # gate c
    st_better: torch.Tensor     # gate d
    st_speed: torch.Tensor
    rl_speed: torch.Tensor


def arbitrate(policy: Policy, states: HighwayState, cfg: Settings,
              last_take: Optional[torch.Tensor] = None,
              dtype=torch.float32,
              use_kernel: Optional[bool] = None) -> Decision:
    """One tick of the arbiter for a batch of sensed states.  ``last_take``
    is last tick's takeover flags, read only under
    REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED."""
    if use_kernel is None:
        use_kernel = states.ego_x.is_cuda
    with tracing.span("combined.actor"):
        first_jerk = policy(states)
    v = states.ego_speed.to(dtype)
    a = states.ego_accel.to(dtype)

    with tracing.span("combined.rollout"):
        s_hist, rollout_len, crash_pred, sel_speed, test_state = \
            _rl_rollout(policy, states, first_jerk, cfg)

    # --- ST solve shared by gate d and the takeover command ---
    with tracing.span("controller.plan"):
        st_speed, _seq, _valid, fine, fine_len, _grids = \
            mpc.batched_st_control(states, cfg, dtype, use_kernel)

    # --- gates ---
    off = torch.zeros_like(crash_pred)
    gate_a = crash_pred if cfg.CHECK_ROLLOUT_CRASH else off
    gate_b = sel_speed > cfg.DESIRED_SPEED if cfg.LIMIT_DQN_SPEED else off
    gate_c = off
    if cfg.TEST_ROLLOUT_STATE:
        with tracing.span("controller.certificate"):
            gate_c = mpc.batched_test_guaranteed_crash(
                test_state, cfg, dtype, use_kernel)
    take = gate_a | gate_b | gate_c

    rl_speed = _speed_from_jerk(v, a, first_jerk.to(dtype), cfg)

    gate_d = off
    if cfg.TEST_ST_STRICTLY_BETTER:
        min_len = torch.minimum(fine_len, rollout_len)
        st_jerk = path_mean_abs_jerk(fine, min_len, v, a, cfg.TICK_LENGTH)
        rl_jerk = path_mean_abs_jerk(s_hist, min_len, v, a, cfg.TICK_LENGTH)
        idxs = torch.clamp_min(min_len - 1, 0).to(torch.int64)[:, None]
        st_dist = torch.gather(fine, 1, idxs)[:, 0] - fine[:, 0]
        rl_dist = torch.gather(s_hist, 1, idxs)[:, 0] - s_hist[:, 0]
        st_better = ((st_jerk < rl_jerk) & (st_dist > rl_dist)) \
            | (rl_dist == 0.0)
        if cfg.REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED:
            # hysteresis (dqn.py:176-197): after an ST tick, ST keeps
            # control unless RL is strictly better on BOTH criteria
            rl_better = (rl_jerk < st_jerk) & (rl_dist > st_dist)
            st_better = torch.where(last_take, ~rl_better, st_better)
        # degenerate smoothed path -> stick with RL (dqn.py:166-169)
        gate_d = st_better & (fine_len > 1)
        take = take | (~take & gate_d)

    speed = torch.where(take, st_speed, rl_speed)
    return Decision(speed.to(states.ego_speed.dtype), take, gate_a, gate_b,
                    gate_c, gate_d, st_speed, rl_speed)


def combined_controller(policy: Policy, cfg: Settings, dtype=torch.float32,
                        use_kernel: Optional[bool] = None):
    """Build (controller, init_carry, batch_stats_fn).

    ``controller``: batched HighwayState -> (speed commands, takeover flag);
    the flag feeds the percent-ST statistic (reference dqn.py:101-115).
    With REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED the controller is
    stateful (carry = last tick's takeover flags, the vectorized
    ``takeover_history[-1]`` of reference dqn.py:126-127) and called as
    ``controller(states, carry)``; ``init_carry(batch, device)`` builds the
    initial carry, or is None for the stateless form.
    ``batch_stats_fn``: EpisodeStats -> custom stat dict for aggregation.

    ``use_kernel`` selects the ST solver of the 2 solves per tick; None
    takes the CUDA kernel when the states lie on the card and the dense DP
    when they lie on the CPU (as ``mpc.make_batched_controller`` does).
    Matrix products are pinned to true fp32.
    """
    pin_fp32_matmul()

    if cfg.REMEMBER_LAST_CHOICE_FOR_SWITCHING_COMBINED:
        def control(states: HighwayState, carry):
            with tracing.span("combined.arbitrate"):
                d = arbitrate(policy, states, cfg, carry, dtype, use_kernel)
            return (d.speed, d.take.to(torch.float32)), d.take

        def init_carry(batch: int, device="cpu"):
            return torch.zeros((batch,), dtype=torch.bool, device=device)
    else:
        def control(states: HighwayState):
            with tracing.span("combined.arbitrate"):
                d = arbitrate(policy, states, cfg, None, dtype, use_kernel)
            return d.speed, d.take.to(torch.float32)

        init_carry = None

    def batch_stats(stats) -> Dict[str, np.ndarray]:
        ticks = np.maximum(stats.ticks.cpu().numpy(), 1)
        return {"percent st solver": stats.aux_sum.cpu().numpy() / ticks}

    return control, init_carry, batch_stats
