"""Crash forensics: capture, dump, and offline replay of crashing episodes.

Port of ``rl_mpc_lanemerging_tpu/forensics.py``.  Crashing episodes pickle
their full state history (reference stats.py:75-77), and ``replay_crash``
re-solves the planner from every saved state and renders the s-t
obstacle/path plots (reference st.py:827-859 ``replay_crash`` /
``plot_crash``).

The history is recorded on the device as a (B, T, ...) ``HighwayState``
(``sim.episode.run_episode_batch(record_history=True)``); the crashing
scenarios are copied to the host and written as one pickle per crash, a
list of per-tick ``HighwayState``s with numpy leaves.

The work is split from the drawing: ``replan`` re-solves a list of states
and ``rollout_plans`` computes the policy rollouts and their plans, with
torch alone; ``plot_crash`` and ``plot_rollouts`` draw them with
matplotlib, and log and return ``[]`` where matplotlib is not installed.
The re-solves run the dense DP, as the JAX package's do, so they never
launch the kernel.  Like every entry point of the port, they run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ._device import resolve_device
from .config import Settings
from .prediction import HighwayState

__all__ = ["extract_crash_histories", "dump_crashes", "load_crash",
           "Replanned", "replan", "replay_crash", "plot_crash",
           "rollout_plans", "plot_rollouts"]

logger = logging.getLogger(__name__)

# states re-solved per dense-DP call in ``replan``
REPLAN_CHUNK = 32


def extract_crash_histories(stats, history: HighwayState
                            ) -> List[List[HighwayState]]:
    """Slice the crashing scenarios' state sequences out of a batched
    history.  Returns a list (one per crash) of per-tick HighwayStates
    (numpy leaves), trimmed to the episode's tick count.  Only the crashing
    rows leave the device."""
    rows = torch.nonzero(stats.crashed)[:, 0]
    ticks = stats.ticks[rows].cpu().numpy()
    hist_np = [x[rows].cpu().numpy() for x in history]
    return [[HighwayState(*(leaf[k, t] for leaf in hist_np))
             for t in range(int(n))] for k, n in enumerate(ticks)]


def dump_crashes(stats, history: HighwayState, run_dir: str = ".",
                 tag: str = "") -> List[str]:
    """Pickle each crashing episode's state history (reference
    stats.py:75-77 ``crashed_state_history.pkl``; one file per crash, since
    a batch can hold several).  ``tag`` keeps successive rounds' dumps
    apart."""
    paths = []
    os.makedirs(run_dir, exist_ok=True)
    for i, states in enumerate(extract_crash_histories(stats, history)):
        path = os.path.join(run_dir, f"crashed_state_history_{tag}{i}.pkl")
        with open(path, "wb") as fh:
            pickle.dump(states, fh)
        logger.warning("Crash captured: %d states -> %s", len(states), path)
        paths.append(path)
    return paths


def load_crash(path: str) -> List[HighwayState]:
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _stack(states: List[HighwayState], device) -> HighwayState:
    return HighwayState(*(torch.as_tensor(np.stack(leaves)).to(device)
                          for leaves in zip(*states)))


class Replanned(NamedTuple):
    """N re-solved plans, on the CPU: what a plot of them needs."""

    seq: torch.Tensor         # (N, T) coarse DP paths, zero-filled tails
    valid: torch.Tensor       # (N,) points before the zero tail
    obstacles: torch.Tensor   # (N, T, S) bool
    s_values: torch.Tensor    # (N, S)
    t_values: torch.Tensor    # (T,)


def _replanned(states: HighwayState, cfg: Settings, dtype) -> Replanned:
    from .planner.mpc import batched_plan
    seq, valid, g = batched_plan(states, cfg, dtype)
    return Replanned(seq.cpu(), valid.cpu(), g.obstacles.cpu(),
                     g.s_values.cpu(), g.t_values.cpu())


def replan(states: List[HighwayState], cfg: Settings, dtype=torch.float64,
           device="cuda") -> Replanned:
    """Re-solve the planner (grid build + dense DP + trim, ``plan_st``)
    from each state, REPLAN_CHUNK states per call on ``device``."""
    dev = resolve_device(device)
    parts = [_replanned(_stack(states[i:i + REPLAN_CHUNK], dev), cfg,
                        dtype)
             for i in range(0, len(states), REPLAN_CHUNK)]
    return Replanned(*(torch.cat([p[k] for p in parts]) for k in range(4)),
                     parts[0].t_values)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _draw_plan(plt, plans: Replanned, i: int, title: Optional[str], path,
               figsize) -> str:
    """Plan i of ``plans``: obstacle cells in blue, the path in red; a
    title gets the plan's completeness appended."""
    seq, s_values = plans.seq[i].numpy(), plans.s_values[i].numpy()
    t_values = plans.t_values.numpy()
    valid = int(plans.valid[i])
    nz_t, nz_s = np.nonzero(plans.obstacles[i].numpy())
    fig, ax = plt.subplots(figsize=figsize)
    ax.scatter(t_values[nz_t], s_values[nz_s], s=1, c="tab:blue")
    ax.plot(t_values[:valid], seq[:valid], c="red")
    ax.set_xlabel("t")
    ax.set_ylabel("s")
    if title:
        ax.set_title(f"{title} "
                     f"({'complete' if valid == len(seq) else 'trimmed'})")
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_crash(states: List[HighwayState], cfg: Settings,
               out_dir: Optional[str] = None, prefix: str = "crash",
               plans=None, device="cuda") -> List[str]:
    """Render the s-t obstacle field with the planned path of each saved
    state (reference st.py:850-859), re-solving in float64 unless ``plans``
    (``replan``'s output) are given.  Returns the written image paths
    (``[]`` without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        logger.warning("matplotlib unavailable; skipping crash plots")
        return []
    out_dir = out_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    if plans is None:
        plans = replan(states, cfg, torch.float64, device)
    written = []
    for i in range(len(states)):
        written.append(_draw_plan(
            plt, plans, i, f"{prefix} state {i}",
            os.path.join(out_dir, f"{prefix}_{i:03d}.png"), (6, 6)))
    return written


def replay_crash(path: str, cfg: Settings, out_dir: Optional[str] = None,
                 device="cuda"):
    """Offline repro harness (reference st.py:827-847): load a crash dump,
    re-solve every state in float64 with the dense DP, report which states
    the solver already declared doomed (no complete horizon path), and
    render the plots.  Returns (doomed flags, written image paths)."""
    states = load_crash(path)
    plans = replan(states, cfg, torch.float64, device)
    doomed = (plans.valid < plans.seq.shape[1]).tolist()
    for i, d in enumerate(doomed):
        if d:
            logger.warning("state %d/%d: solver finds crash inevitable",
                           i, len(states))
    plots = plot_crash(states, cfg, out_dir=out_dir
                       or os.path.dirname(path) or ".", plans=plans)
    return doomed, plots


def rollout_plans(policy, cfg: Settings, num_states: int = 4,
                  warm_ticks: int = 40, device="cuda"):
    """The work behind ``plot_rollouts``: drive a small batch of worlds
    (``max(num_states, 4)``, drawn with ``CounterRandom(SEED)``) into the
    merge region under ``policy`` (HighwayState -> jerk (B,)), roll the
    policy ROLLOUT_LENGTH steps through the forecaster, and re-solve the
    planner (float32, dense DP) from the start state and from each rollout
    state of the first ``num_states`` scenarios.

    Returns (history: list of batched HighwayStates, the start state first;
    crashed (B,) bool: a rollout step predicted a crash; plans: per history
    step, the ``Replanned`` plans of the first ``num_states`` scenarios)."""
    from .agents.combined import _speed_from_jerk
    from .prediction import predict_step_with_ego
    from .sim import CounterRandom, add_ego, init_world, sense, warmup
    from .sim.world import world_step

    device = resolve_device(device)
    b = max(num_states, 4)
    rng = CounterRandom(int(cfg.SEED) if cfg.SEED != "Random" else 0)
    worlds = init_world(cfg, b, torch.float32, device)
    worlds = warmup(worlds, cfg, int(20.0 / cfg.TICK_LENGTH), rng)
    worlds = add_ego(worlds, torch.full((b,), 15.0, device=device))

    def speed(states, jerk):
        return _speed_from_jerk(states.ego_speed, states.ego_accel, jerk,
                                cfg)

    for _ in range(warm_ticks):
        states = sense(worlds, cfg)
        worlds = world_step(worlds, speed(states, policy(states)), cfg, rng)
    states = sense(worlds, cfg)

    history = [states]
    crashed = torch.zeros((b,), dtype=torch.bool, device=states.ego_x.device)
    for _ in range(max(cfg.ROLLOUT_LENGTH, 1)):
        nxt, crash_now = predict_step_with_ego(
            states, speed(states, policy(states)), cfg.TICK_LENGTH, cfg,
            cfg.COMBINATION_MIN_DISTANCE)
        crashed = crashed | crash_now
        history.append(nxt)
        states = nxt
    plans = [_replanned(HighwayState(*(x[:num_states] for x in h)), cfg,
                        torch.float32) for h in history]
    return history, crashed, plans


def plot_rollouts(policy, cfg: Settings, out_dir: str, num_states: int = 4,
                  warm_ticks: int = 40, device="cuda") -> List[str]:
    """Visualize the RL policy's virtual rollouts (reference
    ddpg.py:120-162 ``plot_rollouts``): for each of ``num_states``
    mid-merge states, (a) the predicted car positions per virtual step (red
    ego, green neighbours; reference prediction.py:144-160 ``plot_state``)
    as ``rollout_<j>.png``, and (b) the planner's s-t path re-solved from
    the start state (``st_<j>.png``) and from each rollout state
    (``rollout_st_<j>_<i>.png``).  Returns the written image paths
    (``[]`` without matplotlib)."""
    from .prediction import get_closest_cars

    plt = _pyplot()
    if plt is None:
        logger.warning("matplotlib unavailable; skipping rollout plots")
        return []
    os.makedirs(out_dir, exist_ok=True)
    history, crashed, plans = rollout_plans(policy, cfg, num_states,
                                            warm_ticks, device)
    cars = [tuple(tuple(x.cpu().numpy() for x in car)
                  for car in get_closest_cars(h)) for h in history]
    ego_x = [h.ego_x.cpu().numpy() for h in history]
    crashed = crashed.cpu().numpy()
    written = []
    for j in range(num_states):
        fig, ax = plt.subplots(figsize=(6, 4))
        for i, (front, back) in enumerate(cars):
            ax.scatter(i, float(ego_x[i][j]), color="r", s=14)
            for car in (front, back):
                if bool(car[3][j]):
                    ax.scatter(i, float(car[0][j]), color="g", s=10)
        ax.set_xlabel("rollout step")
        ax.set_ylabel("x (m)")
        ax.set_title(f"policy rollout {j}"
                     + (" [crash predicted]" if bool(crashed[j]) else ""))
        path = os.path.join(out_dir, f"rollout_{j}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)

        # s-t planner view from the start state and each rollout state
        for i, plan in enumerate(plans):
            name = f"st_{j}.png" if i == 0 else f"rollout_st_{j}_{i}.png"
            written.append(_draw_plan(plt, plan, j, None,
                                      os.path.join(out_dir, name), (5, 5)))
    logger.info("Saved %d rollout plots to %s", len(written), out_dir)
    return written
