"""The system under test: ``rl_mpc_lanemerging_torch``, driven through its
own evaluation entry, ``tasks.evaluate_controller``, with the controller
and arguments its task passes (``tasks.evaluate_st`` for TASK=ST,
``agents.ddpg.evaluate_combined`` for TASK=EVALUATE_COMBINED_DDPG).

This is the one module of the harness that imports the program.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Optional

import torch

from .window import Window, WindowClosed

__all__ = ["Parts", "settings", "build", "warm", "drive", "instrument"]


class Parts(NamedTuple):
    controller: object
    carry: object
    custom_stats: object
    save_state_on_crash: bool


def settings(config: dict, traffic: dict, seed: int):
    """The program's Settings: the configuration as published, the traffic
    mix's scenario count, and the run's seed."""
    from rl_mpc_lanemerging_torch.config import Settings
    return Settings.from_dict({**config["settings"],
                               "BATCH_SCENARIOS": int(traffic["scenarios"]),
                               "SEED": int(seed)})


def build(cfg, device) -> Parts:
    """What the task builds before its rounds: K1 loaded, the controller,
    its carry and its stats."""
    if device.type == "cuda":
        from rl_mpc_lanemerging_torch.ops import st_kernel
        st_kernel.load_kernel()
    # the evaluation entry imports these on its first call (the scenario
    # mesh pulls in torch.distributed.tensor, seconds of import) and the
    # ST task's crash dumps at a round's end: import them here, in set-up
    import rl_mpc_lanemerging_torch.forensics  # noqa: F401
    import rl_mpc_lanemerging_torch.parallel.sharded  # noqa: F401
    if cfg.TASK == "ST":
        from rl_mpc_lanemerging_torch.planner import mpc
        return Parts(mpc.make_batched_controller(cfg), None, None, True)
    if cfg.TASK == "EVALUATE_COMBINED_DDPG":
        from rl_mpc_lanemerging_torch.agents import ddpg
        from rl_mpc_lanemerging_torch.agents.combined import \
            combined_controller
        policy = ddpg.actor_jerk(ddpg._actor_on(cfg, None, device), cfg)
        controller, init_carry, stats = combined_controller(policy, cfg)
        carry = init_carry(cfg.BATCH_SCENARIOS, device) if init_carry \
            else None
        return Parts(controller, carry, stats, False)
    raise ValueError(f"the benchmark drives no TASK={cfg.TASK!r}")


def warm(cfg, parts: Parts, device) -> None:
    """One control tick at the cell's shapes: empty worlds of B scenarios,
    the ego inserted, one world step, one sense, one controller call."""
    from rl_mpc_lanemerging_torch import tasks
    from rl_mpc_lanemerging_torch.sim.world import add_ego, sense, world_step
    worlds, rng = tasks.make_worlds(cfg, cfg.BATCH_SCENARIOS, device=device)
    worlds = add_ego(worlds, torch.full_like(worlds.ego_v, cfg.START_SPEED))
    worlds = world_step(worlds, worlds.ego_v, cfg, rng)
    state = sense(worlds, cfg)
    if parts.carry is not None:
        parts.controller(state, parts.carry)
    else:
        parts.controller(state)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class instrument:
    """Wrappers the window puts on the program while it runs, restored on
    exit: the episode loop's traffic warm-up (marks each round's start) and
    its sensing (the world of the seed-drawn tick, for the check); in the
    arbiter (``arbiter=True``) its plan's speed command and its certificate
    (gate c), noted every tick for the check; and in a traced run the grid
    build, the QP and the K1 entry."""

    def __init__(self, window: Window, arbiter: bool = False):
        self.window = window
        self.arbiter = arbiter
        self._saved = []

    def _patch(self, module, name, new):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    def __enter__(self):
        from rl_mpc_lanemerging_torch.ops import qp, st_kernel
        from rl_mpc_lanemerging_torch.planner import mpc
        from rl_mpc_lanemerging_torch.sim import episode
        w = self.window
        warmup, sense = episode.warmup, episode.sense

        def marked_warmup(*args, **kwargs):
            w.new_round()
            return warmup(*args, **kwargs)

        def noted_sense(world, cfg):
            state = sense(world, cfg)
            w.note_sense(state, lambda: (
                world.cars_x, world.cars_v, world.cars_prev_v,
                world.cars_active, world.ego_active, world.ego_arc,
                world.ego_v, world.ego_prev_v))
            return state
        self._patch(episode, "warmup", marked_warmup)
        self._patch(episode, "sense", noted_sense)
        if self.arbiter:
            plan, certify = mpc.batched_st_control, \
                mpc.batched_test_guaranteed_crash

            def noted_plan(*args, **kwargs):
                out = plan(*args, **kwargs)
                w.note("plan", out[0])
                return out

            def noted_certificate(*args, **kwargs):
                out = certify(*args, **kwargs)
                w.note("cert", out)
                return out
            self._patch(mpc, "batched_st_control", noted_plan)
            self._patch(mpc, "batched_test_guaranteed_crash",
                        noted_certificate)
        if w.trace:
            self._patch(mpc, "build_st_grid",
                        w.wrap_span("grid", mpc.build_st_grid))
            self._patch(qp, "finer_fit_qp",
                        w.wrap_span("qp", qp.finer_fit_qp))
            self._patch(st_kernel, "st_wavefront",
                        w.wrap_k1(st_kernel.st_wavefront))
        return self

    def __exit__(self, *exc):
        for module, name, old in reversed(self._saved):
            setattr(module, name, old)
        self._saved = []
        return False


def crash_dir() -> str:
    """Where the ST task's crash histories go: under the run's TMPDIR."""
    return os.path.join(tempfile.gettempdir(), "benchmark_crash_dumps")


def drive(window: Window, cfg, parts: Parts, device, traffic: dict,
          num_episodes: Optional[int] = None) -> None:
    """Rounds of the program's evaluation entry, each from fresh worlds of
    the run's seed, until the window closes; the traffic mix's warm-up and
    episode length (the task's own defaults in the published mixes)."""
    from rl_mpc_lanemerging_torch import tasks
    controller = window.wrap_controller(parts.controller)
    with instrument(window, arbiter=cfg.TASK == "EVALUATE_COMBINED_DDPG"):
        window.start()
        try:
            while not window.past_deadline():
                tasks.evaluate_controller(
                    cfg, controller, num_episodes, device=device,
                    max_episode_length=float(traffic["max_episode_length"]),
                    wait_before_start=float(traffic["wait_before_start"]),
                    verbose=False, custom_stats=parts.custom_stats,
                    save_state_on_crash=parts.save_state_on_crash,
                    run_dir=crash_dir(), controller_carry=parts.carry)
        except WindowClosed:
            pass
        window.close()
        window.stop_profiler()
