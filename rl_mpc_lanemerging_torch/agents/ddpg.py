"""DDPG agent, evaluation half.

Port of the policy and task runners of ``rl_mpc_lanemerging_tpu/agents/
ddpg.py`` (reference ddpg.py:83-87, main.py:32-40): the trained actor as a
jerk policy, as a speed controller, and the EVALUATE_DDPG and
EVALUATE_COMBINED_* tasks.  The trainer and the replay buffer are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from .._device import pin_fp32_matmul, resolve_device
from ..checkpoint import load_actor
from ..config import Settings
from ..models.ddpg import DDPGActor
from ..rl.obs import state_vector
from ..stats import StatsAggregator
from .combined import _speed_from_jerk, combined_controller

__all__ = ["actor_jerk", "actor_controller", "evaluate", "evaluate_combined"]


def actor_jerk(actor: DDPGActor, cfg: Settings):
    """HighwayState batch -> jerk actions (B,) (reference ddpg.py:83-87).
    The actor's parameters have the states' dtype and device."""
    def policy(states):
        with torch.no_grad():
            return actor(state_vector(states, cfg))[:, 0]

    return policy


def actor_controller(actor: DDPGActor, cfg: Settings):
    """HighwayState batch -> speed commands via set_ego_jerk integration.
    Matrix products are pinned to true fp32."""
    pin_fp32_matmul()
    policy = actor_jerk(actor, cfg)

    def control(states):
        return _speed_from_jerk(states.ego_speed, states.ego_accel,
                                policy(states), cfg)

    return control


def _actor_on(cfg: Settings, actor: Optional[DDPGActor], dev) -> DDPGActor:
    if actor is None:
        return load_actor(cfg.MODEL_NAME, dev, cfg.MINIMUM_NEGATIVE_JERK,
                          cfg.MAXIMUM_POSITIVE_JERK)
    return actor.to(dev)


def evaluate(cfg: Settings, actor: Optional[DDPGActor] = None,
             device="cuda", verbose: bool = True) -> StatsAggregator:
    """EVALUATE_DDPG (reference main.py:32-34 -> dqn.py:202-213): the
    actor of ``cfg.MODEL_NAME`` alone drives the ego."""
    from .. import tasks
    dev = resolve_device(device)
    controller = actor_controller(_actor_on(cfg, actor, dev), cfg)
    agg = tasks.evaluate_controller(cfg, controller, device=dev,
                                    verbose=verbose)
    # the JAX package also draws rollout plots here (forensics.py), which
    # the port does not have yet
    tasks.report(agg, cfg, verbose)
    return agg


def evaluate_combined(cfg: Settings, actor: Optional[DDPGActor] = None,
                      device="cuda", verbose: bool = True
                      ) -> StatsAggregator:
    """EVALUATE_COMBINED_* (reference main.py:35-40 -> dqn.py:228-241): the
    arbiter between the actor and the MPC drives the ego."""
    from .. import tasks
    dev = resolve_device(device)
    if dev.type == "cuda":
        # build the kernel before the first round so that no round's wall
        # clock includes the nvcc build
        from ..ops import st_kernel
        st_kernel.load_kernel()
    policy = actor_jerk(_actor_on(cfg, actor, dev), cfg)
    controller, init_carry, takeover_stats = combined_controller(policy, cfg)
    carry = init_carry(cfg.BATCH_SCENARIOS, dev) if init_carry else None
    agg = tasks.evaluate_controller(
        cfg, controller, device=dev, verbose=verbose,
        custom_stats=takeover_stats, controller_carry=carry)
    tasks.report(agg, cfg, verbose)
    return agg
