"""Custom DQN trainer: Double-DQN + prioritized replay on the device.

Port of ``rl_mpc_lanemerging_tpu/agents/dqn.py`` (reference
dqn.py:244-359 ``DQNAgent._train``): staircase epsilon decay
(dqn.py:275-276), target-network refresh every TARGET_NET_FREEZE_PERIOD
episodes (dqn.py:278-280), prioritized insertion at max priority
(dqn.py:302-304), Double-DQN targets with clipped bootstrap values
(dqn.py:673-705), SmoothL1 + Adam (dqn.py:262-263) and
TRAINING_STEPS_PER_EPISODE grad steps of BATCH_SIZE per completed episode,
on the batched async env (``envs/merge_env.py``).  As in the JAX package,
terminal transitions do not bootstrap (the reference's episode->SARS
conversion never marks them, rl.py:194-215).

As in ``agents/ddpg.py``, the network and optimiser are torch objects
updated in place, the scans are Python loops, and ``jax.lax.cond(replay.size
>= BATCH_SIZE)`` is one host read per round.  Every draw comes from a draw
source (``GeneratorDraws`` by default), so that a test can feed another
implementation's draws.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch

from .. import convert
from .._device import pin_fp32_matmul, resolve_device
from ..checkpoint import save_params
from ..config import Settings
from ..envs.merge_env import EnvKind, MergeEnvState, env_reset, env_step
from ..models.mlp import DQNNet
from ..rl import replay as rb
from ..rl.obs import state_vector
from ..sim.world import WorldState
from .combined import _speed_from_jerk
from .ddpg import _adam, _step

__all__ = ["GeneratorDraws", "DQNTrainState", "make_train_state",
           "epsilon_by_episode", "train_round", "refresh_target", "train",
           "greedy_controller"]


class GeneratorDraws:
    """The trainer's draws from one ``torch.Generator``: the exploration
    uniforms and random actions of each collect tick, and the replay
    uniforms of each grad step."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def explore(self, batch: int, device) -> torch.Tensor:
        return torch.rand((batch,), generator=self.generator,
                          dtype=torch.float64, device=device)

    def random_action(self, batch: int, num_actions: int, device
                      ) -> torch.Tensor:
        return torch.randint(0, num_actions, (batch,),
                             generator=self.generator, device=device)

    def replay_uniform(self, batch: int, dtype, device) -> torch.Tensor:
        return torch.rand((batch,), generator=self.generator, dtype=dtype,
                          device=device)


@dataclasses.dataclass
class DQNTrainState:
    net: DQNNet
    target_net: DQNNet
    opt: torch.optim.Adam
    replay: rb.Replay
    env: MergeEnvState
    world_rng: object            # the world's draw source (sim/rng.py)
    draws: object                # exploration and replay draws
    episodes: torch.Tensor       # () int64 completed episodes
    loss_sum: torch.Tensor       # () loss summed over the round's steps
    grad_steps: int = 0          # learner steps done


def _net(cfg: Settings, generator: Optional[torch.Generator] = None
         ) -> DQNNet:
    return DQNNet(cfg.obs_dim, num_outputs=len(cfg.JERK_VALUES_DQN),
                  dropout=cfg.USE_DROPOUT, generator=generator)


def make_train_state(cfg: Settings, world: WorldState, world_rng, seed: int,
                     wait_before_start: float = 20.0,
                     init_params: Optional[dict] = None,
                     draws=None) -> DQNTrainState:
    """A fresh trainer on the worlds' device and dtype.  ``seed`` draws the
    initial network (on the CPU) and seeds the default draws;
    ``init_params`` is a ``state_dict`` to start from."""
    device, dtype = world.ego_arc.device, world.ego_arc.dtype
    net = _net(cfg, torch.Generator().manual_seed(seed))
    if init_params is not None:
        net.load_state_dict(init_params)
    net = net.to(device=device, dtype=dtype)
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(
            seed))
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return DQNTrainState(
        net=net, target_net=copy.deepcopy(net).requires_grad_(False),
        opt=_adam(net, cfg.LEARNING_RATE),
        replay=rb.init_replay(cfg.REPLAY_BUFFER_SIZE, cfg.obs_dim,
                              discrete=True, dtype=dtype, device=device),
        env=env_reset(world, cfg, wait_before_start=wait_before_start),
        world_rng=world_rng, draws=draws, episodes=zero,
        loss_sum=torch.zeros((), dtype=dtype, device=device))


def epsilon_by_episode(episodes, cfg: Settings) -> torch.Tensor:
    """Staircase exponential decay (reference dqn.py:275-276), in float32
    as the JAX trainer computes it from its int32 episode count."""
    steps = torch.floor(torch.as_tensor(episodes) / cfg.EPS_DECAY_RATE)
    return cfg.EPS_END + (cfg.EPS_START - cfg.EPS_END) * torch.exp(
        -cfg.EPS_DECAY_COEFFICIENT * steps.to(torch.float32))


def _targets(net: DQNNet, target_net: DQNNet, batch, cfg: Settings):
    """Double-DQN targets with clipping (reference dqn.py:673-705); no
    gradient flows through them, as optax's Huber loss takes them as
    constants."""
    with torch.no_grad():
        q_next_target = target_net(batch["next_obs"])
        if cfg.DOUBLE_DQN:
            best = torch.argmax(net(batch["next_obs"]), dim=-1)
            boot = cfg.DISCOUNT_FACTOR * q_next_target.gather(
                1, best[:, None])[:, 0]
        else:
            boot = cfg.DISCOUNT_FACTOR * q_next_target.amax(dim=-1)
        if cfg.CLIP_TARGETS:
            boot = torch.clamp(boot, cfg.CLIP_MIN_REWARD, cfg.CLIP_MAX_REWARD)
        boot = torch.where(batch["terminal"], 0.0, boot)
        return batch["reward"] + boot


def _grad_step(net: DQNNet, target_net: DQNNet, opt, batch, cfg: Settings):
    """One learner step in place: mean Huber loss (delta 1) of Q(s, a)
    against the targets, one Adam step.  Returns (loss, td error), the td
    error from the parameters before the step."""
    targets = _targets(net, target_net, batch, cfg)
    qa = net(batch["obs"]).gather(1, batch["action"][:, None])[:, 0]
    loss = torch.nn.functional.huber_loss(qa, targets, delta=1.0)
    _step(opt, loss)
    return loss.detach(), qa.detach() - targets


def train_round(state: DQNTrainState, cfg: Settings, env_ticks: int = 64,
                grad_steps: int = 16, wait_before_start: float = 20.0
                ) -> DQNTrainState:
    """One round: ``env_ticks`` ticks of batched experience under the
    epsilon-greedy policy (epsilon from the episodes done at the round's
    start), then ``grad_steps`` prioritized updates once the replay holds
    BATCH_SIZE transitions."""
    net, draws = state.net, state.draws
    n_act = len(cfg.JERK_VALUES_DQN)
    eps = epsilon_by_episode(state.episodes, cfg)
    init_pri = cfg.PER_MAX_PRIORITY ** cfg.PER_ALPHA \
        if cfg.USE_PRIORITIZED_ER else 1.0
    for _ in range(env_ticks):
        env = state.env
        with torch.no_grad():
            greedy = torch.argmax(net(env.obs), dim=-1)
        b, dev = greedy.shape[0], greedy.device
        explore = draws.explore(b, dev) < eps
        random_a = draws.random_action(b, n_act, dev)
        action = torch.where(explore, random_a.to(greedy.dtype), greedy)
        state.env, tr = env_step(
            env, action, cfg, state.world_rng, EnvKind.JERK,
            max_episode_length=cfg.TRAINING_EPISODE_LENGTH,
            wait_before_start=wait_before_start)
        state.replay = rb.add_batch(state.replay, tr["obs"], tr["next_obs"],
                                    tr["action"], tr["reward"],
                                    tr["terminal"], tr["valid"], init_pri)
        state.episodes = state.episodes + tr["done"].sum()

    state.loss_sum = torch.zeros_like(state.loss_sum)
    if int(state.replay.size) >= cfg.BATCH_SIZE:
        p = state.replay.priority
        for _ in range(grad_steps):
            idx, batch = rb.sample(
                state.replay, cfg.BATCH_SIZE,
                u=draws.replay_uniform(cfg.BATCH_SIZE, p.dtype, p.device))
            loss, td = _grad_step(net, state.target_net, state.opt, batch,
                                  cfg)
            if cfg.USE_PRIORITIZED_ER:
                rb.update_priorities(state.replay, idx, td, cfg)
            state.loss_sum = state.loss_sum + loss
        state.grad_steps += grad_steps
    return state


def refresh_target(state: DQNTrainState) -> DQNTrainState:
    """Hard target copy (reference dqn.py:278-280)."""
    state.target_net.load_state_dict(state.net.state_dict())
    return state


def greedy_controller(net: DQNNet, cfg: Settings):
    """HighwayState batch -> speed commands via argmax-Q jerk actuation
    (reference dqn.py:661-670 ``do_dqn_control`` at epsilon=0).  Matrix
    products are pinned to true fp32."""
    pin_fp32_matmul()
    p = next(net.parameters())
    table = torch.tensor(cfg.JERK_VALUES_DQN, dtype=p.dtype, device=p.device)

    def control(states):
        with torch.no_grad():
            q = net(state_vector(states, cfg))
        jerk = table[torch.argmax(q, dim=-1)]
        return _speed_from_jerk(states.ego_speed, states.ego_accel, jerk, cfg)

    return control


def _save(run_dir: str, net: DQNNet) -> str:
    return save_params(run_dir, {
        "q": convert.tree_from_state_dict(net.state_dict())})


def train(cfg: Settings, num_episodes: Optional[int] = None,
          verbose: bool = True, env_ticks: int = 200, device="cuda",
          eval_episodes: Optional[int] = None) -> DQNTrainState:
    """The custom trainer's loop (reference dqn.py:257-359
    ``DQNAgent._train``): train for NUM_TRAINING_EPISODES with the
    staircase epsilon schedule, refresh the target net every
    TARGET_NET_FREEZE_PERIOD episodes, evaluate greedily every
    EVALUATION_PERIOD episodes (over ``eval_episodes``, by default
    max(NUM_EVALUATION_EPISODES, 512)), keep the best-scoring snapshot
    (``budget.snapshot_score``), and write it to
    ``runs_torch/<LOG_DIR>/params.npz`` under the net key ``q``."""
    from .. import tasks
    from ..rundir import setup_run_dir
    from .budget import grad_steps_per_round, snapshot_score

    dev = resolve_device(device)
    pin_fp32_matmul()
    run = setup_run_dir(cfg)
    num_episodes = num_episodes or cfg.NUM_TRAINING_EPISODES
    eval_episodes = eval_episodes or max(cfg.NUM_EVALUATION_EPISODES, 512)
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    state = make_train_state(cfg, worlds, world_rng, tasks.seed_of(cfg))
    batch = worlds.ego_arc.shape[0]
    # the reference's TRAINING_STEPS_PER_EPISODE grad steps per episode
    grad_steps = grad_steps_per_round(cfg.TRAINING_STEPS_PER_EPISODE,
                                      batch, env_ticks)
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    last_target = last_eval = 0
    best: dict = {}
    r = 0
    eps_done = 0
    while eps_done < num_episodes:
        state = train_round(state, cfg, env_ticks=env_ticks,
                            grad_steps=grad_steps)
        r += 1
        eps_done = int(state.episodes)          # one read per round
        if eps_done - last_target >= cfg.TARGET_NET_FREEZE_PERIOD:
            refresh_target(state)
            last_target = eps_done
        if eps_done - last_eval >= cfg.EVALUATION_PERIOD:
            last_eval = eps_done
            agg = tasks.evaluate_controller(
                eval_cfg, greedy_controller(state.net, eval_cfg),
                num_episodes=eval_episodes, device=dev,
                max_episode_length=cfg.EVALUATION_EPISODE_LENGTH,
                verbose=False)
            avg = agg.get_stat_averages()
            if verbose:
                print(f"  [eval @ {eps_done} eps] "
                      f"crash={avg['crashed']:.4f} "
                      f"merge={avg['merged']:.4f} "
                      f"jerk={avg['mean_abs_jerk']:.3f} "
                      f"t_merge={avg['time_to_merge']:.1f}", flush=True)
            run.log_scalars(eps_done, {"eval_crash": avg["crashed"],
                                       "eval_merge": avg["merged"],
                                       "eval_jerk": avg["mean_abs_jerk"]})
            score = snapshot_score(avg["crashed"], avg["merged"],
                                   avg["mean_abs_jerk"],
                                   avg["time_to_merge"])
            if best.get("score") is None or score < best["score"]:
                best.update(score=score, episodes=eps_done, params={
                    k: v.detach().clone()
                    for k, v in state.net.state_dict().items()})
            _save(run.path, state.net)                     # checkpoint
        if verbose and r % 10 == 0:
            eps = float(epsilon_by_episode(state.episodes, cfg))
            loss = float(state.loss_sum)
            print(f"  round {r} episodes={eps_done} eps={eps:.3f} "
                  f"loss={loss:.4f}", flush=True)
            run.log_scalars(eps_done, {"epsilon": eps, "loss": loss})
    if best.get("params") is not None:
        if verbose:
            print(f"  selected snapshot @ {best['episodes']} episodes "
                  f"(score={best['score'][0]:.4f})", flush=True)
        state.net.load_state_dict(best["params"])
    _save(run.path, state.net)
    return state
