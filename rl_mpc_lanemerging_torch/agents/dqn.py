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
source (``agents/draws.py``).  Data parallelism (``make_sharded_train``) is
one process per rank, as in ``agents/ddpg.py``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Optional

import torch

from .. import convert
from .._device import pin_fp32_matmul, resolve_device
from ..checkpoint import save_params
from ..config import Settings
from ..envs.merge_env import EnvKind, MergeEnvState, env_reset, env_step
from ..models.mlp import DQNNet
from ..parallel.sharded import agree_min
from ..rl import replay as rb
from ..rl.obs import state_vector
from ..sim.world import WorldState
from .combined import _speed_from_jerk
from .ddpg import _adam, _step
from .draws import GeneratorDraws

__all__ = ["GeneratorDraws", "DQNTrainState", "make_train_state",
           "epsilon_by_episode", "train_round", "make_sharded_train",
           "refresh_target", "eval_greedy", "new_loop", "train_episodes",
           "train", "greedy_controller"]


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
    # cast before loading, so that parameters finer than float32 survive
    net = _net(cfg, torch.Generator().manual_seed(seed)).to(device=device,
                                                            dtype=dtype)
    if init_params is not None:
        net.load_state_dict(init_params)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return DQNTrainState(
        net=net, target_net=copy.deepcopy(net).requires_grad_(False),
        opt=_adam(net, cfg.LEARNING_RATE),
        replay=rb.init_replay(cfg.REPLAY_BUFFER_SIZE, cfg.obs_dim,
                              discrete=True, dtype=dtype, device=device),
        env=env_reset(world, cfg, wait_before_start=wait_before_start),
        world_rng=world_rng,
        draws=draws or GeneratorDraws.seeded(seed, device), episodes=zero,
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


def _grad_step(net: DQNNet, target_net: DQNNet, opt, batch, cfg: Settings,
               group=None):
    """One learner step in place: mean Huber loss (delta 1) of Q(s, a)
    against the targets, one Adam step, on the gradients averaged over the
    ranks of a process ``group`` when one is given (JAX ``pmean``,
    dqn.py:118).  Returns (loss, td error), both this rank's own, the td
    error from the parameters before the step."""
    targets = _targets(net, target_net, batch, cfg)
    qa = net(batch["obs"]).gather(1, batch["action"][:, None])[:, 0]
    loss = torch.nn.functional.huber_loss(qa, targets, delta=1.0)
    _step(opt, loss, group)
    return loss.detach(), qa.detach() - targets


def train_round(state: DQNTrainState, cfg: Settings, env_ticks: int = 64,
                grad_steps: int = 16, wait_before_start: float = 20.0,
                group=None) -> DQNTrainState:
    """One round: ``env_ticks`` ticks of batched experience under the
    epsilon-greedy policy (epsilon from the episodes done at the round's
    start), then ``grad_steps`` prioritized updates once the replay holds
    BATCH_SIZE transitions.

    With a process ``group`` (``make_sharded_train``) the grad steps
    average their gradients over its ranks, and the ranks learn in a round
    only when every rank's replay holds BATCH_SIZE transitions (the
    smallest decides, ``agree_min``), so that all make the same steps; the
    PER priorities stay each rank's own, as in JAX."""
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
    size = state.replay.size if group is None \
        else agree_min(state.replay.size, group)
    if int(size) >= cfg.BATCH_SIZE:
        p = state.replay.priority
        for _ in range(grad_steps):
            idx, batch = rb.sample(
                state.replay, cfg.BATCH_SIZE,
                u=draws.replay_uniform(cfg.BATCH_SIZE, p.dtype, p.device))
            loss, td = _grad_step(net, state.target_net, state.opt, batch,
                                  cfg, group)
            if cfg.USE_PRIORITIZED_ER:
                rb.update_priorities(state.replay, idx, td, cfg)
            state.loss_sum = state.loss_sum + loss
        state.grad_steps += grad_steps
    return state


def make_sharded_train(cfg: Settings, mesh, seed: int, env_ticks: int = 64,
                       grad_steps: int = 16, wait_before_start: float = 20.0):
    """Data-parallel DQN training over the scenario mesh (JAX
    dqn.py:199-226; the scheme of ``agents.ddpg.make_sharded_train``): each
    rank's envs and replay are its own, its grad steps average their
    gradients over the ranks, and rank 0's initial network is broadcast, so
    every copy stays identical.  Rank i's worlds draw from SEED + i and its
    draws from ``sharded.rank_seed(seed, i)``.  Returns (this rank's state,
    round_fn)."""
    from ..parallel import sharded

    state = sharded.data_parallel_state(
        make_train_state, cfg, mesh, seed, ("net",),
        wait_before_start=wait_before_start)
    round_fn = sharded.sharded_train_round(functools.partial(
        train_round, cfg=cfg, env_ticks=env_ticks, grad_steps=grad_steps,
        wait_before_start=wait_before_start), mesh)
    return state, round_fn


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


def eval_greedy(cfg: Settings, net: DQNNet, num_episodes: int, device):
    """A greedy evaluation at the evaluation tick (reference dqn.py:282-285);
    returns its ``StatsAggregator``."""
    from .. import tasks
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    return tasks.evaluate_controller(
        eval_cfg, greedy_controller(net, eval_cfg),
        num_episodes=num_episodes, device=device,
        max_episode_length=cfg.EVALUATION_EPISODE_LENGTH, verbose=False)


def new_loop() -> dict:
    """The counters ``train_episodes`` carries from round to round."""
    return {"rounds": 0, "last_target": 0, "last_eval": 0}


def train_episodes(cfg: Settings, state: DQNTrainState, num_episodes: int,
                   grad_steps: int, eval_episodes: int, device, run,
                   best: dict, loop: dict, env_ticks: int = 200,
                   verbose: bool = True, checkpoint: Optional[str] = None,
                   stop: Optional[Callable[[], bool]] = None,
                   evaluate: Callable = eval_greedy) -> DQNTrainState:
    """``train``'s loop (reference dqn.py:257-359): rounds until
    ``num_episodes`` episodes are done, the target refreshed every
    TARGET_NET_FREEZE_PERIOD episodes and a greedy evaluation every
    EVALUATION_PERIOD episodes (``evaluate``, called as ``eval_greedy``)
    that keeps the best-scoring snapshot in ``best``
    (``budget.snapshot_score``) and logs to ``run``; with ``checkpoint``,
    the network is saved there after each evaluation.  ``loop``
    (``new_loop()``) holds the round count and the episodes of the last
    refresh and evaluation, updated in place after each round.  ``stop`` is
    asked before each round; where it returns true the loop returns there,
    and a later call goes on from the same ``state``, ``best``, ``run`` and
    ``loop``."""
    from .budget import snapshot_score
    eps_done = int(state.episodes)
    while eps_done < num_episodes:
        if stop is not None and stop():
            break
        state = train_round(state, cfg, env_ticks=env_ticks,
                            grad_steps=grad_steps)
        loop["rounds"] += 1
        eps_done = int(state.episodes)          # one read per round
        if eps_done - loop["last_target"] >= cfg.TARGET_NET_FREEZE_PERIOD:
            refresh_target(state)
            loop["last_target"] = eps_done
        if eps_done - loop["last_eval"] >= cfg.EVALUATION_PERIOD:
            loop["last_eval"] = eps_done
            avg = evaluate(cfg, state.net, eval_episodes,
                           device).get_stat_averages()
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
            if checkpoint is not None:
                _save(checkpoint, state.net)
        if verbose and loop["rounds"] % 10 == 0:
            eps = float(epsilon_by_episode(state.episodes, cfg))
            loss = float(state.loss_sum)
            print(f"  round {loop['rounds']} episodes={eps_done} "
                  f"eps={eps:.3f} loss={loss:.4f}", flush=True)
            run.log_scalars(eps_done, {"epsilon": eps, "loss": loss})
    return state


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
    from .budget import grad_steps_per_round

    dev = resolve_device(device)
    pin_fp32_matmul()
    run = setup_run_dir(cfg)
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    state = make_train_state(cfg, worlds, world_rng, tasks.seed_of(cfg))
    best: dict = {}
    # the reference's TRAINING_STEPS_PER_EPISODE grad steps per episode
    state = train_episodes(
        cfg, state, num_episodes or cfg.NUM_TRAINING_EPISODES,
        grad_steps_per_round(cfg.TRAINING_STEPS_PER_EPISODE,
                             worlds.ego_arc.shape[0], env_ticks),
        eval_episodes or max(cfg.NUM_EVALUATION_EPISODES, 512), dev, run,
        best, new_loop(), env_ticks=env_ticks, verbose=verbose,
        checkpoint=run.path)
    if best.get("params") is not None:
        if verbose:
            print(f"  selected snapshot @ {best['episodes']} episodes "
                  f"(score={best['score'][0]:.4f})", flush=True)
        state.net.load_state_dict(best["params"])
    _save(run.path, state.net)
    return state
