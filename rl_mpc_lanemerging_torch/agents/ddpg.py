"""DDPG agent: the trainer for the continuous-jerk policy, the trained actor
as a controller, and the task runners.

Port of ``rl_mpc_lanemerging_tpu/agents/ddpg.py``.  The reference trains
DDPG through the ``autonomous-learning-library`` 0.5.3 preset on
``sumo-jerk-continuous-v0`` (reference ddpg.py:24-117); the JAX package
re-derives standard DDPG (Lillicrap et al.): a deterministic actor and a Q
critic with polyak-averaged targets, Gaussian exploration noise and uniform
replay, inside the reference's pipeline (``train`` for num_frames, then
learning rate / 10 and resume for another num_frames into an "_extended"
run, ddpg.py:96-117, then evaluation).  The library's ``TimeFeature``
observation wrapper (reference ddpg.py:41) is omitted, as in the JAX
package.

What the port does differently, and why:

* The networks and optimisers are stateful torch objects, updated in
  place; ``DDPGTrainState`` holds them beside the env and the replay.
* ``jax.lax.scan`` loops are Python loops, and ``jax.lax.cond(replay.size
  >= REPLAY_START)`` is a host check: size only grows, so that is one read
  per tick until the threshold is crossed and none after.
* The counters stay on the device; ``_train_frames`` reads them once per
  round, as the JAX trainer does.
* Exploration noise and replay draws come from a draw source
  (``agents/draws.py``; by default one ``torch.Generator`` on the env's
  device), so that a test can replay JAX's; the world's draws come from
  its own source (``sim/rng.py``).
* Data parallelism (``make_sharded_train``) is one process per rank, each
  with its own envs, replay and parameter copy; ``group`` switches on the
  gradient averaging of ``parallel/sharded.py`` where JAX ``pmean``s.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import convert, tracing
from .._device import pin_fp32_matmul, resolve_device
from ..checkpoint import load_actor, load_params, save_params
from ..config import Settings
from ..envs.merge_env import EnvKind, MergeEnvState, env_reset, env_step
from ..forensics import plot_rollouts
from ..models.ddpg import DDPGActor, DDPGCritic
from ..parallel.sharded import agree_min, average_gradients
from ..rl import replay as rb
from ..rl.obs import state_vector
from ..rundir import RUNS_ROOT
from ..sim.world import WorldState
from ..stats import StatsAggregator
from .combined import _speed_from_jerk, combined_controller
from .draws import GeneratorDraws

__all__ = ["DDPGTrainState", "make_train_state", "train_round",
           "make_sharded_train", "train", "actor_jerk", "actor_controller",
           "evaluate", "evaluate_combined"]

# Hyperparameters of the library preset, re-derived from the published
# algorithm (the reference passes only lr_q/lr_pi through, ddpg.py:49-53).
NOISE_SIGMA = 0.5            # exploration noise std (jerk units)
POLYAK = 0.005               # soft target update rate
DDPG_BATCH = 100
DDPG_DISCOUNT = 0.99
REPLAY_START = 2000
DDPG_REPLAY_CAPACITY = 2 ** 19
TICKS_PER_ROUND = 200        # env ticks per round of _train_frames
# the tracer's spans of one update, in order (the replay draw in
# train_round, the rest in _update)
UPDATE_STAGES = ("ddpg.replay_draw", "ddpg.target", "ddpg.critic_step",
                 "ddpg.actor_step", "ddpg.polyak")


@dataclasses.dataclass
class DDPGTrainState:
    actor: DDPGActor
    critic: DDPGCritic
    target_actor: DDPGActor
    target_critic: DDPGCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    replay: rb.Replay
    env: MergeEnvState
    world_rng: object            # the world's draw source (sim/rng.py)
    draws: object                # exploration noise and replay draws
    episodes: torch.Tensor       # () int64
    frames: torch.Tensor         # () int64
    ret_acc: torch.Tensor        # (B,) running return of the episode
    ep_ret_sum: torch.Tensor     # () sum of completed-episode returns
    ep_ret_n: torch.Tensor       # () completed episodes (for the mean)
    learning: bool = False       # the replay has reached REPLAY_START
    updates: int = 0             # gradient updates done


def _nets(cfg: Settings, generator: torch.Generator):
    actor = DDPGActor(cfg.obs_dim, cfg.MINIMUM_NEGATIVE_JERK,
                      cfg.MAXIMUM_POSITIVE_JERK, generator=generator)
    critic = DDPGCritic(cfg.obs_dim, generator=generator)
    return actor, critic


def _adam(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults: betas 0.9 / 0.999, eps 1e-8 outside the
    square root.  The fused form: one kernel per step on the card, and a
    third of the host time of the default form."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, fused=True)


def derive_seed(seed: int) -> int:
    """The seed of a later stage, derived from its first stage's."""
    return int(np.random.SeedSequence(seed).generate_state(1)[0])


def make_train_state(cfg: Settings, world: WorldState, world_rng, seed: int,
                     lr: Optional[float] = None,
                     wait_before_start: float = 20.0,
                     init_params: Optional[tuple] = None,
                     draws=None) -> DDPGTrainState:
    """A fresh trainer on the worlds' device and dtype.  ``seed`` draws the
    initial networks (on the CPU) and seeds the default draw source, a
    generator on the device; ``init_params`` is (actor, critic)
    ``state_dict``s to start from."""
    device, dtype = world.ego_arc.device, world.ego_arc.dtype
    # cast before loading, so that parameters finer than float32 survive
    actor, critic = (m.to(device=device, dtype=dtype) for m in _nets(
        cfg, torch.Generator().manual_seed(seed)))
    if init_params is not None:
        actor.load_state_dict(init_params[0])
        critic.load_state_dict(init_params[1])
    lr = lr if lr is not None else cfg.LEARNING_RATE
    batch = world.ego_arc.shape[0]

    def zero(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return DDPGTrainState(
        actor=actor, critic=critic,
        target_actor=copy.deepcopy(actor).requires_grad_(False),
        target_critic=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=_adam(actor, lr), critic_opt=_adam(critic, lr),
        replay=rb.init_replay(DDPG_REPLAY_CAPACITY, cfg.obs_dim,
                              discrete=False, dtype=dtype, device=device),
        env=env_reset(world, cfg, wait_before_start=wait_before_start),
        world_rng=world_rng,
        draws=draws or GeneratorDraws.seeded(seed, device),
        episodes=zero(dt=torch.int64), frames=zero(dt=torch.int64),
        ret_acc=zero(batch), ep_ret_sum=zero(), ep_ret_n=zero())


def _step(opt: torch.optim.Optimizer, loss, group=None) -> None:
    """One optimiser step on the gradients of ``loss`` with respect to the
    optimiser's own parameters, and no others; with a process ``group``,
    on their mean over its ranks (JAX: ``pmean`` between ``grad`` and the
    Adam step)."""
    params = opt.param_groups[0]["params"]
    grads = torch.autograd.grad(loss, params)
    if group is not None:
        grads = average_gradients(grads, group)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def _polyak(targets, onlines) -> None:
    """target <- (1 - POLYAK) * target + POLYAK * online, in that order,
    for each (target, online) pair of modules, in one pass over all."""
    t = [p for m in targets for p in m.parameters()]
    o = [p for m in onlines for p in m.parameters()]
    torch._foreach_mul_(t, 1 - POLYAK)
    torch._foreach_add_(t, torch._foreach_mul(o, POLYAK))


def _update(actor: DDPGActor, critic: DDPGCritic, target_actor: DDPGActor,
            target_critic: DDPGCritic, actor_opt, critic_opt, batch,
            group=None) -> None:
    """One DDPG update, in place: the critic first, then the actor through
    the updated critic, then both targets.  Each stage is a span of the
    tracer (``UPDATE_STAGES``).  With a process ``group`` both gradients are
    averaged over its ranks (JAX ``_update(axis_name=...)``, ddpg.py:121,
    :131), which keeps every rank's copy identical."""
    act = batch["action"][:, None]
    with tracing.span("ddpg.target"), torch.no_grad():
        next_a = target_actor(batch["next_obs"])
        q_next = target_critic(batch["next_obs"], next_a)
        target = batch["reward"] + DDPG_DISCOUNT \
            * torch.where(batch["terminal"], 0.0, q_next)

    with tracing.span("ddpg.critic_step"):
        q = critic(batch["obs"], act)
        _step(critic_opt, torch.mean((q - target) ** 2), group)

    # gradients into the actor's parameters only
    with tracing.span("ddpg.actor_step"):
        a = actor(batch["obs"])
        _step(actor_opt, -torch.mean(critic(batch["obs"], a)), group)

    with tracing.span("ddpg.polyak"), torch.no_grad():
        _polyak((target_actor, target_critic), (actor, critic))


def train_round(state: DDPGTrainState, cfg: Settings, env_ticks: int = 64,
                updates_per_tick: int = 64,
                wait_before_start: float = 20.0,
                group=None) -> DDPGTrainState:
    """``env_ticks`` batched env steps; ``updates_per_tick`` gradient
    updates per tick once the replay holds REPLAY_START transitions.  The
    reference library does one update per environment frame
    (update_frequency=1); with B scenarios stepping per tick,
    updates_per_tick ~ B/2 keeps the updates-per-frame ratio in the same
    regime.

    With a process ``group`` (``make_sharded_train``) the updates average
    their gradients over its ranks, and the ranks start learning together,
    on the first tick after which every rank's replay holds REPLAY_START
    transitions (the smallest replay decides, ``agree_min``): a rank that
    stepped into an update's ``all_reduce`` alone would wait forever, so
    every rank makes the same number of updates."""
    draws = state.draws
    for _ in range(env_ticks):
        env = state.env
        with torch.no_grad():
            a_mean = state.actor(env.obs)[:, 0]
        noise = NOISE_SIGMA * draws.action_noise(a_mean.shape, a_mean.dtype,
                                                 a_mean.device)
        action = torch.clamp(a_mean + noise, cfg.MINIMUM_NEGATIVE_JERK,
                             cfg.MAXIMUM_POSITIVE_JERK)
        state.env, tr = env_step(env, action, cfg, state.world_rng,
                                 EnvKind.CONTINUOUS_JERK,
                                 max_episode_length=cfg.MAX_EPISODE_LENGTH,
                                 wait_before_start=wait_before_start)
        state.replay = rb.add_batch(state.replay, tr["obs"], tr["next_obs"],
                                    tr["action"], tr["reward"],
                                    tr["terminal"], tr["valid"], 1.0)
        done, valid = tr["done"], tr["valid"]
        state.episodes = state.episodes + done.sum()
        state.frames = state.frames + valid.sum()

        # episode-return bookkeeping (training-curve observability)
        ret_acc = state.ret_acc + torch.where(valid, tr["reward"], 0.0)
        state.ep_ret_sum = state.ep_ret_sum \
            + torch.where(done, ret_acc, 0.0).sum()
        state.ep_ret_n = state.ep_ret_n + done.sum()
        state.ret_acc = torch.where(done, 0.0, ret_acc)

        if not state.learning:
            size = state.replay.size if group is None \
                else agree_min(state.replay.size, group)
            state.learning = bool(size >= REPLAY_START)
        if state.learning:
            p = state.replay.priority
            for _ in range(updates_per_tick):
                with tracing.span("ddpg.replay_draw"):
                    _, batch = rb.sample(state.replay, DDPG_BATCH,
                                         u=draws.replay_uniform(
                                             DDPG_BATCH, p.dtype, p.device))
                _update(state.actor, state.critic, state.target_actor,
                        state.target_critic, state.actor_opt,
                        state.critic_opt, batch, group)
            state.updates += updates_per_tick
    return state


def make_sharded_train(cfg: Settings, mesh, seed: int, lr: float,
                       env_ticks: int = 200, updates_per_tick: int = 64,
                       init_params: Optional[tuple] = None,
                       wait_before_start: float = 20.0):
    """Data-parallel trainer over the scenario mesh (JAX ddpg.py:216-254):
    each rank owns a full local train state (envs, replay, draws and a
    parameter copy) on the current card, or on the CPU when the mesh is a
    CPU mesh; its updates average their gradients over the ranks, so the
    copies stay identical (SURVEY §2.3; the reference trains strictly
    single-process, dqn.py:272-354).  Rank i's worlds draw from SEED + i
    and its draws from ``sharded.rank_seed(seed, i)``; rank 0's initial
    parameters (``init_params``, or its own draw) are broadcast to every
    rank.

    Returns (this rank's state, round_fn), ``round_fn(state)`` advancing
    the rank one train round."""
    from ..parallel import sharded

    state = sharded.data_parallel_state(
        make_train_state, cfg, mesh, seed, ("actor", "critic"), lr=lr,
        wait_before_start=wait_before_start, init_params=init_params)
    round_fn = sharded.sharded_train_round(functools.partial(
        train_round, cfg=cfg, env_ticks=env_ticks,
        updates_per_tick=updates_per_tick,
        wait_before_start=wait_before_start), mesh)
    return state, round_fn


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


# ---------------------------------------------------------------------------
# task runners (reference ddpg.py:96-117, main.py:23-40)
# ---------------------------------------------------------------------------

def _eval_actor(cfg: Settings, actor: DDPGActor, num_episodes: int):
    """Greedy-policy evaluation on the actor's device; returns (crash,
    merge, jerk, time to merge) means (reference dqn.py:282-285 periodic
    eval at EVALUATION_TICK_LENGTH / EVALUATION_EPISODE_LENGTH)."""
    from .. import tasks
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    p = next(actor.parameters())
    agg = tasks.evaluate_controller(
        eval_cfg, actor_controller(actor, eval_cfg),
        num_episodes=num_episodes, dtype=p.dtype, device=p.device,
        max_episode_length=cfg.EVALUATION_EPISODE_LENGTH, verbose=False)
    avg = agg.get_stat_averages()
    return (avg["crashed"], avg["merged"], avg["mean_abs_jerk"],
            avg["time_to_merge"])


def _snapshot(*modules):
    return tuple({k: v.detach().clone() for k, v in m.state_dict().items()}
                 for m in modules)


def _train_frames(cfg: Settings, state: DDPGTrainState, num_frames: float,
                  lr: float, verbose: bool = True, run=None,
                  updates_per_tick: int = 64, eval_every_rounds: int = 0,
                  eval_episodes: int = 2048,
                  best: Optional[dict] = None) -> DDPGTrainState:
    """Advance ``num_frames`` valid frames.  With ``eval_every_rounds`` the
    actor is evaluated every that many rounds and the best-scoring
    (``budget.snapshot_score``) parameter snapshot is kept in ``best``
    (keys score/params/frames), threaded through both stages so that the
    pipeline keeps one best across train + extended.  2048-episode
    selection evals: at 512 a true-0.004-crash snapshot measures 0/512 with
    ~13% probability."""
    from .budget import frame_budget_rounds, snapshot_score
    batch = state.env.obs.shape[0]
    frames0 = int(state.frames)

    def do_eval(tag=""):
        crash, merge, jerk, t_merge = _eval_actor(cfg, state.actor,
                                                  eval_episodes)
        frames = int(state.frames)
        if verbose:
            print(f"  [eval @ {frames} frames{tag}] crash={crash:.4f} "
                  f"merge={merge:.4f} jerk={jerk:.3f} t_merge={t_merge:.1f}",
                  flush=True)
        if run is not None:
            run.log_scalars(frames, {"eval_crash": crash,
                                     "eval_merge": merge, "eval_jerk": jerk,
                                     "eval_t_merge": t_merge})
        if best is not None:
            score = snapshot_score(crash, merge, jerk, t_merge)
            if best.get("score") is None or score < best["score"]:
                best.update(score=score, frames=frames,
                            params=_snapshot(state.actor, state.critic))
                if verbose:
                    print(f"  [best so far: crash={crash:.4f} "
                          f"merge={merge:.4f} jerk={jerk:.3f} "
                          f"t_merge={t_merge:.1f}]", flush=True)

    evaluated_this_round = False
    for r in frame_budget_rounds(num_frames, TICKS_PER_ROUND * batch):
        t0 = time.perf_counter()
        state = train_round(state, cfg, env_ticks=TICKS_PER_ROUND,
                            updates_per_tick=updates_per_tick)
        frames = int(state.frames)            # one read per round
        evaluated_this_round = False
        if r % 5 == 4 or frames - frames0 >= num_frames:
            n = max(float(state.ep_ret_n), 1.0)
            avg_ret = float(state.ep_ret_sum) / n
            # reset the return window so each log point is fresh
            state.ep_ret_sum = torch.zeros_like(state.ep_ret_sum)
            state.ep_ret_n = torch.zeros_like(state.ep_ret_n)
            if verbose:
                print(f"  round {r + 1} frames={frames}/{int(num_frames)}"
                      f" episodes={int(state.episodes)}"
                      f" avg_return={avg_ret:.3f}"
                      f" ({time.perf_counter() - t0:.1f}s/round)",
                      flush=True)
            if run is not None:
                run.log_scalars(frames, {"episodes": int(state.episodes),
                                         "avg_return": avg_ret, "lr": lr})
        if eval_every_rounds and (r + 1) % eval_every_rounds == 0:
            do_eval()
            evaluated_this_round = True
        if frames - frames0 >= num_frames:
            break
    # give the final parameters a chance to be the selected snapshot
    if eval_every_rounds and best is not None and not evaluated_this_round:
        do_eval(tag=", final")
    return state


def _actor_from(cfg: Settings, actor_state: dict, device) -> DDPGActor:
    actor = DDPGActor(cfg.obs_dim, cfg.MINIMUM_NEGATIVE_JERK,
                      cfg.MAXIMUM_POSITIVE_JERK)
    actor.load_state_dict(actor_state)
    return actor.to(device).eval().requires_grad_(False)


def _save(run_dir: str, params: tuple) -> str:
    actor, critic = params
    return save_params(run_dir, {
        "actor": convert.tree_from_state_dict(actor),
        "critic": convert.tree_from_state_dict(critic)})


def train(cfg: Settings, num_frames: float = 1e6, resume: bool = False,
          verbose: bool = True, eval_every_rounds: int = 5,
          eval_episodes: int = 2048, device="cuda"):
    """TRAIN_DDPG / RESUME_DDPG: ``train_ddpg_all_with_lr_drop`` (reference
    ddpg.py:96-117): train, then lr / 10 and resume from the best snapshot
    into an _extended run, then evaluate over cfg.NUM_EPISODES.  Each stage
    writes its selected parameters to ``runs_torch/<LOG_DIR>/params.npz``.
    Returns (final train state, the evaluation's StatsAggregator)."""
    from .. import tasks
    from ..rundir import setup_run_dir

    dev = resolve_device(device)
    pin_fp32_matmul()
    run = setup_run_dir(cfg)
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    seed = tasks.seed_of(cfg)
    init = None
    if resume:
        loaded = load_params(cfg.MODEL_NAME)
        init = (convert.ddpg_actor_from_numpy(loaded["actor"]),
                convert.ddpg_critic_from_numpy(loaded["critic"]))
    state = make_train_state(cfg, worlds, world_rng, seed,
                             lr=cfg.LEARNING_RATE, init_params=init)
    if verbose:
        print(f"DDPG train: {num_frames:.0f} frames at lr="
              f"{cfg.LEARNING_RATE} on {dev}", flush=True)
    best: dict = {}
    state = _train_frames(cfg, state, num_frames, cfg.LEARNING_RATE,
                          verbose, run=run,
                          eval_every_rounds=eval_every_rounds,
                          eval_episodes=eval_episodes, best=best)
    stage1 = best.get("params") or _snapshot(state.actor, state.critic)
    _save(run.path, stage1)

    final = stage1
    if not resume:
        # lr drop + extended run (ddpg.py:98-102); seeded from the
        # best-of-stage-1 snapshot
        lr2 = cfg.LEARNING_RATE / 10.0
        cfg2 = cfg.replace(LOG_DIR=cfg.LOG_DIR + "_extended")
        run2 = setup_run_dir(cfg2, snapshot_src=False)
        worlds2, world_rng2 = tasks.make_worlds(cfg2, device=dev)
        state2 = make_train_state(cfg2, worlds2, world_rng2,
                                  derive_seed(seed), lr=lr2,
                                  init_params=stage1)
        if verbose:
            print(f"DDPG extended: {num_frames:.0f} frames at lr={lr2}",
                  flush=True)
        state2 = _train_frames(cfg2, state2, num_frames, lr2, verbose,
                               run=run2,
                               eval_every_rounds=eval_every_rounds,
                               eval_episodes=eval_episodes, best=best)
        final = best.get("params") or _snapshot(state2.actor, state2.critic)
        _save(run2.path, final)
        state = state2

    if verbose and best.get("score") is not None:
        print(f"  selected snapshot @ {best['frames']} frames "
              f"(crash={best['score'][1]:.4f} jerk={best['score'][2]:.3f})",
              flush=True)
    agg = evaluate(cfg, actor=_actor_from(cfg, final[0], dev), device=dev,
                   verbose=verbose)
    return state, agg


def _actor_on(cfg: Settings, actor: Optional[DDPGActor], dev) -> DDPGActor:
    if actor is None:
        return load_actor(cfg.MODEL_NAME, dev, cfg.MINIMUM_NEGATIVE_JERK,
                          cfg.MAXIMUM_POSITIVE_JERK)
    return actor.to(dev)


def evaluate(cfg: Settings, actor: Optional[DDPGActor] = None,
             device="cuda", verbose: bool = True
             ) -> Optional[StatsAggregator]:
    """EVALUATE_DDPG (reference main.py:32-34 -> dqn.py:202-213): the
    actor of ``cfg.MODEL_NAME`` alone drives the ego; then the actor's
    virtual rollouts are drawn under ``runs_torch/<LOG_DIR>/plots``
    (``forensics.plot_rollouts``)."""
    from .. import tasks
    dev = resolve_device(device)
    actor = _actor_on(cfg, actor, dev)
    agg = tasks.evaluate_controller(cfg, actor_controller(actor, cfg),
                                    device=dev, verbose=verbose)
    tasks.report(agg, cfg, verbose)
    if agg is not None:                 # rank 0 of a run of several ranks
        plot_rollouts(actor_jerk(actor, cfg), cfg,
                      os.path.join(RUNS_ROOT, cfg.LOG_DIR, "plots"),
                      device=dev)
    return agg


def evaluate_combined(cfg: Settings, actor: Optional[DDPGActor] = None,
                      device="cuda", verbose: bool = True
                      ) -> Optional[StatsAggregator]:
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
