"""Rainbow trainer for the discrete-jerk policy (TRAIN_DQN, RESUME_DQN,
EVALUATE_DQN).

Port of ``rl_mpc_lanemerging_tpu/agents/rainbow.py``.  The reference runs
the ``autonomous-learning-library`` Rainbow preset (reference
rainbow.py:23-106 and main.py:21-31); the JAX package re-derives the
published recipe on the batched env: C51 categorical targets with the
distributional projection, NoisyNet exploration plus an annealed
epsilon-greedy, Double-style action selection from the online network,
n-step returns, prioritized replay with importance weights, and the same
lr-drop "extended" retrain pipeline (rainbow.py:85-106).

As in ``agents/ddpg.py``, the scans are Python loops, the replay-start
condition is a host check, the counters stay on the device, and the
NoisyNet noise, the epsilon draws and the replay draws come from a draw
source (``agents/draws.py``; by default one ``torch.Generator`` on the env's
device).  The noise is drawn apart from its use and passed to the net
(``models/rainbow.py``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import convert
from .._device import const, pin_fp32_matmul, resolve_device
from ..checkpoint import load_params, save_params
from ..config import Settings
from ..envs.merge_env import EnvKind, MergeEnvState, env_reset, env_step
from ..models.rainbow import RainbowNet, atom_support
from ..rl import replay as rb
from ..rl.obs import state_vector
from ..sim.world import WorldState
from ..stats import StatsAggregator
from .combined import _speed_from_jerk
from .ddpg import _adam, _step, derive_seed
from .draws import GeneratorDraws

__all__ = ["NStepStage", "init_stage", "stage_push", "nstep_head",
           "RainbowTrainState", "make_train_state", "train_round",
           "greedy_controller", "train", "evaluate"]

NUM_ATOMS = 51
# support spans the reference's Double-DQN target clip range
# (reference dqn.py:698: targets clipped to [-20, 10]); a crash return
# of -10 plus accumulated time/jerk penalties lands inside, not on the
# edge atom
V_MIN, V_MAX = -20.0, 10.0
RAINBOW_BATCH = 64
RAINBOW_DISCOUNT = 0.99
REPLAY_START = 2000
N_STEP = 3                    # published Rainbow n-step horizon
BETA_START = 0.4              # PER importance-sampling anneal start
BETA_FRAMES = 2e6             # frames to reach beta = 1
EPS_END = 0.1   # reference library preset final exploration (see ADVICE r3)
TICKS_PER_ROUND = 200         # env ticks per round of _train_frames


class NStepStage(NamedTuple):
    """Sliding window of the last N_STEP transitions per scenario; the
    oldest entry is emitted as an n-step transition each tick once the
    window is full.  Window index 0 = oldest."""

    obs: torch.Tensor        # (B, n, D)
    action: torch.Tensor     # (B, n) int64
    reward: torch.Tensor     # (B, n)
    next_obs: torch.Tensor   # (B, n, D)
    terminal: torch.Tensor   # (B, n) bool
    valid: torch.Tensor      # (B, n) bool
    fill: int                # entries appended so far (capped at n)


def init_stage(batch: int, obs_dim: int, n: int = N_STEP,
               dtype=torch.float32, device="cpu") -> NStepStage:
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return NStepStage(
        obs=zeros(batch, n, obs_dim), action=zeros(batch, n, dt=torch.int64),
        reward=zeros(batch, n), next_obs=zeros(batch, n, obs_dim),
        terminal=zeros(batch, n, dt=torch.bool),
        valid=zeros(batch, n, dt=torch.bool), fill=0)


def stage_push(stage: NStepStage, tr) -> NStepStage:
    """Shift the window left and append this tick's transition."""
    def shift(w, new):
        return torch.cat([w[:, 1:], new[:, None].to(w.dtype)], dim=1)

    return NStepStage(
        obs=shift(stage.obs, tr["obs"]),
        action=shift(stage.action, tr["action"]),
        reward=shift(stage.reward, tr["reward"]),
        next_obs=shift(stage.next_obs, tr["next_obs"]),
        terminal=shift(stage.terminal, tr["terminal"]),
        valid=shift(stage.valid, tr["valid"]),
        fill=min(stage.fill + 1, stage.obs.shape[1]))


def nstep_head(stage: NStepStage, gamma: float):
    """Emit the window head as an n-step transition.

    Accumulation stops at the first terminal (transition ends the episode,
    no bootstrap) or the first invalid entry (episode boundary without a
    terminal — timeout/warmup — bootstrap from the last in-episode state).
    Returns (obs, action, R, next_obs_K, terminal, gamma^K, valid).
    """
    n = stage.obs.shape[1]
    dtype = stage.reward.dtype
    k = torch.arange(n, device=stage.reward.device)
    first_term = torch.where(stage.terminal, k, n).amin(dim=1)
    first_inval = torch.where(~stage.valid, k, n).amin(dim=1)
    # K = steps accumulated (1..n)
    K = torch.clamp(torch.minimum(first_term + 1, first_inval), 1, n)
    gammas = gamma ** k.to(dtype)
    take = k[None, :] < K[:, None]
    R = torch.where(take, gammas[None, :] * stage.reward, 0.0).sum(dim=1)
    rows = torch.arange(stage.obs.shape[0], device=k.device)
    next_obs = stage.next_obs[rows, K - 1]
    terminal = first_term < first_inval                 # ended by terminal
    discount = gamma ** K.to(dtype)
    valid = stage.valid[:, 0] & (stage.fill >= n)
    return (stage.obs[:, 0], stage.action[:, 0], R, next_obs, terminal,
            discount, valid)


@dataclasses.dataclass
class RainbowTrainState:
    net: RainbowNet
    target_net: RainbowNet
    opt: torch.optim.Adam
    replay: rb.Replay
    env: MergeEnvState
    stage: NStepStage
    world_rng: object            # the world's draw source (sim/rng.py)
    draws: object                # noise, epsilon and replay draws
    episodes: torch.Tensor       # () int64
    frames: torch.Tensor         # () int64
    learning: bool = False       # the replay has reached REPLAY_START
    grad_steps: int = 0          # learner steps done


def _net(cfg: Settings, generator: Optional[torch.Generator] = None
         ) -> RainbowNet:
    return RainbowNet(cfg.obs_dim, num_actions=len(cfg.JERK_VALUES_DQN),
                      num_atoms=NUM_ATOMS, generator=generator)


def _support(like: torch.Tensor) -> torch.Tensor:
    return atom_support(V_MIN, V_MAX, NUM_ATOMS, like.dtype, like.device)


def make_train_state(cfg: Settings, world: WorldState, world_rng, seed: int,
                     lr: Optional[float] = None,
                     wait_before_start: float = 20.0,
                     init_params: Optional[dict] = None,
                     draws=None) -> RainbowTrainState:
    """A fresh trainer on the worlds' device and dtype.  ``seed`` draws the
    initial network (on the CPU) and seeds the default draw source, a
    generator on the device; ``init_params`` is a ``state_dict`` to start
    from."""
    device, dtype = world.ego_arc.device, world.ego_arc.dtype
    # cast before loading, so that parameters finer than float32 survive
    net = _net(cfg, torch.Generator().manual_seed(seed)).to(device=device,
                                                            dtype=dtype)
    if init_params is not None:
        net.load_state_dict(init_params)
    lr = lr if lr is not None else cfg.LEARNING_RATE
    batch = world.ego_arc.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return RainbowTrainState(
        net=net, target_net=copy.deepcopy(net).requires_grad_(False),
        opt=_adam(net, lr),
        replay=rb.init_replay(cfg.REPLAY_BUFFER_SIZE, cfg.obs_dim,
                              discrete=True, dtype=dtype, device=device),
        env=env_reset(world, cfg, wait_before_start=wait_before_start),
        stage=init_stage(batch, cfg.obs_dim, dtype=dtype, device=device),
        world_rng=world_rng,
        draws=draws or GeneratorDraws.seeded(seed, device),
        episodes=zero, frames=zero.clone())


def _categorical_loss(net: RainbowNet, target_net: RainbowNet, batch, noise,
                      weights=None):
    """C51 cross-entropy with the projected target distribution; returns
    (loss, per-sample cross-entropy, projected target m).

    ``batch["discount"]`` carries gamma^K for n-step transitions;
    ``weights`` are the PER importance-sampling corrections; ``noise`` is
    the online net's NoisyNet draw (the target is computed without noise,
    as in the JAX package)."""
    obs = batch["obs"]
    z = _support(obs)
    rows = torch.arange(obs.shape[0], device=obs.device)
    with torch.no_grad():
        probs_next = torch.softmax(target_net(batch["next_obs"]), dim=-1)
        # choose next action by expected value from the online net
        q_online = (torch.softmax(net(batch["next_obs"]), dim=-1)
                    * z).sum(dim=-1)
        a_star = torch.argmax(q_online, dim=-1)
        p_next = probs_next[rows, a_star]                   # (B, atoms)

        # distributional Bellman projection (n-step: R + gamma^K Z)
        not_term = 1.0 - batch["terminal"].to(z.dtype)
        disc = batch["discount"].to(z.dtype)
        tz = torch.clamp(batch["reward"][:, None]
                         + disc[:, None] * not_term[:, None] * z[None, :],
                         V_MIN, V_MAX)
        dz = (V_MAX - V_MIN) / (NUM_ATOMS - 1)
        b = (tz - V_MIN) / const(dz, tz)
        lo = torch.floor(b).to(torch.int64)
        hi = torch.ceil(b).to(torch.int64)
        # distribute probability mass to neighbours (handle lo == hi)
        eq = (lo == hi).to(z.dtype)
        w_lo = p_next * (hi.to(z.dtype) - b + eq)
        w_hi = p_next * (b - lo.to(z.dtype))
        m = torch.zeros_like(p_next)
        m.scatter_add_(1, lo, w_lo)
        m.scatter_add_(1, torch.clamp(hi, 0, NUM_ATOMS - 1), w_hi)

    logp = torch.log_softmax(net(obs, noise), dim=-1)
    logp_a = logp[rows, batch["action"]]
    ce = -(m * logp_a).sum(dim=-1)
    w = weights if weights is not None else torch.ones_like(ce)
    return torch.mean(w * ce), ce, m


def _grad_step(net: RainbowNet, target_net: RainbowNet, opt, batch, noise,
               weights=None):
    """One learner step in place; returns (loss, per-sample CE)."""
    loss, ce, _ = _categorical_loss(net, target_net, batch, noise, weights)
    _step(opt, loss)
    return loss.detach(), ce.detach()


def train_round(state: RainbowTrainState, cfg: Settings, env_ticks: int = 64,
                grad_steps: int = 16, wait_before_start: float = 20.0,
                epsilon: float = 0.0) -> RainbowTrainState:
    """Collect ``env_ticks`` ticks (NoisyNet forward, greedy over E[Z], plus
    epsilon-greedy), then ``grad_steps`` learner steps with PER and the
    annealed beta once the replay holds REPLAY_START transitions."""
    draws = state.draws
    net = state.net
    z = _support(state.env.obs)
    n_act = len(cfg.JERK_VALUES_DQN)
    init_pri = cfg.PER_MAX_PRIORITY ** cfg.PER_ALPHA
    for _ in range(env_ticks):
        env = state.env
        # NoisyNet exploration: noisy forward pass, greedy over E[Z]; plus
        # epsilon-greedy on top (the reference's custom trainer's
        # staircase-epsilon, dqn.py:275-276)
        noise = draws.tick_noise(net)
        with torch.no_grad():
            q = (torch.softmax(net(env.obs, noise), dim=-1) * z).sum(dim=-1)
        action = torch.argmax(q, dim=-1)
        b, dev = action.shape[0], action.device
        explore = draws.explore(b, dev, z.dtype) < epsilon
        action = torch.where(explore, draws.random_action(b, n_act, dev),
                             action)
        state.env, tr = env_step(env, action, cfg, state.world_rng,
                                 EnvKind.JERK,
                                 max_episode_length=cfg.MAX_EPISODE_LENGTH,
                                 wait_before_start=wait_before_start)
        # n-step staging: push this tick, emit the window head
        state.stage = stage_push(state.stage, tr)
        obs0, act0, ret_n, next_n, term_n, disc_n, valid_n = nstep_head(
            state.stage, RAINBOW_DISCOUNT)
        state.replay = rb.add_batch(state.replay, obs0, next_n, act0, ret_n,
                                    term_n, valid_n, init_pri,
                                    discount=disc_n)
        state.episodes = state.episodes + tr["done"].sum()
        state.frames = state.frames + tr["valid"].sum()

    # PER importance-sampling anneal (Schaul et al.: beta -> 1)
    beta = BETA_START + (1.0 - BETA_START) * torch.clamp_max(
        state.frames.to(torch.float32) / BETA_FRAMES, 1.0)
    if not state.learning:
        state.learning = bool(state.replay.size >= REPLAY_START)
    if state.learning:
        p = state.replay.priority
        for _ in range(grad_steps):
            idx, batch, weights = rb.sample_with_weights(
                state.replay, RAINBOW_BATCH, beta,
                u=draws.replay_uniform(RAINBOW_BATCH, p.dtype, p.device))
            if not cfg.USE_PRIORITIZED_ER:
                weights = None
            _, ce = _grad_step(net, state.target_net, state.opt, batch,
                               draws.step_noise(net), weights)
            if cfg.USE_PRIORITIZED_ER:
                rb.update_priorities(state.replay, idx, ce, cfg)
        state.grad_steps += grad_steps
    return state


def greedy_controller(net: RainbowNet, cfg: Settings):
    """Greedy eval controller mapping action -> jerk -> speed command
    (reference rainbow.py:75-79 + control.py:160-179).  Matrix products
    are pinned to true fp32."""
    pin_fp32_matmul()
    p = next(net.parameters())
    z = _support(p)
    table = torch.tensor(cfg.JERK_VALUES_DQN, dtype=p.dtype, device=p.device)

    def control(states):
        with torch.no_grad():
            logits = net(state_vector(states, cfg))
        q = (torch.softmax(logits, dim=-1) * z).sum(dim=-1)
        jerk = table[torch.argmax(q, dim=-1)]
        return _speed_from_jerk(states.ego_speed, states.ego_accel, jerk, cfg)

    return control


# ---------------------------------------------------------------------------
# task runners (reference rainbow.py:85-106, main.py:21-31)
# ---------------------------------------------------------------------------

def _eval_greedy(cfg: Settings, net: RainbowNet, num_episodes: int = 512):
    """Greedy-policy evaluation at EVALUATION_TICK_LENGTH on the net's
    device (the batched equivalent of reference dqn.py:282-285)."""
    from .. import tasks
    eval_cfg = cfg.replace(TICK_LENGTH=cfg.EVALUATION_TICK_LENGTH)
    p = next(net.parameters())
    agg = tasks.evaluate_controller(
        eval_cfg, greedy_controller(net, eval_cfg),
        num_episodes=num_episodes, dtype=p.dtype, device=p.device,
        max_episode_length=cfg.EVALUATION_EPISODE_LENGTH, verbose=False)
    avg = agg.get_stat_averages()
    return (avg["crashed"], avg["merged"], avg["mean_abs_jerk"],
            avg["time_to_merge"])


def _snapshot(net: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def _train_frames(cfg: Settings, state: RainbowTrainState, num_frames: float,
                  lr: float, verbose: bool = True, run=None,
                  eps_start: float = 1.0, eval_every_rounds: int = 10,
                  eval_episodes: int = 1024,
                  best: Optional[dict] = None) -> RainbowTrainState:
    """Advance training to ``num_frames`` valid env frames, refreshing the
    target network every TARGET_NET_FREEZE_PERIOD *episodes* (reference
    dqn.py:278-280).

    ``eps_start`` lets resumed / fine-tuning stages start the epsilon
    anneal from an already-low epsilon; ``best`` tracks the best-eval
    parameter snapshot like the DDPG trainer.  1024-episode selection
    evals: at 512 the crash SEM (~0.006 at the 0.02 level) is larger than
    the differences the selection must resolve."""
    from .budget import (frame_budget_rounds, grad_steps_per_round,
                         snapshot_score)
    batch = state.env.obs.shape[0]
    frames0 = int(state.frames)
    last_refresh_bucket = int(state.episodes) // cfg.TARGET_NET_FREEZE_PERIOD
    # learner cadence: the reference's TRAINING_STEPS_PER_EPISODE grad
    # steps per episode
    grad_steps = grad_steps_per_round(cfg.TRAINING_STEPS_PER_EPISODE,
                                      batch, TICKS_PER_ROUND)

    def do_eval(tag=""):
        crash, merge, jerk, t_merge = _eval_greedy(cfg, state.net,
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
                            params=_snapshot(state.net))

    evaluated = False
    for r in frame_budget_rounds(num_frames, TICKS_PER_ROUND * batch):
        # epsilon-greedy anneal eps_start -> EPS_END over the first half
        # of the frame budget (staircase-equivalent of reference dqn.py:275)
        frac = min((int(state.frames) - frames0) / (num_frames * 0.5), 1.0)
        eps = eps_start + (EPS_END - eps_start) * frac
        state = train_round(state, cfg, env_ticks=TICKS_PER_ROUND,
                            grad_steps=grad_steps, epsilon=eps)
        episodes = int(state.episodes)
        bucket = episodes // cfg.TARGET_NET_FREEZE_PERIOD
        if bucket != last_refresh_bucket:
            state.target_net.load_state_dict(state.net.state_dict())
            last_refresh_bucket = bucket
        frames = int(state.frames)
        evaluated = False
        if r % 10 == 0 or frames - frames0 >= num_frames:
            if verbose:
                print(f"  round {r} frames={frames}/{int(num_frames)} "
                      f"episodes={episodes}", flush=True)
            if run is not None:
                run.log_scalars(frames, {"episodes": episodes, "lr": lr})
        if eval_every_rounds and (r + 1) % eval_every_rounds == 0:
            do_eval()
            evaluated = True
        if frames - frames0 >= num_frames:
            break
    # a caller disabling periodic eval (eval_every_rounds=0) pays no final
    # selection eval either
    if eval_every_rounds and best is not None and not evaluated:
        do_eval(tag=", final")
    return state


def _net_from(cfg: Settings, state_dict: dict, device) -> RainbowNet:
    net = _net(cfg)
    net.load_state_dict(state_dict)
    return net.to(device).eval().requires_grad_(False)


def train(cfg: Settings, num_frames: float = 1e6, resume: bool = False,
          verbose: bool = True, eval_episodes: int = 1024, device="cuda"):
    """TRAIN_DQN / RESUME_DQN: ``train_rainbow_all_with_lr_drop``
    (reference rainbow.py:85-106).  Each stage writes its selected
    parameters to ``runs_torch/<LOG_DIR>/params.npz``.  Returns (final
    train state, the evaluation's StatsAggregator)."""
    from .. import tasks
    from ..rundir import setup_run_dir

    dev = resolve_device(device)
    pin_fp32_matmul()
    run = setup_run_dir(cfg)
    worlds, world_rng = tasks.make_worlds(cfg, device=dev)
    seed = tasks.seed_of(cfg)
    init = convert.rainbow_from_numpy(load_params(cfg.MODEL_NAME)["q_dist"]) \
        if resume else None
    state = make_train_state(cfg, worlds, world_rng, seed,
                             lr=cfg.LEARNING_RATE, init_params=init)
    best: dict = {}
    state = _train_frames(cfg, state, num_frames, cfg.LEARNING_RATE,
                          verbose, run=run,
                          eps_start=EPS_END if resume else 1.0,
                          eval_episodes=eval_episodes, best=best)
    stage1 = best.get("params") or _snapshot(state.net)
    save_params(run.path, {"q_dist": convert.tree_from_state_dict(stage1)})

    final = stage1
    if not resume:
        lr2 = cfg.LEARNING_RATE / 10.0
        cfg2 = cfg.replace(LOG_DIR=cfg.LOG_DIR + "_extended")
        run2 = setup_run_dir(cfg2, snapshot_src=False)
        worlds2, world_rng2 = tasks.make_worlds(cfg2, device=dev)
        state2 = make_train_state(cfg2, worlds2, world_rng2,
                                  derive_seed(seed), lr=lr2,
                                  init_params=stage1)
        state2 = _train_frames(cfg2, state2, num_frames, lr2, verbose,
                               run=run2, eps_start=EPS_END,
                               eval_episodes=eval_episodes, best=best)
        final = best.get("params") or _snapshot(state2.net)
        save_params(run2.path, {"q_dist": convert.tree_from_state_dict(final)})
        state = state2

    if verbose and best.get("score") is not None:
        print(f"  selected snapshot @ {best['frames']} frames "
              f"(crash={best['score'][1]:.4f} jerk={best['score'][2]:.3f})",
              flush=True)
    agg = evaluate(cfg, net=_net_from(cfg, final, dev), device=dev,
                   verbose=verbose)
    return state, agg


def evaluate(cfg: Settings, net: Optional[RainbowNet] = None, device="cuda",
             verbose: bool = True) -> StatsAggregator:
    """EVALUATE_DQN: the greedy Rainbow policy of ``cfg.MODEL_NAME`` drives
    the ego."""
    from .. import tasks
    dev = resolve_device(device)
    if net is None:
        net = _net_from(cfg, convert.rainbow_from_numpy(
            load_params(cfg.MODEL_NAME)["q_dist"]), dev)
    agg = tasks.evaluate_controller(cfg, greedy_controller(net.to(dev), cfg),
                                    device=dev, verbose=verbose)
    tasks.report(agg, cfg, verbose)
    return agg
