"""Rank bodies of the multi-process tests of the PyTorch port.

Each function here runs in every rank that ``parallel.sharded.spawn``
starts (2 ``gloo`` ranks on the CPU) and returns plain data.  This module
imports no JAX: a spawned rank re-imports the module of its target, and
re-importing a test file that imports ``jax`` would cost each rank
seconds.  The JAX halves of the parity tests stay in the pytest process
and hand their inputs over in a pickle.
"""

import glob
import os
import pickle

import torch
import torch.distributed as dist

from rl_mpc_lanemerging_torch import checkpoint, convert, tasks
from rl_mpc_lanemerging_torch.agents import ddpg, dqn
from rl_mpc_lanemerging_torch.config import Settings
from rl_mpc_lanemerging_torch.models.ddpg import DDPGActor, DDPGCritic
from rl_mpc_lanemerging_torch.models.mlp import DQNNet
from rl_mpc_lanemerging_torch.parallel import sharded, tp
from rl_mpc_lanemerging_torch.parallel.mesh import (make_mesh, padded_batch,
                                                    scenario_sharding,
                                                    shard_batch)
from rl_mpc_lanemerging_torch.planner import mpc

torch.set_num_threads(1)

# the JAX suite's small settings (tests/test_sharded.py)
TINY = Settings().replace(
    FUTURE_S=3.0, FUTURE_T=1.5, MAX_CARS=8, MAX_SENSED_CARS=8,
    QP_ITERATIONS=5, BATCH_SCENARIOS=16, SEED=7)
EVAL = dict(num_episodes=16, batch=16, max_episode_length=30.0,
            wait_before_start=5.0, verbose=False, device="cpu")
CRASH_SPEED = 6.0          # a slow constant controller: 5 of 16 crash
DP_REPLAY_START = 32       # a small warm-up so that the updates run
TP_CRITIC = "runs/ddpg_default1_extended"


def constant_controller(speed):
    def control(states):
        return torch.full_like(states.ego_speed, speed)
    return control


def evaluate(controller, mesh="auto", **kw):
    """The columns of a TINY evaluation (rank 0, or one process); None on
    the other ranks."""
    agg = tasks.evaluate_controller(TINY, controller, mesh=mesh,
                                    **dict(EVAL, **kw))
    return None if agg is None else {k: list(v)
                                     for k, v in agg.columns.items()}


def torch_ddpg(ap, cp, lr):
    """float64 actor and critic from Flax trees, fresh targets and Adam."""
    cfg = Settings()
    actor = DDPGActor(cfg.obs_dim, cfg.MINIMUM_NEGATIVE_JERK,
                      cfg.MAXIMUM_POSITIVE_JERK)
    critic = DDPGCritic(cfg.obs_dim)
    actor.load_state_dict(convert.ddpg_actor_from_numpy(ap))
    critic.load_state_dict(convert.ddpg_critic_from_numpy(cp))
    actor, critic = actor.double(), critic.double()
    return (actor, critic, DDPGActor(cfg.obs_dim).double(),
            DDPGCritic(cfg.obs_dim).double(), ddpg._adam(actor, lr),
            ddpg._adam(critic, lr))


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _params(module):
    return convert.tree_from_state_dict(module.state_dict())["params"]


def dp_updates(path):
    """The DDPG updates and DQN grad steps of the pickle at ``path``, each
    on this rank's batches with the gradients averaged over the ranks."""
    with open(path, "rb") as fh:
        d = pickle.load(fh)
    group, rank, _ = sharded.axis_group(make_mesh("cpu"))
    out = {}
    actor, critic, t_actor, t_critic, a_opt, c_opt = torch_ddpg(
        d["ap"], d["cp"], d["lr"])
    t_actor.load_state_dict(convert.ddpg_actor_from_numpy(d["ta"]))
    t_critic.load_state_dict(convert.ddpg_critic_from_numpy(d["tc"]))
    for batches in d["ddpg_batches"]:
        ddpg._update(actor, critic, t_actor, t_critic, a_opt, c_opt,
                     _tensors(batches[rank]), group)
    out["ddpg"] = {"actor": _params(actor), "critic": _params(critic),
                   "target_actor": _params(t_actor),
                   "target_critic": _params(t_critic)}

    cfg = Settings.load_from_file(d["dqn_config"]).replace(**d["dqn_small"])
    net = DQNNet(cfg.obs_dim, len(cfg.JERK_VALUES_DQN))
    net.load_state_dict(convert.dqn_from_numpy(d["q"]))
    target = DQNNet(cfg.obs_dim, len(cfg.JERK_VALUES_DQN))
    target.load_state_dict(convert.dqn_from_numpy(d["q_target"]))
    net, target = net.double(), target.double().requires_grad_(False)
    opt = ddpg._adam(net, cfg.LEARNING_RATE)
    losses, tds = [], []
    for batches in d["dqn_batches"]:
        loss, td = dqn._grad_step(net, target, opt, _tensors(batches[rank]),
                                  cfg, group)
        losses.append(float(loss))
        tds.append(td.numpy())
    out["dqn"] = {"q": _params(net), "loss": losses, "td": tds}
    return out


def _learning_ticks(state, ticks, step):
    """Advance ``state`` one tick (or round) at a time; return the replay
    size after each."""
    sizes = []
    for _ in range(ticks):
        state = step(state)
        sizes.append(int(state.replay.size))
    return sizes


def sharded_training(seed):
    """Both trainers' ``make_sharded_train`` rounds, then each trainer with
    ranks of different batch sizes, whose replays cross the learning
    threshold on different ticks: what each rank ends with, and every
    rank's parameters gathered on rank 0."""
    mesh = make_mesh("cpu")
    group, rank, _ = sharded.axis_group(mesh)
    ddpg.REPLAY_START = DP_REPLAY_START
    out = {}

    cfg = TINY.replace(BATCH_SCENARIOS=4)
    state, round_fn = ddpg.make_sharded_train(
        cfg, mesh, seed, lr=1e-3, env_ticks=24, updates_per_tick=2,
        wait_before_start=1.0)
    for _ in range(2):
        state = round_fn(state)
    out["ddpg"] = {"obs": state.env.obs, "frames": int(state.frames),
                   "updates": state.updates,
                   "actors": sharded.gather_state_dicts(state.actor, mesh),
                   "critics": sharded.gather_state_dicts(state.critic, mesh)}

    dcfg = cfg.replace(BATCH_SIZE=16)
    dstate, dround = dqn.make_sharded_train(
        dcfg, mesh, seed, env_ticks=24, grad_steps=2, wait_before_start=1.0)
    dstate = dround(dstate)
    out["dqn"] = {"obs": dstate.env.obs, "grad_steps": dstate.grad_steps,
                  "nets": sharded.gather_state_dicts(dstate.net, mesh)}

    # rank 0 steps 4 scenarios, rank 1 only 2
    batch = 4 if rank == 0 else 2
    worlds, wrng = tasks.make_worlds(cfg.replace(SEED=7 + rank), batch,
                                     torch.float64, "cpu")
    state = ddpg.make_train_state(cfg, worlds, wrng,
                                  sharded.rank_seed(seed, rank), lr=1e-3,
                                  wait_before_start=1.0)
    sharded.broadcast_modules((state.actor, state.critic), mesh)
    updates = []

    def ddpg_tick(s):
        s = ddpg.train_round(s, cfg, env_ticks=1, updates_per_tick=2,
                             wait_before_start=1.0, group=group)
        updates.append(s.updates)
        return s

    sizes = _learning_ticks(state, 40, ddpg_tick)
    out["ddpg_uneven"] = {
        "sizes": sizes, "updates": updates,
        "actors": sharded.gather_state_dicts(state.actor, mesh)}

    worlds, wrng = tasks.make_worlds(cfg.replace(SEED=7 + rank), batch,
                                     torch.float64, "cpu")
    dstate = dqn.make_train_state(dcfg, worlds, wrng,
                                  sharded.rank_seed(seed, rank),
                                  wait_before_start=1.0)
    sharded.broadcast_modules((dstate.net,), mesh)
    steps = []

    def dqn_round(s):
        s = dqn.train_round(s, dcfg, env_ticks=2, grad_steps=2,
                            wait_before_start=1.0, group=group)
        steps.append(s.grad_steps)
        return s

    sizes = _learning_ticks(dstate, 12, dqn_round)
    out["dqn_uneven"] = {"sizes": sizes, "grad_steps": steps,
                         "nets": sharded.gather_state_dicts(dstate.net, mesh)}
    return out


def tp_critic(obs, action):
    """The committed critic, in float64, split by ``mlp_tp_rules`` over a
    (1, 2) ("scenario", "model") mesh against the whole critic on (obs,
    action):
    the largest gap, the placements the rules predict and those the
    parameters got."""
    mesh = make_mesh("cpu", (1, 2), ("scenario", "model"))
    tree = checkpoint.load_params(TP_CRITIC, committed=True)["critic"]
    whole, split = DDPGCritic().double(), DDPGCritic().double()
    for m in (whole, split):
        m.load_state_dict(convert.ddpg_critic_from_numpy(tree))
    rules = tp.mlp_tp_rules()
    want = tp.param_path_specs(split, rules)
    tp.shard_params(split, mesh, rules)
    got = {n: tuple(getattr(p, "placements", ())) for n, p in
           split.named_parameters()}
    obs, action = torch.as_tensor(obs), torch.as_tensor(action)
    obs, action = obs.double(), action.double()
    with torch.no_grad():
        gap = float((split(obs, action) - whole(obs, action)).abs().max())
    return {"gap": gap, "want": {k: str(v) for k, v in want.items()},
            "got": {k: [str(p) for p in v] for k, v in got.items()}}


def parallel_suite(inputs):
    """Everything the 2-rank parity tests check, in one spawn."""
    with open(inputs, "rb") as fh:
        d = pickle.load(fh)
    run_dir = os.path.join(d["tmp"], "dumps")
    mesh = make_mesh("cpu")
    out = {"rank": dist.get_rank(),
           "shard": {"slice": shard_batch({"x": torch.arange(24).view(8, 3),
                                           "s": torch.tensor(5)}, mesh),
                     "padded": padded_batch(7, mesh),
                     "placements": [str(p) for p in
                                    scenario_sharding(mesh)]},
           "eval": evaluate(constant_controller(8.0)),
           "eval_crash": evaluate(constant_controller(CRASH_SPEED),
                                 save_state_on_crash=True, run_dir=run_dir),
           "eval_mpc": evaluate(mpc.make_batched_controller(TINY)),
           "dp": dp_updates(d["dp"]),
           "train": sharded_training(0),
           "tp": tp_critic(d["tp_obs"], d["tp_action"])}
    dist.barrier()
    out["dumps"] = sorted(os.path.basename(p) for p in
                          glob.glob(os.path.join(run_dir, "*.pkl")))
    return out


def card_collectives():
    """The collectives of the scenario mesh on CUDA tensors over ``gloo``
    (two ranks sharing one card): the gradient mean, the agreed minimum and
    rank 0's parameters broadcast, each returned with its device."""
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh("cuda")
    group, rank, _ = sharded.axis_group(mesh)
    grads = [torch.full((3, 2), float(rank + 1), device=dev),
             torch.arange(4.0, device=dev) * (rank + 1)]
    avg = sharded.average_gradients(grads, group)
    low = sharded.agree_min(torch.tensor(10 + rank, device=dev), group)
    layer = torch.nn.Linear(3, 2).to(dev)
    with torch.no_grad():
        layer.weight.fill_(float(rank))
    sharded.broadcast_modules((layer,), mesh)
    return {"avg": avg, "min": low, "weight": layer.weight,
            "devices": [str(avg[0].device), str(layer.weight.device)]}
