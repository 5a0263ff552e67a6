"""The JAX package's learning curves on the CPU, seed by seed: the
yardsticks that the port's curves on the card are held to
(``scripts/train_curve_torch.py --compare [--trainer rainbow]``).

    python scripts/jax_train_curve.py [--seeds 0 1 2 3] [--frames 4e5]
        [--out scripts/jax_train_yardsticks.json]
    python scripts/jax_train_curve.py --trainer rainbow [--seeds 0 1 2 3]
        [--frames 1e6] [--out scripts/jax_rainbow_yardsticks.json]

Each seed trains ``configs/train_default_1.json`` with ``SEED`` = seed and
``BATCH_SCENARIOS`` 128, stage 1 only, at ``LEARNING_RATE``:
``ddpg.make_train_state``, then ``ddpg._train_frames`` for ``--frames``
valid frames with a 2048-episode selection evaluation every 5 rounds (and
one of the final parameters).  A small recorder stands in as ``run``, so
the evaluations are logged without a run directory.  The selected snapshot
is then evaluated over 1024 episodes through ``tasks.evaluate_controller``,
the call that EVALUATE_DDPG makes (without its plots and CSV row).  Each
round is timed with the state synchronised.  The sizes, the recording and
the record's fields are those of ``scripts/train_curve_torch.py``, the
port's side.

``--out`` gets one record per seed, written as each seed ends; a seed
already there is skipped, so a cut run loses only the seed it was in.  The
script writes nothing else; run it from a copy of the tree (``git
archive``), so that no run directory of the checkout is touched.  A seed to
4e5 frames takes about ten minutes on 8 CPU cores.

``--trainer rainbow`` runs both stages of ``rainbow.train`` on
``configs/train_dqn_default_1.json`` (``SEED`` = seed, ``BATCH_SCENARIOS``
128) as it runs them: stage 1 at ``LEARNING_RATE`` from epsilon 1, stage 2
at a tenth of it from stage 1's selected snapshot at ``EPS_END``, each to
``--frames`` valid frames with a 1024-episode selection evaluation every
10 rounds, the selection carried from one stage into the next; then the
final selected snapshot is evaluated over 1024 episodes as
``rainbow.evaluate`` does (``tasks.evaluate_controller`` at the config's
own tick length).  ``--out`` gets one record per (seed, stage) under
``records``, written as each stage ends; a seed with both is skipped, and
a seed cut after its first stage runs both again.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from rl_mpc_lanemerging_tpu import tasks  # noqa: E402
from rl_mpc_lanemerging_tpu.agents import ddpg, rainbow  # noqa: E402
from rl_mpc_lanemerging_tpu.config import Settings  # noqa: E402
# the sizes and the recording that both sides share; the port's script
# imports no JAX
from train_curve_torch import (  # noqa: E402
    BATCH, CONFIG, DDPG_FRAMES, DDPG_YARDSTICKS, EVAL_EPISODES, EVAL_EVERY,
    FINAL_EPISODES, FRAMES, RAINBOW_CONFIG, RAINBOW_EPISODES,
    RAINBOW_EVAL_EVERY, RAINBOW_FRAMES, RAINBOW_YARDSTICKS, SEEDS, Recorder,
    curve_record, final_stats, rainbow_record, read_stages, stage_lr,
    stage_record, stage_schedule, timed_rounds)

OUT = os.path.join(REPO, "scripts", "jax_train_yardsticks.json")


def seed_config(seed: int, batch: int, overrides=None,
                config=CONFIG) -> Settings:
    return Settings.load_from_file(os.path.join(REPO, config)).replace(
        SEED=seed, BATCH_SCENARIOS=batch, **(overrides or {}))


def run_seed(seed: int, frames: float, batch: int = BATCH,
             eval_every: int = EVAL_EVERY, eval_episodes: int = EVAL_EPISODES,
             final_episodes: int = FINAL_EPISODES, overrides=None) -> dict:
    """Train one seed to ``frames`` and evaluate its selected snapshot."""
    cfg = seed_config(seed, batch, overrides)
    t0 = time.perf_counter()
    state = ddpg.make_train_state(cfg, tasks.make_worlds(cfg),
                                  tasks.seed_key(cfg), lr=cfg.LEARNING_RATE)
    run, best = Recorder(), {}
    seconds, restore = timed_rounds(ddpg, jax.block_until_ready)
    try:
        state = ddpg._train_frames(cfg, state, frames, cfg.LEARNING_RATE,
                                   verbose=True, run=run,
                                   eval_every_rounds=eval_every,
                                   eval_episodes=eval_episodes, best=best)
    finally:
        restore()
    train_s = time.perf_counter() - t0
    actor = best["params"][0]
    controller = jax.jit(ddpg.actor_controller(actor, cfg))
    agg = tasks.evaluate_controller(cfg, controller,
                                    num_episodes=final_episodes,
                                    verbose=False)
    return {**curve_record(seed, batch, frames, state, seconds, run, best,
                           final_stats(agg, final_episodes), eval_every,
                           eval_episodes),
            "train_s": train_s, "wall_s": time.perf_counter() - t0,
            "platform": "cpu", "cpu_count": os.cpu_count(),
            "jax": jax.__version__}


def run_rainbow(seed: int, frames: float, batch: int = BATCH,
                eval_every: int = RAINBOW_EVAL_EVERY,
                episodes: int = RAINBOW_EPISODES, overrides=None,
                on_stage=None) -> list:
    """Both stages of ``rainbow.train`` for one seed, and the final
    selected snapshot over ``episodes`` episodes; returns the two records
    (``on_stage`` gets each as its stage ends).  The selection evaluations
    are ``rainbow._train_frames``' own, of 1024 episodes."""
    cfg = seed_config(seed, batch, overrides, RAINBOW_CONFIG)
    rng = tasks.seed_key(cfg)
    init, best, records = None, {}, []
    for stage in (1, 2):
        t0 = time.perf_counter()
        lr, eps_start = stage_schedule(cfg, stage, rainbow.EPS_END)
        scfg = cfg if stage == 1 else cfg.replace(
            LOG_DIR=cfg.LOG_DIR + "_extended")
        key = rng if stage == 1 else jax.random.split(rng)[0]
        state = rainbow.make_train_state(scfg, tasks.make_worlds(scfg), key,
                                         lr=lr, init_params=init)
        run, frames_after = Recorder(), []
        seconds, restore = timed_rounds(rainbow, jax.block_until_ready,
                                        frames=frames_after)
        eval_seconds, restore_eval = timed_rounds(
            rainbow, jax.block_until_ready, "_eval_greedy")
        try:
            state = rainbow._train_frames(scfg, state, frames, lr,
                                          verbose=True, run=run,
                                          eps_start=eps_start,
                                          eval_every_rounds=eval_every,
                                          best=best)
        finally:
            restore()
            restore_eval()
        train_s = time.perf_counter() - t0
        selected = best["params"] if best.get("params") is not None \
            else state.params
        rec = rainbow_record(seed, stage, batch, frames, state, lr,
                             eps_start, seconds, frames_after, eval_seconds,
                             run, best,
                             1 if stage == 1 or selected is init else 2,
                             eval_every, RAINBOW_EPISODES)
        if stage == 2:
            t1 = time.perf_counter()
            controller = jax.jit(rainbow.greedy_controller(selected, cfg))
            agg = tasks.evaluate_controller(cfg, controller,
                                            num_episodes=episodes,
                                            verbose=False)
            rec.update(final=final_stats(agg, episodes),
                       final_s=time.perf_counter() - t1)
        rec.update(train_s=train_s, wall_s=time.perf_counter() - t0,
                   platform="cpu", cpu_count=len(os.sched_getaffinity(0)),
                   jax=jax.__version__)
        records.append(rec)
        if on_stage is not None:
            on_stage(rec)
        init = selected
    return records


def run_ddpg(seed: int, frames: float, batch: int = BATCH,
             eval_every: int = EVAL_EVERY, eval_episodes: int = EVAL_EPISODES,
             final_episodes: int = FINAL_EPISODES, overrides=None,
             on_stage=None) -> list:
    """Both stages of ``ddpg.train`` for one seed, and the final selected
    snapshot over ``final_episodes`` episodes; returns the two records
    (``on_stage`` gets each as its stage ends)."""
    cfg = seed_config(seed, batch, overrides)
    rng = tasks.seed_key(cfg)
    init, best, records = None, {}, []
    for stage in (1, 2):
        t0 = time.perf_counter()
        lr = stage_lr(cfg, stage)
        scfg = cfg if stage == 1 else cfg.replace(
            LOG_DIR=cfg.LOG_DIR + "_extended")
        key = rng if stage == 1 else jax.random.split(rng)[0]
        state = ddpg.make_train_state(scfg, tasks.make_worlds(scfg), key,
                                      lr=lr, init_params=init)
        run, frames_after = Recorder(), []
        seconds, restore = timed_rounds(ddpg, jax.block_until_ready,
                                        frames=frames_after)
        eval_seconds, restore_eval = timed_rounds(
            ddpg, jax.block_until_ready, "_eval_actor")
        try:
            state = ddpg._train_frames(scfg, state, frames, lr, verbose=True,
                                       run=run, eval_every_rounds=eval_every,
                                       eval_episodes=eval_episodes, best=best)
        finally:
            restore()
            restore_eval()
        train_s = time.perf_counter() - t0
        selected = best.get("params") or (state.actor_params,
                                          state.critic_params)
        rec = stage_record("ddpg", CONFIG, seed, stage, batch, frames, state,
                           lr, seconds, frames_after, eval_seconds, run, best,
                           1 if stage == 1 or selected is init else 2,
                           eval_every, eval_episodes)
        if stage == 2:
            t1 = time.perf_counter()
            controller = jax.jit(ddpg.actor_controller(selected[0], cfg))
            agg = tasks.evaluate_controller(cfg, controller,
                                            num_episodes=final_episodes,
                                            verbose=False)
            rec.update(final=final_stats(agg, final_episodes),
                       final_s=time.perf_counter() - t1)
        rec.update(train_s=train_s, wall_s=time.perf_counter() - t0,
                   platform="cpu", cpu_count=len(os.sched_getaffinity(0)),
                   jax=jax.__version__)
        records.append(rec)
        if on_stage is not None:
            on_stage(rec)
        init = selected
    return records


def load(path: str, empty: dict) -> dict:
    """The records in ``path``, or ``empty`` where there is no file."""
    if not os.path.exists(path):
        return empty
    with open(path) as fh:
        return json.load(fh)


def _save(path: str, data: dict) -> None:
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)


def _update(path: str, change) -> dict:
    """``change`` the records of ``path`` in place under a lock, so that
    several seeds, each in a process of its own, can share the file."""
    with open(path, "a+") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        fh.seek(0)
        text = fh.read()
        data = json.loads(text) if text.strip() else {"records": []}
        change(data)
        fh.seek(0)
        fh.truncate()
        json.dump(data, fh, indent=1)
        fh.flush()
        fcntl.flock(fh, fcntl.LOCK_UN)
    return data


def main_stages(args, runner, **sizes) -> dict:
    """Both stages of each seed through ``runner`` (``run_rainbow`` or
    ``run_ddpg``), one record per (seed, stage) under ``records``."""
    for seed in args.seeds:
        done = read_stages(load(args.out, {"records": []})["records"],
                           args.trainer)
        if all((seed, stage) in done and done[(seed, stage)]["frames_budget"]
               >= args.frames for stage in (1, 2)):
            print(f"seed {seed}: both stages already in {args.out}",
                  flush=True)
            continue

        def drop(data, seed=seed):
            data["records"] = [r for r in data["records"]
                               if r["seed"] != seed
                               or r.get("trainer") != args.trainer]

        _update(args.out, drop)

        def on_stage(rec, seed=seed):
            _update(args.out, lambda data: data["records"].append(rec))
            print(f"seed {seed} stage {rec['stage']}: {rec['frames']} frames "
                  f"in {rec['rounds']} rounds, "
                  f"{rec['s_per_round_median']:.2f} s per round (CPU); "
                  f"selected @ {rec['selected']['frames']} (stage "
                  f"{rec['selected']['stage']})", flush=True)

        final = runner(seed, args.frames, on_stage=on_stage,
                       **sizes)[-1]["final"]
        print(f"seed {seed}: crash {final['crash']:.4f} merge "
              f"{final['merge']:.4f} |jerk| {final['jerk']:.4f} over "
              f"{final['episodes']} episodes", flush=True)
    return load(args.out, {"records": []})


def main(argv=None, **sizes) -> dict:
    """``sizes``: ``run_seed``'s (``run_rainbow``'s) batch, evaluation and
    config overrides, for a run smaller than the yardstick's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trainer", choices=("ddpg", "rainbow"), default="ddpg")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--frames", type=float, default=None,
                    help="valid frames (per stage): 4e5 (ddpg), 1e6 "
                    "(rainbow)")
    ap.add_argument("--stage", choices=("1", "both"), default="1",
                    help="ddpg: stage 1 alone (the 4e5-frame curve), or "
                    "both stages of ddpg.train (rainbow: always both)")
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if args.trainer == "rainbow":
        args.frames = args.frames or RAINBOW_FRAMES
        args.out = args.out or RAINBOW_YARDSTICKS
        return main_stages(args, run_rainbow, **sizes)
    if args.stage == "both":
        args.frames = args.frames or DDPG_FRAMES
        args.out = args.out or DDPG_YARDSTICKS
        return main_stages(args, run_ddpg, **sizes)
    args.frames = args.frames or FRAMES
    args.out = args.out or OUT
    data = load(args.out, {"seeds": {}})
    for seed in args.seeds:
        if str(seed) in data["seeds"]:
            print(f"seed {seed}: already in {args.out}", flush=True)
            continue
        rec = run_seed(seed, args.frames, **sizes)
        data["seeds"][str(seed)] = rec
        _save(args.out, data)
        f = rec["final"]
        print(f"seed {seed}: {rec['frames']} frames in {rec['rounds']} "
              f"rounds, {rec['s_per_round_median']:.2f} s per round (CPU); "
              f"selected @ {rec['selected']['frames']}: crash "
              f"{f['crash']:.4f} merge {f['merge']:.4f} |jerk| "
              f"{f['jerk']:.4f} over {f['episodes']} episodes", flush=True)
    return data


if __name__ == "__main__":
    main()
