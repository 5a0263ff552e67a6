"""The JAX package's DDPG learning curve on the CPU, seed by seed: the
yardstick that the port's curve on the card is held to
(``scripts/train_curve_torch.py --compare``).

    python scripts/jax_train_curve.py [--seeds 0 1 2 3] [--frames 4e5]
        [--out scripts/jax_train_yardsticks.json]

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
"""

from __future__ import annotations

import argparse
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
from rl_mpc_lanemerging_tpu.agents import ddpg  # noqa: E402
from rl_mpc_lanemerging_tpu.config import Settings  # noqa: E402
# the sizes and the recording that both sides share; the port's script
# imports no JAX
from train_curve_torch import (  # noqa: E402
    BATCH, CONFIG, EVAL_EPISODES, EVAL_EVERY, FINAL_EPISODES, FRAMES, SEEDS,
    Recorder, curve_record, final_stats, timed_rounds)

OUT = os.path.join(REPO, "scripts", "jax_train_yardsticks.json")


def seed_config(seed: int, batch: int, overrides=None) -> Settings:
    return Settings.load_from_file(os.path.join(REPO, CONFIG)).replace(
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


def load(path: str) -> dict:
    if not os.path.exists(path):
        return {"seeds": {}}
    with open(path) as fh:
        return json.load(fh)


def main(argv=None, **sizes) -> dict:
    """``sizes``: ``run_seed``'s batch, evaluation and config overrides,
    for a run smaller than the yardstick's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--frames", type=float, default=FRAMES)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    data = load(args.out)
    for seed in args.seeds:
        if str(seed) in data["seeds"]:
            print(f"seed {seed}: already in {args.out}", flush=True)
            continue
        rec = run_seed(seed, args.frames, **sizes)
        data["seeds"][str(seed)] = rec
        with open(args.out, "w") as fh:
            json.dump(data, fh, indent=1)
        f = rec["final"]
        print(f"seed {seed}: {rec['frames']} frames in {rec['rounds']} "
              f"rounds, {rec['s_per_round_median']:.2f} s per round (CPU); "
              f"selected @ {rec['selected']['frames']}: crash "
              f"{f['crash']:.4f} merge {f['merge']:.4f} |jerk| "
              f"{f['jerk']:.4f} over {f['episodes']} episodes", flush=True)
    return data


if __name__ == "__main__":
    main()
