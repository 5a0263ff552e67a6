"""Rounds of the JAX package's evaluation on the CPU, at full width, with
per-round crash/merge/time-to-merge/|jerk| means and SEMs.

    python scripts/jax_st_round.py [batch] [seed] [rounds] [config]

``config`` defaults to ``configs/st_default.json`` (the pure-MPC ST task);
with an ``EVALUATE_COMBINED_*`` config (``configs/combined_default_1.json``)
the combined RL+MPC arbiter drives, with the actor of the config's
``MODEL_NAME`` restored from its orbax checkpoint, and the share of ticks the
MPC took is printed too.

A yardstick for the PyTorch port's result quality (PERF.md): it runs the
JAX package's current code, dense DP and all, as the port's parity tests
hold it.  Slow: one 48-scenario ST round takes ~8 minutes on 8 CPU cores,
and a combined round solves twice per tick.
"""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rl_mpc_lanemerging_tpu.config import Settings  # noqa: E402
from rl_mpc_lanemerging_tpu.planner import mpc  # noqa: E402
from rl_mpc_lanemerging_tpu.sim import episode, world  # noqa: E402


def main(batch=48, seed=0, rounds=1, config="configs/st_default.json"):
    cfg = Settings.load_from_file(config)
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    w = jax.vmap(lambda k: world.init_world(k, cfg, jnp.float32))(keys)
    carry = None
    if cfg.TASK.startswith("EVALUATE_COMBINED"):
        from rl_mpc_lanemerging_tpu.agents import combined, ddpg
        from rl_mpc_lanemerging_tpu.checkpoint import load_params
        policy = ddpg.actor_jerk(load_params(cfg.MODEL_NAME)["actor"], cfg)
        controller, init_carry, _ = combined.combined_controller(policy, cfg)
        carry = init_carry(batch) if init_carry else None
    else:
        controller = mpc.make_batched_controller(cfg)
    for r in range(rounds):
        t0 = time.time()
        out = episode.run_episode_batch(w, cfg, controller,
                                        controller_carry=carry)
        if carry is not None:
            carry = out[-1]
        w, s = out[:2]
        ticks = np.asarray(s.ticks)
        merged = np.asarray(s.merged)
        ttm = ticks[merged] * cfg.TICK_LENGTH
        jerk = np.asarray(s.sum_abs_jerk) / np.maximum(ticks, 1)
        print(f"round {r} wall {time.time() - t0:.1f} s: crash "
              f"{np.asarray(s.crashed).mean()} merge {merged.mean()} "
              f"time_to_merge {ttm.mean()} ± "
              f"{ttm.std(ddof=1) / np.sqrt(ttm.size)} mean_abs_jerk "
              f"{jerk.mean()} ± {jerk.std(ddof=1) / np.sqrt(jerk.size)} "
              f"percent_st_solver "
              f"{(np.asarray(s.aux_sum) / np.maximum(ticks, 1)).mean()}",
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]), *sys.argv[4:5])
