"""Rounds of the JAX package's ST evaluation on the CPU, at full st_default
width, with per-round crash/merge/time-to-merge/|jerk| means and SEMs.

    python scripts/jax_st_round.py [batch] [seed] [rounds]

A yardstick for the PyTorch port's result quality (PERF.md): it runs the
JAX package's current code, dense DP and all, as the port's parity tests
hold it.  Slow: one 48-scenario round takes ~8 minutes on 8 CPU cores.
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


def main(batch=48, seed=0, rounds=1):
    cfg = Settings.load_from_file("configs/st_default.json")
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    w = jax.vmap(lambda k: world.init_world(k, cfg, jnp.float32))(keys)
    controller = mpc.make_batched_controller(cfg)
    for r in range(rounds):
        t0 = time.time()
        w, s = episode.run_episode_batch(w, cfg, controller)
        ticks = np.asarray(s.ticks)
        merged = np.asarray(s.merged)
        ttm = ticks[merged] * cfg.TICK_LENGTH
        jerk = np.asarray(s.sum_abs_jerk) / np.maximum(ticks, 1)
        print(f"round {r} wall {time.time() - t0:.1f} s: crash "
              f"{np.asarray(s.crashed).mean()} merge {merged.mean()} "
              f"time_to_merge {ttm.mean()} ± "
              f"{ttm.std(ddof=1) / np.sqrt(ttm.size)} mean_abs_jerk "
              f"{jerk.mean()} ± {jerk.std(ddof=1) / np.sqrt(jerk.size)}",
              flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
