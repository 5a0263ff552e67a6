"""The combined lean at full width on the CPU: the port's arbiter against the
JAX package's on the same sensed states of combined_default_1, and the JAX
arbiter with its actor's matmuls at a TPU's default precision against the
same at float32.

    python scripts/lean_arbiter_study.py [--worlds 64] [--snapshots 4]
        [--out PATH]

The states: ``--worlds`` merge worlds of the port on the CPU, warmed up for
50 s, the ego added at 15 m/s and driven by the committed actor of
``runs/ddpg_default1_extended`` alone, sensed every 12 ticks,
``--snapshots`` times.  On each snapshot, three arbiters with every gate of
combined_default_1 at its full widths (18 x 3001 grids, 300 ADMM
iterations), float32, the dense DP on both sides (JAX ``use_pallas=False``):
the port's, the JAX package's, and the JAX package's with its actor's three
matmuls as a TPU runs a float32 ``jnp.dot`` at the default precision (one
bfloat16 pass: both operands rounded to bfloat16, the products summed in
float32).  Prints, and writes to ``--out`` as JSON, the takeover counts of
each, the states whose flags differ (port against JAX; bfloat16 against
float32, with the direction), and the largest speed gap where the flags
agree.  Needs jax and the JAX package; runs on the CPU, no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CONFIG = os.path.join(REPO, "configs", "combined_default_1.json")
MODEL = "runs/ddpg_default1_extended"
SNAPSHOT_EVERY = 12


def port_states(worlds: int, snapshots: int):
    """Sensed states of the port's worlds on the CPU, driven by the actor
    alone: one HighwayState of ``worlds`` rows a snapshot."""
    import torch
    from rl_mpc_lanemerging_torch.agents import ddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings
    from rl_mpc_lanemerging_torch.sim import (CounterRandom, add_ego,
                                              init_world, sense, warmup,
                                              world_step)
    cfg = Settings.load_from_file(CONFIG)
    actor = load_actor(MODEL, "cpu", cfg.MINIMUM_NEGATIVE_JERK,
                       cfg.MAXIMUM_POSITIVE_JERK, committed=True)
    drive = ddpg.actor_controller(actor, cfg)
    rng = CounterRandom(12)
    world = init_world(cfg, worlds, torch.float32, "cpu")
    world = warmup(world, cfg, int(50.0 / cfg.TICK_LENGTH), rng)
    world = add_ego(world, torch.full((worlds,), 15.0))
    out = []
    for tick in range(1, snapshots * SNAPSHOT_EVERY + 1):
        sensed = sense(world, cfg)
        if tick % SNAPSHOT_EVERY == 0:
            out.append(sensed)
        world = world_step(world, drive(sensed), cfg, rng)
    return out


def bf16_actor_jerk(params, cfg):
    """The JAX actor (``models/ddpg.py``) with each Dense layer's matmul as
    a TPU's default precision runs it: operands rounded to bfloat16,
    products summed in float32, the bias added in float32."""
    import jax
    import jax.numpy as jnp
    from rl_mpc_lanemerging_tpu.rl.obs import state_vector
    p = params["params"]
    low, high = cfg.MINIMUM_NEGATIVE_JERK, cfg.MAXIMUM_POSITIVE_JERK

    def dense(x, layer):
        return jnp.dot(x.astype(jnp.bfloat16),
                       layer["kernel"].astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) + layer["bias"]

    def policy(states):
        x = jax.vmap(lambda s: state_vector(s, cfg))(states)
        x = jax.nn.relu(dense(x, p["Dense_0"]))
        x = jax.nn.relu(dense(x, p["Dense_1"]))
        raw = dense(x, p["Dense_2"])
        return (0.5 * (high + low) + 0.5 * (high - low) * jnp.tanh(raw))[:, 0]

    return policy


def study(worlds: int, snapshots: int) -> dict:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from rl_mpc_lanemerging_torch.agents import combined as tcomb
    from rl_mpc_lanemerging_torch.agents import ddpg as tddpg
    from rl_mpc_lanemerging_torch.checkpoint import load_actor
    from rl_mpc_lanemerging_torch.config import Settings as TSettings
    from rl_mpc_lanemerging_tpu.agents import combined as jcomb
    from rl_mpc_lanemerging_tpu.agents import ddpg as jddpg
    from rl_mpc_lanemerging_tpu.checkpoint import load_params
    from rl_mpc_lanemerging_tpu.config import Settings
    from rl_mpc_lanemerging_tpu.prediction import HighwayState

    cfg, tcfg = Settings.load_from_file(CONFIG), TSettings.load_from_file(
        CONFIG)
    params = load_params(MODEL)["actor"]
    policies = {"jax_f32": jddpg.actor_jerk(params, cfg),
                "jax_bf16": bf16_actor_jerk(params, cfg)}
    controls = {name: jax.jit(lambda s, pol=pol: jcomb.combined_controller(
        pol, cfg, jnp.float32, use_pallas=False)[0](s)[:2])
        for name, pol in policies.items()}
    tactor = load_actor(MODEL, "cpu", tcfg.MINIMUM_NEGATIVE_JERK,
                        tcfg.MAXIMUM_POSITIVE_JERK, committed=True)
    tcontrol = tcomb.combined_controller(tddpg.actor_jerk(tactor, tcfg),
                                         tcfg)[0]
    t0 = time.perf_counter()
    states = port_states(worlds, snapshots)
    out = {"config": "configs/combined_default_1.json", "worlds": worlds,
           "snapshots": snapshots, "states_s": time.perf_counter() - t0}
    speed, take = {}, {}
    for k, s in enumerate(states):
        js = HighwayState(*(jnp.asarray(x.numpy()) for x in s))
        for name, control in controls.items():
            v, f = control(js)
            speed.setdefault(name, []).append(np.asarray(v))
            take.setdefault(name, []).append(np.asarray(f) > 0.5)
        v, f = tcontrol(s)
        speed.setdefault("port_f32", []).append(v.numpy())
        take.setdefault("port_f32", []).append(f.numpy() > 0.5)
        print(f"snapshot {k + 1}: takeovers " + json.dumps(
            {n: int(t[-1].sum()) for n, t in take.items()}), flush=True)
    speed = {n: np.concatenate(v) for n, v in speed.items()}
    take = {n: np.concatenate(v) for n, v in take.items()}
    out["states"] = int(take["port_f32"].size)
    out["takeovers"] = {n: int(t.sum()) for n, t in take.items()}
    for a, b in (("port_f32", "jax_f32"), ("jax_bf16", "jax_f32")):
        differ = take[a] != take[b]
        agree = ~differ
        out[f"{a}_vs_{b}"] = {
            "flags_differ": int(differ.sum()),
            "taken_by_first_alone": int((take[a] & ~take[b]).sum()),
            "taken_by_second_alone": int((~take[a] & take[b]).sum()),
            "max_speed_gap_where_agree": float(
                np.abs(speed[a] - speed[b])[agree].max()),
            "mean_speed_gap_where_agree": float(
                (speed[a] - speed[b])[agree].mean())}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, default=64)
    ap.add_argument("--snapshots", type=int, default=4)
    ap.add_argument("--out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    out = study(args.worlds, args.snapshots)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
