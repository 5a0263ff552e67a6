"""The combined lean on the card: combined_default_1 with its actor's three
matmuls as a TPU runs a float32 ``jnp.dot`` at JAX's default precision (one
bfloat16 pass: both operands rounded to bfloat16, the products summed in
float32), beside the port's own row of the same episodes.

    python scripts/lean_bf16_actor_torch.py [--episodes 1024]
        [--csv runs_torch/lean_bf16/run_data_torch.csv] [--paired]

The JAX rows ran on a TPU, where the actor's Dense layers take that
precision (only ``ops/qp.py`` asks for ``HIGHEST``); the port's actor runs
in true float32.  This runs ``paper_table_torch.run_one`` (``main.do_task``
on the card; it raises without one) at the JAX row's batch with the port's
actor forward replaced for the run and nothing else changed: the same ``SEED`` and batch, so the
same scenarios as the port's row of the same episodes until a command
differs.  Its row goes to ``--csv`` under ``LOG_DIR``
combined_default_1_bf16_actor, ``run_one``'s record (with each round's
statistics) to the CSV's ``.jsonl`` twin; it prints the
row beside the port's newest ``combined_default_1`` row of the same
episodes in ``run_data_torch.csv`` and the JAX row.  ``--paired`` first
runs the float32 actor on the same scenarios (``LOG_DIR``
combined_default_1_f32_actor), keeps both runs' per-episode columns
(``<csv>_f32.npz``, ``<csv>_bf16.npz``) and writes the paired per-episode
difference, bfloat16 - float32, with its SEM to ``<csv>_paired.json``.
The 1024-episode runs on an H100 are kept in ``scripts/lean_bf16_actor/``
(``paired/``: the ``--paired`` run).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

NAME = "combined_default_1"
LOG_DIR = "combined_default_1_bf16_actor"
F32_LOG_DIR = "combined_default_1_f32_actor"
CSV = os.path.join(REPO, "runs_torch", "lean_bf16", "run_data_torch.csv")


def bf16_forward(layers, x):
    """``models.ddpg._forward`` with each Linear's matmul on bfloat16-rounded
    operands, the products summed in float32 and the bias added in
    float32."""
    import torch

    def dense(name, v):
        layer = layers[name]
        return torch.nn.functional.linear(
            v.bfloat16().float(), layer.weight.bfloat16().float(),
            layer.bias)

    x = torch.relu(dense("Dense_0", x))
    x = torch.relu(dense("Dense_1", x))
    return dense("Dense_2", x)


def paired_difference(f32: dict, bf16: dict) -> dict:
    """Per metric, ``_mean_sem`` of bf16 - f32 episode by episode over the
    same scenarios: crash, merge, |jerk| and percent ST over every episode,
    time to merge over the episodes that merged in both."""
    import paper_table_torch as pt
    out = {k: pt._mean_sem(np.subtract(bf16[k], f32[k]))
           for k in ("crashed", "merged", "mean_abs_jerk",
                     "percent st solver") if k in f32 and k in bf16}
    both = (np.asarray(f32["merged"]) > 0) & (np.asarray(bf16["merged"]) > 0)
    out["time_to_merge"] = pt._mean_sem(
        np.subtract(bf16["time_taken"], f32["time_taken"])[both])
    return out


def run(episodes: int, csv_path: str, paired: bool = False) -> dict:
    """One evaluation with the bfloat16 actor through
    ``paper_table_torch.run_one`` (with ``paired``, after one with the
    float32 actor, and their paired difference); returns its record."""
    import torch
    import paper_table_torch as pt
    from rl_mpc_lanemerging_torch.models import ddpg as models
    if not torch.cuda.is_available():
        raise RuntimeError("this runs on the card: "
                           "torch.cuda.is_available() is False")
    jax_rows = pt.newest_rows(pt.read_rows(pt.JAX_CSV), pt.MIN_JAX_EPISODES)
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    base = os.path.splitext(csv_path)[0]
    card = pt.card_line()
    if paired:
        pt.run_one(NAME, episodes, csv_path, jax_rows, card,
                   log_dir=F32_LOG_DIR, episodes_out=base + "_f32.npz")
    real = models._forward
    models._forward = bf16_forward
    try:
        record = pt.run_one(NAME, episodes, csv_path, jax_rows, card,
                            log_dir=LOG_DIR, episodes_out=base + "_bf16.npz"
                            if paired else None)
    finally:
        models._forward = real
    row = pt.newest_rows(pt.read_rows(csv_path))[LOG_DIR]
    port = [r for r in pt.read_rows(pt.PORT_CSV) if r["LOG_DIR"] == NAME
            and pt._episodes(r) == episodes]
    sides = [("bfloat16 actor", row)] + (
        [("port, float32 actor, line "
          f"{max(port, key=lambda r: r['TIME'])['_line']}",
          max(port, key=lambda r: r["TIME"]))] if port else []) + [
        (f"JAX, run_data.csv line {jax_rows[NAME]['_line']}",
         jax_rows[NAME])]
    for label, r in sides:
        print(f"{label}: " + "; ".join(
            f"{name} {pt._cell(pt._value(r, m), pt._value(r, m + '_std'))}"
            for m, name in pt.METRICS), flush=True)
    if paired:
        diff = paired_difference(*(dict(np.load(f"{base}_{side}.npz"))
                                   for side in ("f32", "bf16")))
        with open(base + "_paired.json", "w") as fh:
            json.dump({"episodes": episodes, "card": card,
                       "bf16_minus_f32": diff}, fh, indent=1)
        print("paired, bfloat16 - float32, episode by episode: "
              + json.dumps(diff), flush=True)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=1024)
    ap.add_argument("--csv", default=CSV, metavar="PATH")
    ap.add_argument("--paired", action="store_true",
                    help="run the float32 actor first on the same scenarios "
                    "and write the paired per-episode difference")
    args = ap.parse_args(argv)
    run(args.episodes, args.csv, args.paired)


if __name__ == "__main__":
    main()
