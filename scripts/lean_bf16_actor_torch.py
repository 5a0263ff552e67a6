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
(``paired/``: the ``--paired`` run; ``paired4000/``: the ``--paired`` run at
the JAX row's own 4000 episodes).  ``--config dqn_custom_default1`` does the
same for the committed custom DQN of ``paper_table_torch.py``'s
``custom_dqn`` family (its Q network's two matmuls; LOG_DIRs
dqn_custom_default1_f32_q and dqn_custom_default1_bf16_q), held to
``run_data.csv`` line 218 (its run: ``scripts/lean_bf16_actor/dqn_custom/``).

    python scripts/lean_bf16_actor_torch.py --decide DIR
        [--acceptance ACCEPTANCE_TORCH.md]

``--decide`` (no card) holds a ``--paired`` run's CSV in ``DIR`` to the
lean's rule and writes the section "Combined lean: the actor at a TPU's
bfloat16 precision" of ``--acceptance`` (the rest of the file as it is):
its float32 row must equal the port's row of the same episodes in
``run_data_torch.csv`` on every statistic (the clock columns aside), and
for each of time to merge, |jerk| and percent ST the JAX row's value must
lie between the port's row and the bfloat16 row, or within 3 SEM of the
difference from the bfloat16 row.  All three met: the lean is the TPU
rows' numerics.
"""

from __future__ import annotations

import argparse
import contextlib
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
# the committed custom DQN of paper_table_torch.py's custom_dqn family,
# its Q network at the TPU's precision in place of the actor
DQN_NAME = "dqn_custom_default1"
LOG_DIRS = {NAME: (F32_LOG_DIR, LOG_DIR),
            DQN_NAME: ("dqn_custom_default1_f32_q",
                       "dqn_custom_default1_bf16_q")}
CSV = os.path.join(REPO, "runs_torch", "lean_bf16", "run_data_torch.csv")


def _dense(layer, v):
    """``layer(v)`` with its matmul on bfloat16-rounded operands, the
    products summed in float32 and the bias added in float32."""
    import torch
    return torch.nn.functional.linear(
        v.bfloat16().float(), layer.weight.bfloat16().float(), layer.bias)


def bf16_forward(layers, x):
    """``models.ddpg._forward`` with each Linear's matmul as ``_dense``."""
    import torch
    x = torch.relu(_dense(layers["Dense_0"], x))
    x = torch.relu(_dense(layers["Dense_1"], x))
    return _dense(layers["Dense_2"], x)


def bf16_dqn_forward(net, x, deterministic: bool = True):
    """``models.mlp.DQNNet.forward`` with each Linear's matmul as
    ``_dense``."""
    import torch
    *hidden, head = net.layers.values()
    for layer in hidden:
        x = _dense(layer, x)
        if net.dropout:
            x = torch.nn.functional.dropout(x, 0.5, training=not deterministic)
        x = torch.relu(x)
    return _dense(head, x)


@contextlib.contextmanager
def bf16_network(name: str):
    """The network of ``name`` (the combined config's actor, or the custom
    DQN's Q network) at the TPU's precision while inside."""
    from rl_mpc_lanemerging_torch.models import ddpg, mlp
    module, attr, fake = (ddpg, "_forward", bf16_forward) if name == NAME \
        else (mlp.DQNNet, "forward", bf16_dqn_forward)
    real = getattr(module, attr)
    setattr(module, attr, fake)
    try:
        yield
    finally:
        setattr(module, attr, real)


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


def run(episodes: int, csv_path: str, paired: bool = False,
        name: str = NAME) -> dict:
    """One evaluation of ``name`` with its network at the TPU's precision
    through ``paper_table_torch.run_one`` (with ``paired``, after one with
    the float32 network, and their paired difference); returns its
    record."""
    import torch
    import paper_table_torch as pt
    if not torch.cuda.is_available():
        raise RuntimeError("this runs on the card: "
                           "torch.cuda.is_available() is False")
    jax_rows = pt.newest_rows(pt.read_rows(pt.JAX_CSV), pt.MIN_JAX_EPISODES)
    os.makedirs(os.path.dirname(os.path.abspath(csv_path)), exist_ok=True)
    base = os.path.splitext(csv_path)[0]
    card = pt.card_line()
    f32_log_dir, log_dir = LOG_DIRS[name]
    if paired:
        pt.run_one(name, episodes, csv_path, jax_rows, card,
                   log_dir=f32_log_dir, episodes_out=base + "_f32.npz")
    with bf16_network(name):
        record = pt.run_one(name, episodes, csv_path, jax_rows, card,
                            log_dir=log_dir, episodes_out=base + "_bf16.npz"
                            if paired else None)
    row = pt.newest_rows(pt.read_rows(csv_path))[log_dir]
    port = [r for r in pt.read_rows(pt.PORT_CSV) if r["LOG_DIR"] == name
            and pt._episodes(r) == episodes]
    sides = [("bfloat16 network", row)] + (
        [("port, float32 network, line "
          f"{max(port, key=lambda r: r['TIME'])['_line']}",
          max(port, key=lambda r: r["TIME"]))] if port else []) + [
        (f"JAX, run_data.csv line {jax_rows[name]['_line']}",
         jax_rows[name])]
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


SECTION = "## Combined lean: the actor at a TPU's bfloat16 precision"
DQN_SECTION = "## Custom DQN: the network at a TPU's bfloat16 precision"
# the legs each run is held on: (the CSV's column, the paired file's key,
# label); the lean's, and the custom DQN's flagged ones
LEGS = (("time_to_merge", "time_to_merge", "time to merge (s)"),
        ("mean_abs_jerk", "mean_abs_jerk", "mean abs jerk"),
        ("percent st solver", "percent st solver", "percent st solver"))
DQN_LEGS = (("crashed", "crashed", "crash"), ("merged", "merged", "merge"),
            ) + LEGS[:2]
# per name: its section, legs, and verdict where all legs are met or not
RULES = {NAME: (SECTION, LEGS, "closed: TPU numerics",
                "not closed: bisect the full width on the CPU"),
         DQN_NAME: (DQN_SECTION, DQN_LEGS, "filed: TPU numerics",
                    "not filed: a port fault until shown otherwise")}


def _statistics(row: dict) -> dict:
    """A CSV row's statistics: every column with a value but the clock
    columns and the run's own names (a CSV pads a column that another of
    its rows brought with empty values)."""
    return {k: v for k, v in row.items() if k not in ("_line", "TIME",
                                                      "LOG_DIR")
            and not k.startswith("clock_time") and v not in ("", None)}


def leg_holds(port: float, bf16: float, bf16_sem: float, jax: float,
              jax_sem: float) -> tuple:
    """(JAX's value lies between the port's and the bfloat16 row's, it
    lies within 3 SEM of the difference from the bfloat16 row)."""
    return (min(port, bf16) <= jax <= max(port, bf16),
            abs(jax - bf16) <= 3 * (bf16_sem ** 2 + jax_sem ** 2) ** 0.5)


def decide(folder: str, acceptance: str, name: str = NAME) -> str:
    """Hold the ``--paired`` run of ``name`` in ``folder`` to the lean's
    rule and write its section into ``acceptance``; returns the
    verdict."""
    import paper_table_torch as pt
    section, legs, met_all, not_met = RULES[name]
    rows = pt.newest_rows(pt.read_rows(os.path.join(folder,
                                                    "run_data_torch.csv")))
    f32, bf16 = (rows[log_dir] for log_dir in LOG_DIRS[name])
    episodes = pt._episodes(f32)
    port = max((r for r in pt.read_rows(pt.PORT_CSV) if r["LOG_DIR"] == name
                and pt._episodes(r) == episodes), key=lambda r: r["TIME"])
    jax = pt.newest_rows(pt.read_rows(pt.JAX_CSV),
                         pt.MIN_JAX_EPISODES)[name]
    with open(os.path.join(folder, "run_data_torch_paired.json")) as fh:
        paired = json.load(fh)
    same = _statistics(f32) == _statistics(port)
    where = os.path.relpath(os.path.abspath(folder), REPO)
    flag = "--config " + name + " " if name != NAME else ""
    lines = [
        section, "",
        "Generated by `python scripts/lean_bf16_actor_torch.py "
        f"{flag}--decide {where}` from that folder's `--paired` run "
        f"({episodes} episodes of {name} at B={f32['BATCH_SCENARIOS']} on "
        f"{paired['card']}): the network's matmuls on bfloat16-rounded "
        "operands, as a TPU runs JAX's default precision, beside the same "
        "scenarios with the float32 network. **The rule, written before "
        "the run:** the float32 row equals the port's row of the same "
        f"episodes (`run_data_torch.csv` line {port['_line']}) on every "
        f"statistic, and for each leg JAX's value (line {jax['_line']}) "
        "lies between the port's row and the bfloat16 row, or within 3 SEM "
        "of the difference from the bfloat16 row. Every leg met: the gap is "
        "the TPU rows' numerics.", "",
        f"The float32 row equals line {port['_line']} on all "
        f"{len(_statistics(f32))} statistics: {'yes' if same else 'no'}.",
        "", "| leg | port, float32 | bfloat16 | JAX | bfloat16 - float32, "
        "paired | between | within 3 SEM | met |",
        "| --- " * 8 + "|"]
    met = []
    for column, key, label in legs:
        v = {side: (pt._value(r, column), pt._value(r, column + "_std"))
             for side, r in (("port", port), ("bf16", bf16), ("jax", jax))}
        between, near = leg_holds(v["port"][0], *v["bf16"], *v["jax"])
        met.append(between or near)
        d = paired["bf16_minus_f32"][key]
        lines.append(f"| {label} | " + " | ".join(
            pt._cell(*v[side]) for side in ("port", "bf16", "jax"))
            + f" | {d['mean']:+.5f} ± {d['sem']:.5f} | "
            f"{'yes' if between else 'no'} | {'yes' if near else 'no'} | "
            f"{'yes' if met[-1] else 'no'} |")
    verdict = met_all if same and all(met) else not_met
    lines += ["", f"**Verdict: {verdict}.**", ""]
    pt.put_section(acceptance, section, "\n".join(lines) + "\n")
    return verdict


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(LOG_DIRS), default=NAME,
                    help="the combined config's actor (the lean), or the "
                    "custom DQN's Q network")
    ap.add_argument("--decide", default=None, metavar="DIR",
                    help="hold the --paired run in DIR to the lean's rule "
                    "and write its section (no card)")
    ap.add_argument("--acceptance", default=os.path.join(
        REPO, "ACCEPTANCE_TORCH.md"), metavar="PATH")
    ap.add_argument("--episodes", type=int, default=1024)
    ap.add_argument("--csv", default=CSV, metavar="PATH")
    ap.add_argument("--paired", action="store_true",
                    help="run the float32 actor first on the same scenarios "
                    "and write the paired per-episode difference")
    args = ap.parse_args(argv)
    if args.decide:
        print(f"{args.config}: "
              f"{decide(args.decide, args.acceptance, args.config)}")
        return
    run(args.episodes, args.csv, args.paired, args.config)


if __name__ == "__main__":
    main()
