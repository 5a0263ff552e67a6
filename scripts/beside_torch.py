"""A segment of the custom DQN's stage and Rainbow's stages of other seeds,
beside each other on one card, with a guard on the DQN's rounds.

    python scripts/beside_torch.py --dir chiprun_out/beside [--stages 1 2]
        [--time-limit 3300] [--alone]

Both jobs are ``scripts/train_curve_torch.py --run``: the custom DQN's
seeds 0-3 resume from their last handoffs in ``runs_torch/curve_dqn`` and
end their segment before ``--time-limit`` seconds, with handoffs in
``<dir>/curve_dqn``; Rainbow's seeds 4-7 run ``--stages`` one after the
other, their snapshots in ``<dir>/curve_rainbow`` (stage 2 starts from
stage 1's there, copied from ``runs_torch/curve_rainbow`` where this run
made none).  Both append their records to
``<dir>/run_data_torch_train.jsonl``, a copy of the repository's at the
start; each seed logs beside it.

The guard: once every DQN seed has run ``GUARD_ROUNDS`` (20) rounds, the
median of those rounds' seconds (all seeds together) is printed; where it
exceeds ``GUARD_S`` (10% above the 9.4 s of a round with the card to
itself), the host lacks the cores for both jobs: both are stopped,
Rainbow's stages run alone, and then the DQN's segment again, in the time
left.  ``--alone`` starts there: Rainbow's stages first, then the DQN's
segment.  Each further Rainbow stage starts only where the time left
before the limit exceeds 1.1 times the last stage's wall, one still
running a minute past the limit is stopped, and the DQN's segment starts
only where at least ``MIN_SEGMENT_S`` are left.  It raises without a card,
and exits non-zero where a job failed.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "train_curve_torch.py")
RECORDS = os.path.join(REPO, "run_data_torch_train.jsonl")
ROUND = re.compile(r"^  round (\d+): ([0-9.]+) s$")
DQN_SEEDS, RAINBOW_SEEDS = (0, 1, 2, 3), (4, 5, 6, 7)
DQN_HANDOFFS = os.path.join(REPO, "runs_torch", "curve_dqn")
RAINBOW_SNAPSHOTS = os.path.join(REPO, "runs_torch", "curve_rainbow")
GUARD_ROUNDS, GUARD_S = 20, 10.34
POLL_S = 10.0
GRACE_S = 60.0        # a Rainbow stage may run this long past the limit
# the shortest DQN segment to start: one evaluation period (~18 rounds of
# 9-13 s and a 25-36 s evaluation), its start and its save
MIN_SEGMENT_S = 360.0


def round_seconds(log: str) -> List[float]:
    """The seconds of each round a custom-DQN seed's log reports."""
    if not os.path.exists(log):
        return []
    with open(log) as fh:
        return [float(m.group(2)) for m in map(ROUND.match, fh) if m]


def guard_median(logs: List[str], rounds: int) -> Optional[float]:
    """The median of the first ``rounds`` rounds of every log, together;
    None until each log has that many."""
    seen = [round_seconds(log)[:rounds] for log in logs]
    if any(len(s) < rounds for s in seen):
        return None
    return statistics.median(x for s in seen for x in s)


class Job:
    """One ``train_curve_torch.py --run`` in a session of its own, so that
    stopping it stops the seeds it spawned."""

    def __init__(self, name: str, args: List[str], log: str):
        self.name, self.t0 = name, time.time()
        self.fh = open(log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, SCRIPT, "--run"] + args, stdout=self.fh,
            stderr=subprocess.STDOUT, cwd=REPO, start_new_session=True)
        print(f"{name}: started", flush=True)

    def done(self) -> bool:
        return self.proc.poll() is not None

    def wait(self) -> int:
        rc = self.proc.wait()
        self.fh.close()
        print(f"{self.name}: exit {rc} after {time.time() - self.t0:.1f} s",
              flush=True)
        return rc

    def stop(self) -> None:
        if not self.done():
            os.killpg(self.proc.pid, signal.SIGTERM)
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)
        print(f"{self.name}: stopped", flush=True)
        self.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--stages", type=int, nargs="*", default=[1, 2],
                    help="Rainbow's stages to run (none: the DQN alone)")
    ap.add_argument("--time-limit", type=float, default=3300.0)
    ap.add_argument("--alone", action="store_true",
                    help="run Rainbow's stages first, then the DQN's "
                    "segment in the time left (what the guard does when "
                    "it trips)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("the jobs train on the card: "
                           "torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from paper_table_torch import card_line
    print(card_line(), flush=True)
    start = time.time()
    deadline = start + args.time_limit
    folder = os.path.abspath(args.dir)
    os.makedirs(folder, exist_ok=True)
    out = os.path.join(folder, "run_data_torch_train.jsonl")
    if not os.path.exists(out) and os.path.exists(RECORDS):
        shutil.copy(RECORDS, out)
    snaps = os.path.join(folder, "curve_rainbow")
    os.makedirs(snaps, exist_ok=True)
    dqn_logs = [os.path.join(folder, f"train_curve_dqn_seed{s}.log")
                for s in DQN_SEEDS]

    def dqn_job() -> Optional[Job]:
        left = deadline - time.time()
        if left < MIN_SEGMENT_S:
            return None
        return Job("dqn", [
            "--trainer", "dqn", "--seeds", *map(str, DQN_SEEDS),
            "--resume-from", DQN_HANDOFFS,
            "--handoffs", os.path.join(folder, "curve_dqn"),
            "--time-limit", f"{left:.0f}", "--out", out],
            os.path.join(folder, "dqn.log"))

    def rainbow_job(stage: int) -> Job:
        if stage == 2:
            for seed in RAINBOW_SEEDS:
                name = f"seed{seed}_stage1.npz"
                if not os.path.exists(os.path.join(snaps, name)):
                    shutil.copy(os.path.join(RAINBOW_SNAPSHOTS, name), snaps)
        return Job(f"rainbow stage {stage}", [
            "--trainer", "rainbow", "--seeds",
            *map(str, RAINBOW_SEEDS), "--stage", str(stage),
            "--snapshots", snaps, "--out", out],
            os.path.join(folder, f"rainbow_stage{stage}.log"))

    rcs: Dict[str, int] = {}
    stages = list(args.stages)
    rainbow = rainbow_job(stages.pop(0)) if stages else None
    # beside: the DQN starts at once, under the guard; alone: after Rainbow
    dqn = None if args.alone and rainbow is not None else dqn_job()
    dqn_after = dqn is None
    guarded = dqn is None or rainbow is None
    while dqn is not None and not dqn.done() or rainbow is not None:
        time.sleep(POLL_S)
        if not guarded:
            median = guard_median(dqn_logs, GUARD_ROUNDS)
            if median is None and not dqn.done():
                continue
            guarded = True
            print(f"guard: median of the first {GUARD_ROUNDS} DQN rounds of "
                  f"each seed {median} s (limit {GUARD_S} s)", flush=True)
            if median is not None and median > GUARD_S:
                dqn.stop()
                rainbow.stop()
                for log in dqn_logs:
                    if os.path.exists(log):
                        os.replace(log, log[:-4] + "_beside.log")
                print("guard: Rainbow's stages run alone, then the DQN's "
                      "segment in the time left", flush=True)
                stages.insert(0, int(rainbow.name.split()[-1]))
                rainbow, dqn, dqn_after = rainbow_job(stages.pop(0)), None, \
                    True
                continue
        if rainbow is not None and rainbow.done():
            rc = rcs[rainbow.name] = rainbow.wait()
            wall = time.time() - rainbow.t0
            rainbow = None
            left = deadline - time.time()
            if stages and not rc and left > 1.1 * wall:
                rainbow = rainbow_job(stages.pop(0))
            elif stages:
                why = "the stage before failed" if rc else (
                    f"the time left ({left:.0f} s) is under 1.1 times the "
                    f"last stage's {wall:.0f} s")
                print(f"rainbow stages {stages}: not started, {why}",
                      flush=True)
                stages = []
        elif rainbow is not None and time.time() > deadline + GRACE_S:
            rainbow.stop()
            rcs[rainbow.name] = -1
            rainbow = None
        if rainbow is None and dqn_after:
            dqn, dqn_after = dqn_job(), False
    if dqn is not None:
        rcs["dqn"] = dqn.wait()
    print(f"jobs: {rcs}; {time.time() - start:.1f} s", flush=True)
    return 1 if any(rcs.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
