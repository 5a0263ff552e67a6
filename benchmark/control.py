"""Read the correctness check's numbers of sound runs and of the control.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

Each seed is one window of the cell at its own load (short: long enough to
reach the check's sampled ticks), then the check twice on the same
samples: the program against the reference in float32 (a sound reading),
and the reference in TF32 in the program's place against it (the control,
the step that would tempt a later change: the QP's and the actor's
products in TF32); in the arbiter also the reference with gate a or gate c
dropped in the program's place (a planted gate fault).  One JSON line a
seed; the limits in
``workloads/<cell>.json`` are set from these readings (PERF.md).  The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))
sys.path.insert(0, _HERE)

from harness.main import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        run = argparse.Namespace(workload=args.workload, seed=seed,
                                 seconds=args.seconds, trace=0)
        t0 = time.perf_counter()
        out = run_cell(run, t0, control=True)
        result, numbers = out.result, out.numbers
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "correct": result["correct"],
                          "metrics": result["metrics"],
                          "ticks": len(out.window.entries), "sound": {
                              k: v for k, v in numbers.items()
                              if k != "control" and not k.startswith("no_")},
                          "control": numbers["control"],
                          "faults": {k: v for k, v in numbers.items()
                                     if k.startswith("no_")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
